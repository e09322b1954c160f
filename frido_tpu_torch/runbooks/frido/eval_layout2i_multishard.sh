#!/usr/bin/env bash
# Sharded layout2i inference in N processes (default 2), each sampling a
# deterministic 1/N of the test set. The sampling CLI uses one card a
# process: shard i runs on visible card i mod the card count (unpinned
# when DEVICE is set). Every shard is waited on; the runbook exits
# non-zero if any of them failed. From the repository root.
set -e
. "$(dirname "$0")/../lib.sh"
N=${1:-2}
read -r -a CARDS <<< "$(shard_cards)"
pids=()
for i in $(seq 0 $((N - 1))); do
  on_card "$i" python3 -m frido_tpu_torch.cli.sample_diffusion \
      -cfg configs/frido/layout2i/frido_f8f4_coco_seg.yaml \
      -r "${CKPT:-exp/layout2i/frido_f8f4_coco_seg/model.ckpt}" \
      -c 200 -ngpu "$N" -igpu "$i" -name full -o exp/layout2i/samples \
      ${DEVICE:+--device "$DEVICE"} &
  pids+=($!)
done
wait_shards "${pids[@]}"
