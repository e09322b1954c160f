#!/usr/bin/env bash
# Diffusion training under torchrun, one rank a card (one rank on the
# device DEVICE names, DEVICE=cpu for the CPU). Extra arguments go to the
# training CLI; the config's max_epochs is not read, so --max_steps N
# stops a run. From the repository root.
set -e
. "$(dirname "$0")/../lib.sh"
NPROC=$(n_ranks)
torchrun --standalone --nproc_per_node="$NPROC" -m frido_tpu_torch.cli.main \
    --base configs/frido/layout2i/frido_f8f4_coco_seg.yaml \
    -t True -l ./exp_my/frido/layout2i -n layout2i_f8f4_coco --scale_lr False \
    ${DEVICE:+--device "$DEVICE"} "$@"
