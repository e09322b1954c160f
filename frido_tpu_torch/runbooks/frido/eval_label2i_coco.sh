#!/usr/bin/env bash
# label2i on COCO: PLMS 200, CFG 1.5 (tools/frido/eval_label2i_coco.sh on
# the port's sampling CLI). From the repository root; DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion -cfg configs/frido/label2i/frido_f16f8_coco.yaml \
    -r "${CKPT:-exp/label2i/model.ckpt}" -plms -G -gs 1.5 -c 200 -name full -o exp/label2i/samples \
    ${DEVICE:+--device "$DEVICE"}
