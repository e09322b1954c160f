#!/usr/bin/env bash
# PLMS eval variant: 50 steps, eta 0 (PLMS requires it), CFG 1.5. From the
# repository root; DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion \
    -cfg configs/frido/t2i/frido_f16f8_coco.yaml \
    -r "${CKPT:-exp/t2i/frido_f16f8_coco/model.ckpt}" \
    -e 0 -G -gs 1.5 -c 50 -plms -name full -o exp/t2i/samples \
    ${DEVICE:+--device "$DEVICE"}
