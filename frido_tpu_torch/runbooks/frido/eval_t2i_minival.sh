#!/usr/bin/env bash
# Mini-val t2i smoke eval (1000 fixed images; expected FID ~64.85); then
# FID, which needs FRIDO_TPU_INCEPTION. From the repository root;
# DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion \
    -cfg configs/frido/t2i/frido_f16f8_coco_mini.yaml \
    -r "${CKPT:-exp/t2i/frido_f16f8_coco/model.ckpt}" \
    -plms -G -gs 1.5 -c 200 -name mini -o exp/t2i/samples \
    ${DEVICE:+--device "$DEVICE"}
python3 -m frido_tpu_torch.cli.eval_fid \
    --real exp/t2i/samples/mini/inputs --fake exp/t2i/samples/mini/sample \
    ${DEVICE:+--device "$DEVICE"}
