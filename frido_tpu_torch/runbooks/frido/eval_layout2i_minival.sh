#!/usr/bin/env bash
# layout2i mini-val smoke eval: 320 fixed images, 100 DDIM steps,
# no guidance (expected FID ~121.23, BASELINE.md); then FID, which needs
# FRIDO_TPU_INCEPTION. From the repository root; DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion \
    -cfg configs/frido/layout2i/frido_f8f4_coco_seg_mini.yaml \
    -r "${CKPT:-exp/layout2i/frido_f8f4_coco_seg/model.ckpt}" \
    -c 100 -name mini -o exp/layout2i/samples \
    ${DEVICE:+--device "$DEVICE"}
python3 -m frido_tpu_torch.cli.eval_fid \
    --real exp/layout2i/samples/mini/inputs \
    --fake exp/layout2i/samples/mini/sample \
    ${DEVICE:+--device "$DEVICE"}
