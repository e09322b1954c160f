#!/usr/bin/env bash
# t2i with the CLIP text encoder (FID 10.74 row in BASELINE.md).
# Needs a local snapshot of openai/clip-vit-large-patch14; set CLIP_PATH.
# Then FID, which needs FRIDO_TPU_INCEPTION. From the repository root;
# DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion \
    -cfg configs/frido/t2i/frido_f16f8_coco_clip.yaml \
    -r "${CKPT:-exp/t2i/frido_f16f8_coco_clip/model.ckpt}" \
    -G -gs 1.5 -c 200 -name full -o exp/t2i_clip/samples \
    ${DEVICE:+--device "$DEVICE"}
python3 -m frido_tpu_torch.cli.eval_fid \
    --real exp/t2i_clip/samples/full/inputs \
    --fake exp/t2i_clip/samples/full/sample \
    ${DEVICE:+--device "$DEVICE"}
