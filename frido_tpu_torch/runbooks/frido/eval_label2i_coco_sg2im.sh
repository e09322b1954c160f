#!/usr/bin/env bash
# label2i on COCO-stuff with sg2im-style 3-8 instance filtering
# (FID 47.39 row in BASELINE.md), DDIM 200, no guidance; then FID, which
# needs FRIDO_TPU_INCEPTION. From the repository root; DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion \
    -cfg configs/frido/label2i/frido_f16f8_coco_sg2im.yaml \
    -r "${CKPT:-exp/label2i/frido_f16f8_coco_sg2im/model.ckpt}" \
    -c 200 -name full -o exp/label2i_sg2im/samples \
    ${DEVICE:+--device "$DEVICE"}
python3 -m frido_tpu_torch.cli.eval_fid \
    --real exp/label2i_sg2im/samples/full/inputs \
    --fake exp/label2i_sg2im/samples/full/sample \
    ${DEVICE:+--device "$DEVICE"}
