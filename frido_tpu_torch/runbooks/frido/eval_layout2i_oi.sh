#!/usr/bin/env bash
# layout2i on OpenImages (FID 29.04 @ 2048 val imgs, BASELINE.md),
# DDIM 200, no guidance; then FID, which needs FRIDO_TPU_INCEPTION. From
# the repository root; DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion \
    -cfg configs/frido/layout2i/frido_f8f4_openimage.yaml \
    -r "${CKPT:-exp/layout2i/frido_f8f4_openimage/model.ckpt}" \
    -c 200 -name full -o exp/layout2i_oi/samples \
    ${DEVICE:+--device "$DEVICE"}
python3 -m frido_tpu_torch.cli.eval_fid \
    --real exp/layout2i_oi/samples/full/inputs \
    --fake exp/layout2i_oi/samples/full/sample \
    ${DEVICE:+--device "$DEVICE"}
