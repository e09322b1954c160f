#!/usr/bin/env bash
# layout2i on Visual Genome (FID 17.24 @ DDIM 250 steps, BASELINE.md),
# no guidance; then FID, which needs FRIDO_TPU_INCEPTION. From the
# repository root; DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion \
    -cfg configs/frido/layout2i/frido_f8f4_vg.yaml \
    -r "${CKPT:-exp/layout2i/frido_f8f4_vg/model.ckpt}" \
    -c 250 -name full -o exp/layout2i_vg/samples \
    ${DEVICE:+--device "$DEVICE"}
python3 -m frido_tpu_torch.cli.eval_fid \
    --real exp/layout2i_vg/samples/full/inputs \
    --fake exp/layout2i_vg/samples/full/sample \
    ${DEVICE:+--device "$DEVICE"}
