#!/usr/bin/env bash
# Scene-graph-to-image on Visual Genome (FID 31.61 row in BASELINE.md);
# then FID, which needs FRIDO_TPU_INCEPTION. From the repository root;
# DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion \
    -cfg configs/frido/sg2i/frido_f16f8_vg.yaml \
    -r "${CKPT:-exp/sg2i/frido_f16f8_vg/model.ckpt}" \
    -G -gs 1.5 -c 200 -name full -o exp/sg2i_vg/samples \
    ${DEVICE:+--device "$DEVICE"}
python3 -m frido_tpu_torch.cli.eval_fid \
    --real exp/sg2i_vg/samples/full/inputs \
    --fake exp/sg2i_vg/samples/full/sample \
    ${DEVICE:+--device "$DEVICE"}
