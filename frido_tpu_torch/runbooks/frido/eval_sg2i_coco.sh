#!/usr/bin/env bash
# Scene-graph-to-image on COCO: PLMS 200, CFG 1.5. From the repository
# root; DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion -cfg configs/frido/sg2i/frido_f16f8_coco.yaml \
    -r "${CKPT:-exp/sg2i/model.ckpt}" -plms -G -gs 1.5 -c 200 -name full -o exp/sg2i/samples \
    ${DEVICE:+--device "$DEVICE"}
