#!/usr/bin/env bash
# layout2i f8f4 on COCO-stuff: PLMS 200, CFG 1.5. From the repository
# root; DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion -cfg configs/frido/layout2i/frido_f8f4_coco_seg.yaml \
    -r "${CKPT:-exp/layout2i/model.ckpt}" -plms -G -gs 1.5 -c 200 -name full -o exp/layout2i/samples \
    ${DEVICE:+--device "$DEVICE"}
