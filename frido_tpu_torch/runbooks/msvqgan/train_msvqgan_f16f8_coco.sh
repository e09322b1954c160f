#!/usr/bin/env bash
# MS-VQGAN training on one card (DEVICE names another device,
# DEVICE=cpu the CPU). Extra arguments go to the training CLI. From the
# repository root.
set -e
python3 -m frido_tpu_torch.cli.train_msvqgan --base configs/msvqgan/msvqgan_f16f8_coco.yaml \
    -t True -l ./exp_my/msvqgan -n f16f8_coco \
    ${DEVICE:+--device "$DEVICE"} "$@"
