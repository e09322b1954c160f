#!/usr/bin/env bash
# MS-VQGAN training on one card (DEVICE names another device,
# DEVICE=cpu the CPU). Extra arguments go to the training CLI. From the
# repository root.
set -e
python3 -m frido_tpu_torch.cli.train_msvqgan --base configs/msvqgan/msvqgan_f8f4_openimage.yaml \
    -t True -l ./exp_my/msvqgan -n f8f4_openimage \
    ${DEVICE:+--device "$DEVICE"} "$@"
