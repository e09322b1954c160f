#!/usr/bin/env bash
# Full COCO t2i eval: PLMS 200 steps, CFG 1.5, then FID over the
# sample/ vs inputs/ trees, which needs FRIDO_TPU_INCEPTION. From the
# repository root; DEVICE=cpu for the CPU.
set -e
python3 -m frido_tpu_torch.cli.sample_diffusion \
    -cfg configs/frido/t2i/frido_f16f8_coco.yaml \
    -r "${CKPT:-exp/t2i/frido_f16f8_coco/model.ckpt}" \
    -plms -G -gs 1.5 -c 200 -name full -o exp/t2i/samples \
    ${DEVICE:+--device "$DEVICE"}
python3 -m frido_tpu_torch.cli.eval_fid \
    --real exp/t2i/samples/full/inputs --fake exp/t2i/samples/full/sample \
    ${DEVICE:+--device "$DEVICE"}
