"""Operations and bytes of each unit of work, counted on the reference
model on the ``meta`` device at a cell's shapes, so the count is the
work's and not any implementation's.

The method is ``frido_tpu_torch/tools/flops_audit.py``'s: products only,
2 FLOPs a multiply-add of the matmuls, convolutions and attentions that
``torch.utils.flop_counter.FlopCounterMode`` sees (elementwise work, norms
and softmax are not counted). Bytes are what a unit cannot avoid moving:
its weights read once as stored (fp32) plus its inputs read and its
outputs written once.

Peaks (NVIDIA H100 SXM data sheet, dense): bf16 989 TFLOP/s, TF32 495
TFLOP/s, HBM 3.35 TB/s."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from reference.layers import to_nchw

BF16_PEAK = 989e12
TF32_PEAK = 495e12
HBM_BYTES_S = 3.35e12


def count(fn: Callable[[], Any], grad: bool = False) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    if grad:
        with counter:
            fn()
    else:
        with counter, torch.no_grad():
            fn()
    return int(counter.get_total_flops())


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _param_bytes(module) -> int:
    return sum(p.numel() * 4 for p in module.parameters())


def least_seconds(flops: float, nbytes: float, peak: float) -> float:
    """The least time of a unit: the larger of its operations over the
    peak and its bytes over the memory bandwidth."""
    return max(flops / peak, nbytes / HBM_BYTES_S)


def sample_units(model, traffic: Dict[str, Any], dtype) -> Dict[str, float]:
    """FLOPs and bytes of one batch of a sampling mix on ``model`` (the
    reference on ``meta``): ``cond`` (both condition batches), ``unet``
    (every UNet evaluation and the SPADE tables of the batch),
    ``decode``, each with ``*_bytes``; ``calls`` the UNet calls."""
    b = traffic["batch"]
    spec = traffic["cond"]
    dev = torch.device("meta")
    length = spec.get("length") or (3 * spec["max_objects"] + 2)
    tokens = torch.zeros((b, length), dtype=torch.long, device=dev)
    out: Dict[str, float] = {"batch": b}
    out["cond"] = 2 * count(lambda: model.conditioning(tokens))
    ctx = model.conditioning(tokens)
    out["cond_bytes"] = 2 * (_param_bytes(model.cond_stage_model)
                             + _nbytes(tokens, ctx))
    hw, c = model.image_size, model.channels
    z = torch.zeros((2 * b, hw, hw, c), dtype=dtype, device=dev)
    t = torch.zeros((2 * b,), dtype=torch.long, device=dev)
    c2 = torch.zeros((2 * b,) + tuple(ctx.shape[1:]), dtype=dtype,
                     device=dev)
    per_stage = traffic["steps"] + (1 if traffic["sampler"] == "plms" else 0)
    unet_flops = unet_bytes = 0
    unet_w = _param_bytes(model.unet)
    for s in range(model.num_stage):
        aux = None
        if s > 0:
            xc = z[..., :model.window(s)[0]]
            unet_flops += count(
                lambda: model.unet.spade_tables(to_nchw(xc), s))
            aux = model.unet.spade_tables(to_nchw(xc), s)
        call = count(lambda: model.apply(z, t, c2, s, aux))
        e = model.apply(z, t, c2, s, aux)
        unet_flops += per_stage * call
        unet_bytes += per_stage * (unet_w + _nbytes(z, c2, e))
    out["unet"], out["unet_bytes"] = unet_flops, unet_bytes
    out["calls"] = per_stage * model.num_stage
    zf = torch.zeros((b, hw, hw, c), device=dev)
    out["decode"] = count(lambda: model.decode(zf))
    img = model.decode(zf)
    out["decode_bytes"] = _param_bytes(model.first_stage_model.decoder) \
        + _nbytes(zf, img)
    out["batch_flops"] = out["cond"] + out["unet"] + out["decode"]
    return out


def train_units(model, traffic: Dict[str, Any]) -> Dict[str, float]:
    """FLOPs of one training step of a mix on ``model`` (the reference on
    ``meta``): the encode, the conditioning and both stages' losses
    forward and backward."""
    b, size = traffic["batch"], traffic["image_size"]
    spec = traffic["cond"]
    dev = torch.device("meta")
    images = torch.zeros((b, size, size, 3), device=dev)
    tokens = torch.zeros((b, spec["length"]), dtype=torch.long, device=dev)
    hw, c = model.image_size, model.channels
    t = torch.zeros((b,), dtype=torch.long, device=dev)
    noise = torch.zeros((b, hw, hw, c), device=dev)
    model.first_stage_model.requires_grad_(False)

    def step():
        z = model.encode(images).float()
        ctx = model.conditioning(tokens)
        loss, _ = model.training_loss(z, ctx, t, noise)
        loss.backward()

    return {"step": count(step, grad=True), "batch": b}

