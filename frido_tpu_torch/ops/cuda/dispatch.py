"""Which sites take which hand-written kernel (port of
``frido_tpu/ops/pallas/dispatch.py`` and the switch reads of
``frido_tpu/ops/norm.py:53``, ``nn/layers.py:33-62`` and
``nn/transformer.py:48-64,84-90``).

The switches are the JAX package's own names and values, read on every
call (the JAX package reads them at trace time):

- ``FRIDO_PALLAS``: ``0`` turns every kernel off, so every site takes the
  plain PyTorch form; any other value (``auto``, ``interpret``, ...)
  leaves the kernels on. On CPU tensors each wrapper computes its plain
  version anyway.
- ``FRIDO_FLASH``: ``0`` takes the flash sites off the flash kernel.
- ``FRIDO_GN_PALLAS``: ``1`` sends every ``GroupNorm`` that is not folded
  into a fused conv to the group-norm kernel.
- ``FRIDO_SMALLS_ATTN``: ``1`` sends every attention with
  ``max(nq, nk) <= 512`` that flash does not take to the short-sequence
  kernel.
- ``FRIDO_CONV_MODE``: ``conv`` (default) keeps every conv on
  ``F.conv2d``; ``pallas`` sends every 3x3 / stride-1 / pad-1 conv to the
  conv kernel; ``pallas_fused`` does that and also folds every UNet
  ResBlock prologue (GroupNorm -> SPADE modulation -> SiLU) into the
  prologue variant of the same kernel.

The JAX package's other values (``FRIDO_CONV_MODE`` of ``auto``, a v5e
table, ``im2col``, ``shift9``, ``pad128``, ``pad256``, and
``FRIDO_CONV_SMALLS``) are not ported (ROADMAP.md section 2, redesign
queue) and raise ``NotImplementedError`` rather than being ignored.

Site sets. Eligibility is the CUDA kernel's own: the JAX gates
``fits_pallas_conv``, ``fits_fused_conv``, ``fits_pallas_gn``,
``smalls_vmem_ok``, the ``hw >= 256`` GroupNorm floor and the smalls
score floors are TPU VMEM facts or v5e measurements and do not carry over.
So under the switches the port routes more sites than the JAX package:
every GroupNorm (the JAX package keeps those under 256 pixels or over its
VMEM budget, such as the 8x8 / 4x4 SpatialTransformer norms and the 256^2
decoder norms, on XLA), every attention up to 512 tokens (the JAX package
keeps short or small-batch ones, such as BERT's 77 tokens, on XLA), and
every 3x3 / stride-1 / pad-1 conv (the JAX package keeps the decoder's
256^2 convs on XLA). The math is the same either way. The flash gate is
the port's (kv >= 512, any batch) as before.
"""

from __future__ import annotations

import os

SMALLS_MAX_SEQ = 512
FLASH_MIN_KV = 512

_CONV_MODES = ("conv", "pallas", "pallas_fused")
_UNPORTED_CONV_MODES = ("auto", "im2col", "shift9", "pad128", "pad256")


def kernels_on() -> bool:
    """False when ``FRIDO_PALLAS=0`` turns every kernel off."""
    return os.environ.get("FRIDO_PALLAS", "auto") != "0"


def conv_mode() -> str:
    """``FRIDO_CONV_MODE``, one of ``conv``, ``pallas``, ``pallas_fused``."""
    if os.environ.get("FRIDO_CONV_SMALLS", ""):
        raise NotImplementedError(
            "FRIDO_CONV_SMALLS is not ported (ROADMAP.md section 2)")
    mode = os.environ.get("FRIDO_CONV_MODE", "conv")
    if mode in _UNPORTED_CONV_MODES:
        raise NotImplementedError(
            f"FRIDO_CONV_MODE={mode} is not ported (ROADMAP.md section 2); "
            f"the port takes {', '.join(_CONV_MODES)}")
    if mode not in _CONV_MODES:
        raise ValueError(f"FRIDO_CONV_MODE={mode!r} is not a conv mode; "
                         f"the port takes {', '.join(_CONV_MODES)}")
    return mode


def use_conv_kernel() -> bool:
    """3x3 / stride-1 / pad-1 convs take the conv kernel."""
    return conv_mode() != "conv" and kernels_on()


def use_fused_prologue() -> bool:
    """ResBlock prologues fold into the conv kernel."""
    return conv_mode() == "pallas_fused" and kernels_on()


def use_group_norm_kernel() -> bool:
    return os.environ.get("FRIDO_GN_PALLAS", "0") == "1" and kernels_on()


def use_flash(nk: int) -> bool:
    return (nk >= FLASH_MIN_KV and kernels_on()
            and os.environ.get("FRIDO_FLASH", "1") != "0")


def use_smalls(nq: int, nk: int) -> bool:
    return (max(nq, nk) <= SMALLS_MAX_SEQ and kernels_on()
            and os.environ.get("FRIDO_SMALLS_ATTN", "0") == "1")
