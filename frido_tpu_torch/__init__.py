"""frido_tpu_torch: the PyTorch/CUDA port of frido_tpu for NVIDIA Hopper.

The JAX package ``frido_tpu`` stays the reference; this package imports
``torch`` and never ``jax``, ``flax`` or anything of ``frido_tpu``. Module
layout follows the JAX package (``nn/``, ``ops/``, ``models/``,
``diffusion/``, ``io/``); the hand-written CUDA kernels live in ``csrc/``
and are bound in ``ops/cuda/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`frido_tpu_torch.device.resolve_device`).
"""
