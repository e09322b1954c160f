"""Default-device resolution for the port's entry points.

Every entry point takes a ``device``. ``None`` means the card: ``cuda``
when PyTorch sees one, and an error otherwise. Nothing falls back to the
CPU quietly; a caller that wants the CPU (the tests) says ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given.

    Explicit devices pass through unchanged, including ``"meta"`` for
    shape-only construction.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "frido_tpu_torch runs on the GPU by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
