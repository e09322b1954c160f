"""The CUDA kernels' wrappers (one module each) and their routing."""

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count, and the JPEG decodes."""
    from frido_tpu_torch.ops.cuda.attention import (flash_attention,
                                                    smalls_attention)
    from frido_tpu_torch.ops.cuda.conv import conv3x3, conv3x3_norm_silu
    from frido_tpu_torch.ops.cuda.jpeg import decode_jpeg
    from frido_tpu_torch.ops.cuda.norm import group_norm
    from frido_tpu_torch.ops.cuda.vq import vq_argmin

    return {f.__name__: f.launches for f in (
        flash_attention, vq_argmin, group_norm, smalls_attention, conv3x3,
        conv3x3_norm_silu, decode_jpeg)}
