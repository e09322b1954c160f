"""The numbers that decide ``correct``, each against its limit
(``limits/<cell>.json``).

Sampling: per sample, the relative l2 error ||program - reference|| /
||reference|| of the conditioning, of the sampled latent and of the
decoded image; the number compared is the worst sample's.

Training: the gap between the program's and the reference's norm of a
leaf, over the larger of the reference leaf's norm and the median
leaf's, worst leaf; and the worst step's relative loss gap."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch


def rel_rows(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-row (dim 0) relative l2 error, in float64; inf where the
    program's row is not finite."""
    p = prog.detach().double().reshape(prog.shape[0], -1)
    r = ref.detach().double().reshape(ref.shape[0], -1).to(p.device)
    err = (p - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)
    return torch.where(torch.isfinite(p).all(dim=1), err,
                       torch.full_like(err, math.inf))


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """|prog - ref| / max(ref, median ref) of each leaf in ``keep`` (all
    by default); inf where the program's norm is missing or not
    finite."""
    names = list(ref) if keep is None else list(keep)
    med = float(torch.tensor([ref[n] for n in names]).median()) \
        if names else 0.0
    out = {}
    for n in names:
        p = prog.get(n, math.nan)
        den = max(ref[n], med, 1e-30)
        out[n] = abs(p - ref[n]) / den if math.isfinite(p) else math.inf
    return out


def check(name: str, value: float, limits: Dict[str, float]
          ) -> Dict[str, object]:
    limit = float(limits[name])
    ok = math.isfinite(value) and value <= limit
    return {"name": name, "value": float(value), "limit": limit, "ok": ok}


def verdict(checks: List[Dict[str, object]]) -> bool:
    return bool(checks) and all(c["ok"] for c in checks)
