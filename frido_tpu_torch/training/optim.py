"""AdamW with the JAX package's semantics, and the LR schedules (port of
``frido_tpu/training/optim.py``).

``AdamW`` computes what ``optax.adamw`` computes (``scale_by_adam``, then
the decoupled weight decay, then the learning rate), in that order:

    mu = (1 - b1) g + b1 mu            nu = (1 - b2) g^2 + b2 nu
    n += 1
    u  = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd p
    p -= lr(n - 1) u

with ``eps`` outside the square root, and the learning rate schedule taken
at the update count before the increment (0 at the first update).
``mu_dtype=torch.bfloat16`` keeps the first moment in bf16 between updates
(``main.py --adam_mu_bf16``): the decayed old moment is rounded in bf16,
the new one is formed in fp32, used in fp32 and stored in bf16, as optax
does. ``accumulate_grad_batches = k > 1`` is ``optax.MultiSteps``: the
gradients of k calls are averaged (a running mean), the update comes on
every k-th call, and the schedule counts updates, not calls.

The schedulers and ``scaled_learning_rate`` are the port's own copies of
the JAX package's (``taming/lr_scheduler.py``, ``main.py:793-810``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch


class LambdaWarmUpCosineScheduler:
    """Linear warmup then cosine decay multiplier; use with base_lr 1.0."""

    def __init__(self, warm_up_steps, lr_min, lr_max, lr_start,
                 max_decay_steps, verbosity_interval=0):
        self.warm_up_steps = warm_up_steps
        self.lr_start = lr_start
        self.lr_min = lr_min
        self.lr_max = lr_max
        self.max_decay_steps = max_decay_steps

    def __call__(self, n):
        if n < self.warm_up_steps:
            return ((self.lr_max - self.lr_start) / self.warm_up_steps * n
                    + self.lr_start)
        t = (n - self.warm_up_steps) / (self.max_decay_steps
                                        - self.warm_up_steps)
        t = min(t, 1.0)
        return self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (
            1 + np.cos(t * np.pi))


class LambdaLinearScheduler:
    """Linear warmup then a constant (or, with ``cycle_lengths``, linearly
    decaying) multiplier, the LDM config family's."""

    def __init__(self, warm_up_steps, f_min, f_max, f_start,
                 cycle_lengths=None, verbosity_interval=0):
        def first(x):
            return x[0] if isinstance(x, (list, tuple)) else x

        self.warm_up_steps = first(warm_up_steps)
        self.f_min = first(f_min)
        self.f_max = first(f_max)
        self.f_start = first(f_start)
        self.cycle_length = first(cycle_lengths) if cycle_lengths else None

    def __call__(self, n):
        if n < self.warm_up_steps:
            return ((self.f_max - self.f_start) / self.warm_up_steps * n
                    + self.f_start)
        if self.cycle_length is not None:
            t = min((n - self.warm_up_steps) /
                    max(self.cycle_length - self.warm_up_steps, 1), 1.0)
            return self.f_min + (self.f_max - self.f_min) * (1 - t)
        return self.f_max


def scaled_learning_rate(base_lr: float, batch_size: int, n_devices: int,
                         accumulate_grad_batches: int = 1,
                         scale_lr: bool = True) -> float:
    """``accumulate_grad_batches * n_devices * batch_size * base_lr``."""
    if not scale_lr:
        return base_lr
    return accumulate_grad_batches * n_devices * batch_size * base_lr


LearningRate = Union[float, Callable[[int], float]]


class AdamW(torch.optim.Optimizer):
    """``optax.adamw`` (wrapped in ``optax.MultiSteps`` when
    ``accumulate_grad_batches > 1``) as a ``torch.optim.Optimizer``.

    ``lr`` is a number or a function of the update count. Every parameter
    it holds takes each update, as every leaf of an optax state does: one
    without a gradient at a call takes a zero gradient (and so the weight
    decay). Frozen parameters are left out of it, as the JAX package's
    masked optimizer leaves them out. ``count`` is the number of updates
    taken, ``mini_step`` the calls accumulated toward the next one.
    Per parameter the state holds ``mu``, ``nu`` and, with accumulation,
    the running mean ``acc``.
    """

    def __init__(self, params: Iterable, lr: LearningRate,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01,
                 mu_dtype: Optional[torch.dtype] = None,
                 accumulate_grad_batches: int = 1):
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be >= 1")
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype
        self.every_k = accumulate_grad_batches
        self.count = 0
        self.mini_step = 0

    def learning_rate(self, count: int) -> float:
        lr = self.defaults["lr"]
        return float(lr(count)) if callable(lr) else float(lr)

    def _state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
            st["nu"] = torch.zeros_like(p)
            if self.every_k > 1:
                st["acc"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        """One call: accumulate, and on an update call update every
        parameter that has a gradient. Returns True on an update call."""
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        states = [self._state(p) for p in params]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if self.every_k > 1:
            accs = [st["acc"] for st in states]
            # Welford: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, accs)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(accs, delta)
            if self.mini_step < self.every_k - 1:
                self.mini_step += 1
                return False
            self.mini_step = 0
            grads = [a.clone() for a in accs]
            for a in accs:
                a.zero_()
        self._adam(params, states, grads)
        return True

    def _adam(self, params, states, grads) -> None:
        hp = self.defaults
        b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
        n = self.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(n))
        bc2 = float(f32(1) - f32(b2) ** f32(n))
        mus = [st["mu"] for st in states]
        nus = [st["nu"] for st in states]
        # the old moments decay in their own dtype, the new ones form in
        # fp32; at most two temporaries of the parameters' size are live
        torch._foreach_mul_(mus, b1)
        mu = [m.float() for m in mus] if self.mu_dtype is not None else mus
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, sq)
        del sq
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, torch._foreach_mul(params, wd))
        torch._foreach_mul_(upd, -self.learning_rate(self.count))
        torch._foreach_add_(params, upd)
        if self.mu_dtype is not None:
            for m, m32 in zip(mus, mu):
                m.copy_(m32)
        self.count = n


def build_optimizer(params: Iterable, learning_rate: float,
                    scheduler: Optional[Any] = None,
                    weight_decay: float = 0.01, b1: float = 0.9,
                    b2: float = 0.999, accumulate_grad_batches: int = 1,
                    mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """AdamW (torch's default decay of 0.01) over ``params``, with an
    optional LR lambda scheduler and gradient accumulation."""
    lr: LearningRate = learning_rate
    if scheduler is not None:
        def lr(count, base=learning_rate, fn=scheduler):
            return base * fn(count)
    return AdamW(params, lr, b1=b1, b2=b2, weight_decay=weight_decay,
                 mu_dtype=mu_dtype,
                 accumulate_grad_batches=accumulate_grad_batches)


def build_from_config(params: Iterable, base_lr: float,
                      scheduler_config: Optional[Dict] = None,
                      **kw) -> AdamW:
    scheduler = None
    if scheduler_config is not None:
        from frido_tpu_torch.config import instantiate_from_config

        scheduler = instantiate_from_config(scheduler_config)
    return build_optimizer(params, base_lr, scheduler, **kw)
