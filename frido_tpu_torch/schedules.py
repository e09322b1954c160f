"""Diffusion schedule math (pure numpy; converted to torch at the edge).

The port's own copy of ``frido_tpu/schedules.py`` (the port imports nothing
of the JAX package): the schedule utilities of the original Frido code
(``frido/modules/diffusionmodules/util.py:21-99``) and the DDPM buffer
registration (``frido/models/diffusion/frido.py:127-179``). All buffers are
computed in float64 numpy and stored as float32, matching the original's
``to_torch = partial(torch.tensor, dtype=float32)``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, a_min=0, a_max=0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def make_ddim_timesteps(
    ddim_discr_method: str, num_ddim_timesteps: int, num_ddpm_timesteps: int
) -> np.ndarray:
    """Strided timestep subset; the +1 shift matches the reference
    (``util.py:46-60``)."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(f"unknown ddim discretization: {ddim_discr_method}")
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step (sigma, alpha, alpha_prev) from the DDIM paper eq. 16
    (``util.py:63-74``)."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All DDPM schedule buffers (float32 numpy arrays of shape [T]).

    Field set and formulas mirror ``frido.py:127-179`` exactly; these are
    baked into the jitted programs as constants.
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    num_timesteps: int
    linear_start: float
    linear_end: float

    @classmethod
    def create(
        cls,
        given_betas: np.ndarray | None = None,
        beta_schedule: str = "linear",
        timesteps: int = 1000,
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        v_posterior: float = 0.0,
        parameterization: str = "eps",
    ) -> "DiffusionSchedule":
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(
                beta_schedule, timesteps, linear_start=linear_start,
                linear_end=linear_end, cosine_s=cosine_s,
            )
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        (num_timesteps,) = betas.shape

        posterior_variance = (1 - v_posterior) * betas * (
            1.0 - alphas_cumprod_prev
        ) / (1.0 - alphas_cumprod) + v_posterior * betas

        f32 = lambda x: np.asarray(x, dtype=np.float32)

        if parameterization == "eps":
            # posterior_variance[0] == 0 -> inf at t=0; overwritten below
            # (lvlb_weights[0] = lvlb_weights[1]) exactly like the reference.
            with np.errstate(divide="ignore"):
                lvlb_weights = f32(betas) ** 2 / (
                    2
                    * f32(posterior_variance)
                    * f32(alphas)
                    * (1 - f32(alphas_cumprod))
                )
        elif parameterization == "x0":
            lvlb_weights = 0.5 * np.sqrt(f32(alphas_cumprod)) / (
                2.0 * 1 - f32(alphas_cumprod)
            )
        else:
            raise NotImplementedError("mu not supported")
        lvlb_weights = np.array(lvlb_weights)
        lvlb_weights[0] = lvlb_weights[1]
        assert not np.isnan(lvlb_weights).all()

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(posterior_variance, 1e-20))
            ),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
            lvlb_weights=f32(lvlb_weights),
            num_timesteps=int(num_timesteps),
            linear_start=linear_start,
            linear_end=linear_end,
        )


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step buffers for the strided sampler (``ddim.py:25-54``)."""

    timesteps: np.ndarray          # [S] int, ascending DDPM t indices
    alphas: np.ndarray             # [S]
    alphas_prev: np.ndarray        # [S]
    sqrt_one_minus_alphas: np.ndarray  # [S]
    sigmas: np.ndarray             # [S]

    @classmethod
    def create(
        cls,
        schedule: DiffusionSchedule,
        num_steps: int,
        eta: float = 0.0,
        discretize: str = "uniform",
    ) -> "DDIMSchedule":
        ddim_timesteps = make_ddim_timesteps(
            discretize, num_steps, schedule.num_timesteps
        )
        alphacums = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
            alphacums, ddim_timesteps, eta
        )
        f32 = lambda x: np.asarray(x, dtype=np.float32)
        return cls(
            timesteps=np.asarray(ddim_timesteps, dtype=np.int32),
            alphas=f32(alphas),
            alphas_prev=f32(alphas_prev),
            sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
            sigmas=f32(sigmas),
        )

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])
