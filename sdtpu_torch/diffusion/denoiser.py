"""Denoisers (counterpart of ``sdtpu/diffusion/denoiser.py``): the CompVis
eps-prediction denoiser on the DDPM table (SD1.x, SD2.x-eps, SDXL), its
v-prediction form ``CompVisVDenoiser`` (SD2.x-v, e.g. SD2.1-768-v) and the
flow denoisers of SD3 (``DiscreteFlowDenoiser``) and FLUX.  The EDM and
SeFi / MiniT2I flow denoisers are not ported.

Tables and scalings are host-side numpy, as in the JAX package; the sampling
loop consumes them as f32 values.  ``get_scalings_torch`` and
``sigma_to_t_torch`` are the on-device forms (``*_jnp`` in the JAX package)
the pipeline's model function calls on a 0-dim float32 sigma.
"""
from __future__ import annotations

import numpy as np
import torch

TIMESTEPS = 1000


def compvis_alphas_cumprod(beta_start: float = 0.00085, beta_end: float = 0.012,
                           n: int = TIMESTEPS) -> np.ndarray:
    """DDPM alpha-bar table with the CompVis sqrt-linear beta schedule."""
    i = np.arange(n, dtype=np.float32)
    betas = (np.sqrt(np.float32(beta_start))
             + (np.sqrt(np.float32(beta_end)) - np.sqrt(np.float32(beta_start))) * (i / (n - 1))) ** 2
    return np.cumprod(1.0 - betas.astype(np.float64))


class CompVisDenoiser:
    """eps-prediction on the DDPM table (SD1.x)."""

    prediction = "eps"
    is_flow = False

    def __init__(self):
        ac = compvis_alphas_cumprod()
        self.sigmas = np.sqrt((1.0 - ac) / ac).astype(np.float32)
        self.log_sigmas = np.log(self.sigmas)
        self.sigma_data = 1.0
        self._log_sigmas_dev = {}

    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def t_to_sigma(self, t):
        t = np.asarray(t, dtype=np.float32)
        low_idx = np.floor(t).astype(np.int64)
        high_idx = np.ceil(t).astype(np.int64)
        w = t - low_idx
        log_sigma = (1.0 - w) * self.log_sigmas[low_idx] + w * self.log_sigmas[high_idx]
        return np.exp(log_sigma)

    def get_scalings_torch(self, sigma):
        """→ (c_skip, c_out, c_in) for a 0-dim float32 tensor sigma inside the
        sampling loop: denoised = c_skip·x + c_out·model(c_in·x)."""
        return 1.0, -sigma, 1.0 / torch.sqrt(sigma ** 2 + self.sigma_data ** 2)

    def sigma_to_t_torch(self, sigma):
        """The fractional DDPM timestep of a 0-dim float32 sigma on its
        device, interpolated in log sigma (``sigma_to_t_jnp``)."""
        log_sigmas = self._log_sigmas_dev.get(sigma.device)
        if log_sigmas is None:
            log_sigmas = torch.from_numpy(self.log_sigmas).to(sigma.device)
            self._log_sigmas_dev[sigma.device] = log_sigmas
        log_sigma = torch.log(sigma)
        low_idx = torch.clamp((log_sigma - log_sigmas >= 0).sum() - 1, 0, TIMESTEPS - 2)
        high_idx = low_idx + 1
        low, high = log_sigmas[low_idx], log_sigmas[high_idx]
        w = torch.clamp((low - log_sigma) / (low - high), 0.0, 1.0)
        return (1.0 - w) * low_idx.float() + w * high_idx.float()

    def noise_scaling(self, sigma, noise, latent):
        return latent + noise * sigma

    def inverse_noise_scaling(self, sigma, latent):
        return latent


class CompVisVDenoiser(CompVisDenoiser):
    """v-prediction on the DDPM table (SD2.x-v): c_skip = σ_d² / (σ² + σ_d²),
    c_out = −σ·σ_d / √(σ² + σ_d²), c_in = 1 / √(σ² + σ_d²)."""

    prediction = "v"

    def get_scalings_torch(self, sigma):
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = -sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
        return c_skip, c_out, c_in


def time_snr_shift(alpha: float, t):
    if alpha == 1.0:
        return t
    return alpha * t / (1 + (alpha - 1) * t)


def flux_time_shift(mu: float, sigma: float, t):
    return np.exp(mu) / (np.exp(mu) + (1.0 / t - 1.0) ** sigma)


class DiscreteFlowDenoiser:
    """Rectified flow, sigma in (0, 1], SNR time shift (SD3.x)."""

    prediction = "flow"
    is_flow = True

    def __init__(self, shift: float = 3.0):
        self.shift = shift

    def set_shift(self, shift: float):
        self.shift = shift

    def sigma_min(self) -> float:
        return float(self.t_to_sigma(np.float32(0.0)))

    def sigma_max(self) -> float:
        return float(self.t_to_sigma(np.float32(TIMESTEPS - 1)))

    def sigma_to_t(self, sigma):
        return np.asarray(sigma) * 1000.0

    def t_to_sigma(self, t):
        t = np.asarray(t, dtype=np.float32) + 1.0
        return time_snr_shift(self.shift, t / 1000.0)

    def get_scalings(self, sigma):
        """→ (c_skip, c_out, c_in): denoised = c_skip·x + c_out·model(c_in·x)."""
        sigma = np.asarray(sigma, dtype=np.float32)
        return np.ones_like(sigma), -sigma, np.ones_like(sigma)

    def get_scalings_torch(self, sigma):
        """The same for a 0-dim float32 tensor sigma inside the sampling loop."""
        return 1.0, -sigma, 1.0

    def sigma_to_t_torch(self, sigma):
        return sigma * 1000.0

    def noise_scaling(self, sigma, noise, latent):
        return latent * (1.0 - sigma) + noise * sigma

    def inverse_noise_scaling(self, sigma, latent):
        return latent / (1.0 - sigma)


class FluxFlowDenoiser(DiscreteFlowDenoiser):
    """FLUX flow: exp time shift, t == sigma."""

    def __init__(self, shift: float = 1.15):
        super().__init__(shift)

    def sigma_to_t(self, sigma):
        return np.asarray(sigma)

    def sigma_to_t_torch(self, sigma):
        return sigma

    def t_to_sigma(self, t):
        t = np.asarray(t, dtype=np.float32) + 1.0
        return flux_time_shift(self.shift, 1.0, t / TIMESTEPS)
