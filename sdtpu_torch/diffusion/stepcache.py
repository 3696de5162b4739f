"""Step caches: skip whole diffusion forwards by reusing cached residuals
(counterpart of ``sdtpu/diffusion/stepcache.py``: ``EasyCache``,
``UCache``, ``TaylorSeer``, ``Spectrum``, ``DBCache`` / ``cache_dit``,
``parse_scm_mask``, ``generate_scm_mask``, ``make_step_cache``).

Each wraps model_fn(x, sigma, i) → (denoised, uncond denoised) for the
sampler loop.  The cached inputs, outputs and residuals stay on the
latents' device; the norms that decide a skip are reduced there in float32
and read on the host (``.item()``, one synchronize each), where the JAX
package reduces its numpy copies: the decision is host control flow in both.
``steps_skipped`` counts the forwards a cache answered itself.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def _mean_abs(t: torch.Tensor) -> float:
    return float(t.abs().mean())


@dataclasses.dataclass
class EasyCacheConfig:
    reuse_threshold: float = 0.2
    start_percent: float = 0.15
    end_percent: float = 0.95


class EasyCache:
    """Skips a forward while the accumulated predicted output change (the
    last output-to-input change rate times the input's change, over the
    output's norm) stays under ``reuse_threshold``; a skip re-applies the
    cached input → output difference."""

    def __init__(self, model_fn: Callable, config: EasyCacheConfig, denoiser, total_steps: int):
        self.model_fn = model_fn
        self.config = config
        self.start_sigma = self._percent_to_sigma(denoiser, config.start_percent)
        self.end_sigma = self._percent_to_sigma(denoiser, config.end_percent)
        self.reset()

    @staticmethod
    def _percent_to_sigma(denoiser, percent: float) -> float:
        if percent <= 0.0:
            return float("inf")
        if percent >= 1.0:
            return 0.0
        t = (1.0 - percent) * 999.0
        return float(denoiser.t_to_sigma(np.float32(t)))

    def reset(self):
        self.prev_input = None
        self.prev_output = None
        self.cache_diff = None
        self.output_prev_norm = None
        self.relative_rate = None
        self.cumulative_change = 0.0
        self.steps_skipped = 0

    def __call__(self, x, sigma, i):
        if not self.start_sigma >= float(sigma) > self.end_sigma:
            return self.model_fn(x, sigma, i)
        xin = x.float()
        last_input_change = None
        if self.prev_input is not None and self.cache_diff is not None:
            input_change = _mean_abs(xin - self.prev_input)
            last_input_change = input_change
            if self.output_prev_norm and self.relative_rate is not None and input_change > 0:
                self.cumulative_change += self.relative_rate * input_change / self.output_prev_norm
                if self.cumulative_change < self.config.reuse_threshold:
                    self.steps_skipped += 1
                    pred = xin + self.cache_diff
                    return pred, pred
                self.cumulative_change = 0.0

        pred, uncond = self.model_fn(x, sigma, i)
        out = pred.float()
        self.cache_diff = out - xin
        if self.prev_output is not None and last_input_change:
            output_change = _mean_abs(out - self.prev_output)
            if output_change > 0:
                rate = output_change / last_input_change
                if np.isfinite(rate):
                    self.relative_rate = rate
        self.prev_input = xin
        self.prev_output = out
        self.output_prev_norm = _mean_abs(out)
        self.cumulative_change = 0.0
        return pred, uncond


@dataclasses.dataclass
class UCacheConfig:
    threshold: float = 0.1
    start_percent: float = 0.1
    end_percent: float = 0.95


class UCache:
    """Residual cache with an accumulated error: skips while the summed
    relative input drift stays below ``threshold``."""

    def __init__(self, model_fn: Callable, config: UCacheConfig, denoiser, total_steps: int):
        self.model_fn = model_fn
        self.config = config
        self.start_sigma = EasyCache._percent_to_sigma(denoiser, config.start_percent)
        self.end_sigma = EasyCache._percent_to_sigma(denoiser, config.end_percent)
        self.reset()

    def reset(self):
        self.prev_input = None
        self.cache_diff = None
        self.acc_error = 0.0
        self.steps_skipped = 0

    def __call__(self, x, sigma, i):
        active = self.start_sigma >= float(sigma) > self.end_sigma
        xin = x.float()
        if active and self.prev_input is not None and self.cache_diff is not None:
            denom = _mean_abs(self.prev_input) or 1.0
            self.acc_error += _mean_abs(xin - self.prev_input) / denom
            if self.acc_error < self.config.threshold:
                self.steps_skipped += 1
                pred = xin + self.cache_diff
                return pred, pred
            self.acc_error = 0.0
        pred, uncond = self.model_fn(x, sigma, i)
        if active:
            self.cache_diff = pred.float() - xin
            self.prev_input = xin
        return pred, uncond


@dataclasses.dataclass
class TaylorSeerConfig:
    n_derivatives: int = 1
    max_warmup_steps: int = 2
    skip_interval_steps: int = 1


class TaylorSeer:
    """Taylor extrapolation of the model output across steps: every
    (interval + 1)-th step runs the forward and updates finite-difference
    derivatives; the steps between are predicted as Y + Σ_d dY[d]·elapsed^d/d!."""

    def __init__(self, model_fn: Callable, config: TaylorSeerConfig, denoiser=None,
                 total_steps: int = 0):
        self.model_fn = model_fn
        self.config = config
        self.reset()

    def reset(self):
        self.dY = [None] * (self.config.n_derivatives + 1)
        self.last_computed_step = -1
        self.steps_skipped = 0

    def _can_approximate(self) -> bool:
        return self.last_computed_step >= self.config.n_derivatives and self.dY[0] is not None

    def __call__(self, x, sigma, i):
        i = int(i)
        interval = max(self.config.skip_interval_steps, 1)
        if (i >= self.config.max_warmup_steps and i % (interval + 1) != 0
                and self._can_approximate()):
            elapsed = i - self.last_computed_step
            out = self.dY[0].clone()
            fact = 1.0
            for d in range(1, self.config.n_derivatives + 1):
                if self.dY[d] is None:
                    break
                fact *= d
                out += self.dY[d] * (float(elapsed) ** d) / fact
            self.steps_skipped += 1
            return out, out

        pred, uncond = self.model_fn(x, sigma, i)
        window = max(i - self.last_computed_step, 1)
        prev, new = self.dY, [None] * (self.config.n_derivatives + 1)
        new[0] = pred.float()
        for d in range(self.config.n_derivatives):
            if prev[d] is not None and new[d] is not None:
                new[d + 1] = (new[d] - prev[d]) / float(window)
        self.dY = new
        self.last_computed_step = i
        return pred, uncond


@dataclasses.dataclass
class SpectrumConfig:
    w: float = 0.40  # Chebyshev weight; (1-w) goes to the Taylor term
    m: int = 3  # Chebyshev fit degree
    lam: float = 1.0  # ridge regularizer
    window_size: int = 2
    flex_window: float = 0.50
    warmup_steps: int = 4
    stop_percent: float = 0.9


class Spectrum:
    """Chebyshev + Taylor output forecasting: a ridge-regularised degree-m
    Chebyshev fit over the last K real outputs (in normalised step time τ),
    blended with a first-order Taylor term; a flexing window lengthens the
    runs of skipped steps.  The fit's weights come from a float64 solve on
    the host; the Chebyshev sum and the blend run in float64 on the device,
    as numpy promotes them, and return float32."""

    def __init__(self, model_fn: Callable, config: SpectrumConfig, denoiser=None,
                 total_steps: int = 0):
        self.model_fn = model_fn
        self.config = config
        self.total_steps = total_steps
        self.reset()

    def reset(self):
        self.cnt = 0
        self.num_cached = 0
        self.curr_ws = float(self.config.window_size)
        self.K = max(self.config.m + 1, 6)
        self.stop_step = int(self.config.stop_percent * self.total_steps)
        self.steps_skipped = 0
        self.H: list = []
        self.T: list = []

    def _tau(self, step: int) -> float:
        return (step / 50.0) * 2.0 - 1.0

    def _should_predict(self) -> bool:
        if self.cnt < self.config.warmup_steps:
            return False
        if self.stop_step > 0 and self.cnt >= self.stop_step:
            return False
        if len(self.H) < 2:
            return False
        ws = max(1, int(np.floor(self.curr_ws)))
        return (self.num_cached + 1) % ws != 0

    def _predict(self) -> torch.Tensor:
        m1 = self.config.m + 1
        tau_at = self._tau(self.cnt)
        X = np.ones((len(self.H), m1), dtype=np.float64)
        if m1 > 1:
            X[:, 1] = self.T
        for j in range(2, m1):
            X[:, j] = 2.0 * np.asarray(self.T) * X[:, j - 1] - X[:, j - 2]
        x_star = np.ones(m1, dtype=np.float64)
        if m1 > 1:
            x_star[1] = tau_at
        for j in range(2, m1):
            x_star[j] = 2.0 * tau_at * x_star[j - 1] - x_star[j - 2]
        v = np.linalg.solve(X.T @ X + self.config.lam * np.eye(m1), x_star)
        weights = X @ v
        pred_cheb = sum(float(w) * h.double() for w, h in zip(weights, self.H))
        pred_taylor = self.H[-1] + 0.5 * (self.H[-1] - self.H[-2])
        out = ((1.0 - self.config.w) * pred_taylor).double() + self.config.w * pred_cheb
        self.num_cached += 1
        self.steps_skipped += 1
        self.cnt += 1
        return out.float()

    def __call__(self, x, sigma, i):
        if self._should_predict():
            out = self._predict()
            return out, out
        pred, uncond = self.model_fn(x, sigma, i)
        self.H.append(pred.float())
        self.T.append(self._tau(self.cnt))
        while len(self.H) > self.K:
            self.H.pop(0)
            self.T.pop(0)
        if self.cnt >= self.config.warmup_steps:
            self.curr_ws += self.config.flex_window
        self.num_cached = 0
        self.cnt += 1
        return pred, uncond


def parse_scm_mask(mask_str: str) -> list:
    """"1,1,0,0,1" → [1, 1, 0, 0, 1], the per-step computation mask; ':'
    separates too, so the mask survives inside a key=value option string."""
    if not mask_str:
        return []
    return [int(tok) for tok in str(mask_str).replace(":", ",").split(",") if tok.strip() != ""]


def generate_scm_mask(compute_bins, cache_bins, total_steps: int) -> list:
    """Interleave compute / cache run lengths into a step mask; the last
    step is always computed."""
    mask: list = []
    ci = ki = 0
    while len(mask) < total_steps:
        if ci < len(compute_bins):
            mask.extend([1] * min(compute_bins[ci], total_steps - len(mask)))
            ci += 1
        if ki < len(cache_bins) and len(mask) < total_steps:
            mask.extend([0] * min(cache_bins[ki], total_steps - len(mask)))
            ki += 1
        if ci >= len(compute_bins) and ki >= len(cache_bins):
            break
    if mask:
        mask[-1] = 1
    return mask


@dataclasses.dataclass
class DBCacheConfig:
    residual_diff_threshold: float = 0.08
    Fn_compute_blocks: int = 8
    Bn_compute_blocks: int = 0
    max_warmup_steps: int = 8
    max_cached_steps: int = -1
    max_continuous_cached_steps: int = -1
    max_accumulated_residual_diff: float = -1.0
    scm_mask: str = ""  # "1,0,0,1,…" per-step computation mask (SCM)
    scm_policy_dynamic: bool = True
    start_percent: float = 0.15
    end_percent: float = 0.95


class DBCache:
    """DBCache / cache_dit: skips a step while the input's relative L1 drift
    from the last computed input stays under the Fn / Bn-adjusted threshold,
    re-applying the cached residual; an SCM mask's 1 forces a forward, its 0
    forces a skip under the static policy and only allows the threshold's
    decision under the dynamic one."""

    def __init__(self, model_fn: Callable, config: DBCacheConfig, denoiser=None,
                 total_steps: int = 0):
        self.model_fn = model_fn
        self.config = config
        n = max(total_steps, 1)
        self.start_step = min(int(config.start_percent * n), n - 1)
        self.end_step = min(int(config.end_percent * n), n - 1)
        self.mask = (config.scm_mask if isinstance(config.scm_mask, list)
                     else parse_scm_mask(config.scm_mask))
        self.reset()

    def reset(self):
        self.warmup_remaining = self.config.max_warmup_steps
        self.prev_input = None
        self.cache_diff = None
        self.cached_steps: list = []
        self.continuous_cached = 0
        self.accumulated_diff = 0.0
        self.steps_skipped = 0

    def _effective_threshold(self) -> float:
        t = self.config.residual_diff_threshold
        if self.config.Fn_compute_blocks > 0:
            t *= min(2.0, max(0.5, 1.0 + 0.02 * (self.config.Fn_compute_blocks - 8)))
        if self.config.Bn_compute_blocks > 0:
            t *= min(1.0, max(0.5, 1.0 - 0.03 * self.config.Bn_compute_blocks))
        return t

    def __call__(self, x, sigma, i):
        i = int(i)
        xin = x.float()
        active = self.start_step <= i <= self.end_step
        if active and self.warmup_remaining > 0:
            self.warmup_remaining -= 1
            active = False
        force_compute = force_cache = False
        if active and self.mask and i < len(self.mask):
            if self.mask[i] == 1:
                force_compute = True
            elif not self.config.scm_policy_dynamic:
                force_cache = True
        if active and not force_compute and self.cache_diff is not None:
            cfg = self.config
            caps_ok = ((cfg.max_cached_steps < 0 or len(self.cached_steps) < cfg.max_cached_steps)
                       and (cfg.max_continuous_cached_steps < 0
                            or self.continuous_cached < cfg.max_continuous_cached_steps)
                       and (cfg.max_accumulated_residual_diff < 0
                            or self.accumulated_diff < cfg.max_accumulated_residual_diff))
            if caps_ok:
                denom = float(self.prev_input.abs().sum()) + 1e-6
                diff = float((xin - self.prev_input).abs().sum()) / denom
                if force_cache or diff < self._effective_threshold():
                    self.steps_skipped += 1
                    self.cached_steps.append(i)
                    self.continuous_cached += 1
                    self.accumulated_diff += diff
                    pred = xin + self.cache_diff
                    return pred, pred
        pred, uncond = self.model_fn(x, sigma, i)
        self.cache_diff = pred.float() - xin
        self.prev_input = xin
        self.continuous_cached = 0
        return pred, uncond


CACHE_TYPES = {
    "easycache": (EasyCache, EasyCacheConfig),
    "ucache": (UCache, UCacheConfig),
    "taylorseer": (TaylorSeer, TaylorSeerConfig),
    "spectrum": (Spectrum, SpectrumConfig),
    "dbcache": (DBCache, DBCacheConfig),
    "cache_dit": (DBCache, DBCacheConfig),
}


def make_step_cache(kind: str, model_fn, denoiser, total_steps: int, **kwargs):
    """The cache ``kind`` around ``model_fn``; keyword options that are not
    fields of its config are ignored, as in the JAX package."""
    if kind not in CACHE_TYPES:
        raise ValueError(f"unknown step cache {kind!r}; choose from {sorted(CACHE_TYPES)}")
    cls, cfg_cls = CACHE_TYPES[kind]
    cfg_fields = {f.name for f in dataclasses.fields(cfg_cls)}
    cfg = cfg_cls(**{k: v for k, v in kwargs.items() if k in cfg_fields})
    return cls(model_fn, cfg, denoiser, total_steps)
