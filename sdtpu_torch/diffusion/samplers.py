"""The flow Euler and Euler-ancestral samplers (counterpart of
``sdtpu/diffusion/samplers.py``: ``ancestral_steps``, ``_per_step_common``,
``_euler_step``, ``_euler_a_step``, ``sample_stepwise``).

Per-step scalars are precomputed on the host in numpy float32, as in the JAX
package; its ``lax.scan`` becomes a Python loop over the same per-step
arrays.  Each scalar reaches the device as a 0-dim float32 tensor, so the
step arithmetic is float32 throughout.  ``euler_a`` at ``eta > 0`` takes
its noise from a precomputed ``noises[steps, ...]`` stack drawn from the
pipeline's ``rng`` stream, as the JAX pipeline draws it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

PORTED_METHODS = ("euler", "euler_a")


def ancestral_steps(sigmas: np.ndarray, eta: float, is_flow: bool):
    """Per-step (sigma_down, sigma_up, alpha_scale) arrays in float32."""
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n = len(sigmas) - 1
    down = sigmas[1:n + 1].copy()
    up = np.zeros(n, dtype=np.float32)
    alpha = np.ones(n, dtype=np.float32)
    for i in range(n):
        s_from, s_to = float(sigmas[i]), float(sigmas[i + 1])
        if is_flow:
            if eta <= 0.0 or s_from <= 0.0 or s_to <= 0.0:
                continue
            e = min(eta, 1.0)
            ratio = s_to / s_from
            sd = s_to * (1.0 + (ratio - 1.0) * e)
            sd = max(0.0, min(s_to, sd))
            denom = 1.0 - sd
            if denom <= 0.0:
                down[i] = s_to
                continue
            a = (1.0 - s_to) / denom
            term = max(-1.0, min(1.0, (sd / s_to) * a))
            up[i] = s_to * math.sqrt(max(1.0 - term * term, 0.0))
            down[i] = sd
            alpha[i] = a
        else:
            if eta <= 0.0:
                continue
            if s_from > 0.0:
                term = s_to ** 2 * (s_from ** 2 - s_to ** 2) / s_from ** 2
                up[i] = min(s_to, eta * math.sqrt(max(term, 0.0)))
            sd_sq = s_to ** 2 - up[i] ** 2
            down[i] = math.sqrt(sd_sq) if sd_sq > 0 else 0.0
    return down, up, alpha


def per_step_arrays(sigmas: np.ndarray, method: str = "euler", eta: float = 0.0,
                    is_flow: bool = False) -> Dict[str, np.ndarray]:
    """The per-step arrays of ``_per_step_common``; the ancestral ones only
    for ``euler_a``, the one step that reads them."""
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n = len(sigmas) - 1
    per = {"i": np.arange(n, dtype=np.int32), "sigma": sigmas[:n], "sigma_next": sigmas[1:n + 1]}
    if method == "euler_a":
        per["sigma_down"], per["sigma_up"], per["alpha_scale"] = ancestral_steps(sigmas, eta,
                                                                                 is_flow)
    return per


# the per-step scalars each step reads on the device (``euler_a`` reads
# sigma_next and sigma_up on the host as well)
DEVICE_SCALARS = {"euler": ("sigma", "sigma_next"),
                  "euler_a": ("sigma", "sigma_down", "sigma_up", "alpha_scale")}


def method_needs_noise(method: str, eta: float) -> bool:
    """Whether a method draws per-step noise (``_method_needs_noise`` of the
    JAX pipeline, for the ported methods)."""
    return method == "euler_a" and eta > 0.0


def _euler_step(model_fn: Callable):
    def step(carry, s):
        x = carry["x"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        d = (x - den) / s["sigma"]
        return {"x": x + d * (s["sigma_next"] - s["sigma"])}

    return step


def _euler_a_step(model_fn: Callable, is_flow: bool):
    """The per-step scalars are host floats here (``s["host"]``), so the JAX
    step's ``where`` selects become branches."""
    def step(carry, s):
        x = carry["x"]
        host = s["host"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        if host["sigma_next"] == 0.0:  # final step: x = denoised exactly
            return {"x": den}
        ratio = s["sigma_down"] / s["sigma"]
        x_new = ratio * x + (1.0 - ratio) * den
        if is_flow and host["sigma_up"] > 0:
            x_new = x_new * s["alpha_scale"]
        if "noise" in s:
            x_new = x_new + s["noise"] * s["sigma_up"]
        return {"x": x_new}

    return step


def sample(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray, method: str = "euler",
           noises: Optional[np.ndarray] = None, eta: float = 0.0, is_flow: bool = False,
           step_callback: Optional[Callable] = None) -> torch.Tensor:
    """Run the denoise loop.  model_fn(x, sigma, i) → (denoised,
    uncond_denoised), with sigma a 0-dim float32 tensor on x's device.
    noises: [steps, *x.shape] for ``euler_a`` at eta > 0.  step_callback(i,
    x) runs after each step; returning False stops the loop (cancellation)."""
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"sampler {method!r} is not ported yet; ported: {list(PORTED_METHODS)}")
    per = per_step_arrays(sigmas, method, eta, is_flow)
    n = len(per["i"])
    if method == "euler":
        step = _euler_step(model_fn)
    else:
        if method_needs_noise(method, eta) and noises is None:
            raise ValueError("euler_a at eta > 0 needs its per-step noises")
        step = _euler_a_step(model_fn, is_flow)
    dev = x.device
    carry = {"x": x}
    for i in range(n):
        s = {k: torch.tensor(per[k][i], device=dev) for k in DEVICE_SCALARS[method]}
        s["i"] = int(per["i"][i])
        if method == "euler_a":
            s["host"] = {k: float(per[k][i]) for k in ("sigma_next", "sigma_up")}
            if noises is not None:
                s["noise"] = torch.from_numpy(np.ascontiguousarray(noises[i])).to(dev)
        carry = step(carry, s)
        if step_callback is not None and step_callback(i, carry["x"]) is False:
            break
    return carry["x"]
