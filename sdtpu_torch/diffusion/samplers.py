"""The samplers the port runs (counterpart of ``sdtpu/diffusion/samplers.py``:
``ancestral_steps``, ``_per_step_common``, ``_dpmpp_2m_coeffs``,
``_euler_step``, ``_euler_a_step``, ``_heun_step``, the non-flow
``_dpmpp_2s_a_step``, ``_dpmpp_2m_step``, the fixed-step
``_ipndm_step`` and ``_lcm_step``, driven as ``sample_stepwise`` drives
them).

Per-step scalars are precomputed on the host in numpy float32, as in the JAX
package; its ``lax.scan`` becomes a Python loop over the same per-step
arrays.  Each scalar reaches the device as a 0-dim float32 tensor, so the
step arithmetic is float32 throughout; the JAX steps' ``where`` selects on
per-step values become branches on their host copies.  ``euler_a`` and
``dpm++2s_a`` at ``eta > 0``, and ``lcm`` at any ``eta``, take their noise
from a precomputed ``noises[steps, ...]`` stack drawn from the pipeline's
``rng`` stream, as the JAX pipeline draws it.  Every other method raises by
name.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

PORTED_METHODS = ("euler", "euler_a", "heun", "dpm++2s_a", "dpm++2m", "ipndm", "lcm")
# the ported methods that draw per-step noise: at eta > 0, and ``lcm`` always
NOISY_METHODS = ("euler_a", "dpm++2s_a", "lcm")


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


def dpmpp_2m_coeffs(sigmas: np.ndarray) -> Dict[str, np.ndarray]:
    """DPM++ 2M's per-step (a, b_first, b_multi, r) in float32, as the JAX
    package's ``_dpmpp_2m_coeffs(sigmas, v2=False)`` computes them."""
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n = len(sigmas) - 1
    a = np.zeros(n, dtype=np.float32)
    b_first = np.zeros(n, dtype=np.float32)
    b_multi = np.zeros(n, dtype=np.float32)
    r_arr = np.ones(n, dtype=np.float32)
    t_fn = lambda s: -math.log(max(float(s), 1e-20))  # noqa: E731
    for i in range(n):
        t, t_next = t_fn(sigmas[i]), t_fn(sigmas[i + 1])
        h = t_next - t
        a[i] = sigmas[i + 1] / sigmas[i]
        b_first[i] = math.exp(-h) - 1.0
        if i > 0 and sigmas[i + 1] != 0:
            r_arr[i] = (t - t_fn(sigmas[i - 1])) / h
            b_multi[i] = b_first[i]
    return {"a": a, "b_first": b_first, "b_multi": b_multi, "r": r_arr}


def per_step_arrays(sigmas: np.ndarray, method: str = "euler", eta: float = 0.0,
                    is_flow: bool = False,
                    extra_args: Optional[Dict[str, float]] = None) -> Dict[str, np.ndarray]:
    """The per-step arrays of ``_per_step_common`` and ``build_sampler``
    that a method's step reads: the ancestral split for ``euler_a`` and
    ``dpm++2s_a``, DPM++ 2M's coefficients, LCM's noise scale (linear from
    ``noise_scale_start`` to ``noise_scale_end`` of ``extra_args``, 1.0 by
    default)."""
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n = len(sigmas) - 1
    per = {"i": np.arange(n, dtype=np.int32), "sigma": sigmas[:n], "sigma_next": sigmas[1:n + 1]}
    if method == "euler_a":
        per["sigma_down"], per["sigma_up"], per["alpha_scale"] = ancestral_steps(sigmas, eta,
                                                                                 is_flow)
    elif method == "dpm++2s_a":
        if is_flow:
            raise NotImplementedError("the flow form of sampler 'dpm++2s_a' is not ported yet")
        per["sigma_down"], per["sigma_up"], _ = ancestral_steps(sigmas, eta, False)
    elif method == "dpm++2m":
        per.update(dpmpp_2m_coeffs(sigmas))
    elif method == "lcm":
        extra_args = extra_args or {}
        ns_start = float(extra_args.get("noise_scale_start", 1.0))
        ns_end = float(extra_args.get("noise_scale_end", ns_start))
        t = np.arange(n, dtype=np.float32) / max(n - 1, 1)
        per["noise_scale"] = (ns_start + (ns_end - ns_start) * t).astype(np.float32)
    return per


# the per-step scalars each step reads on the device (every per-step value
# is also a host float in ``s["host"]``, for the JAX step's ``where`` selects)
DEVICE_SCALARS = {"euler": ("sigma", "sigma_next"), "heun": ("sigma", "sigma_next"),
                  "euler_a": ("sigma", "sigma_down", "sigma_up", "alpha_scale"),
                  "dpm++2s_a": ("sigma", "sigma_down", "sigma_up"),
                  "dpm++2m": ("sigma", "a", "b_first", "b_multi", "r"),
                  "ipndm": ("sigma", "sigma_next"),
                  "lcm": ("sigma", "sigma_next", "noise_scale")}


def method_needs_noise(method: str, eta: float) -> bool:
    """Whether a method draws per-step noise (``_method_needs_noise`` of the
    JAX pipeline, for the ported methods): ``lcm`` always, the others at
    eta > 0."""
    return method == "lcm" or (method in NOISY_METHODS and eta > 0.0)


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


def _heun_step(model_fn: Callable):
    """Heun (``_heun_step``): an Euler step, then the trapezoid of its two
    derivatives.  Its last step (sigma_next == 0) keeps the Euler step, so
    the second call, which the JAX step makes at sigma 1 and discards, is
    not made."""
    def step(carry, s):
        x = carry["x"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        d = (x - den) / s["sigma"]
        dt = s["sigma_next"] - s["sigma"]
        x_euler = x + d * dt
        if s["host"]["sigma_next"] == 0.0:
            return {"x": x_euler}
        den2, _ = model_fn(x_euler, s["sigma_next"], s["i"])
        d2 = (d + (x_euler - den2) / s["sigma_next"]) / 2.0
        return {"x": x + d2 * dt}

    return step


def _dpmpp_2s_a_step(model_fn: Callable):
    """DPM++ 2S ancestral (the non-flow ``_dpmpp_2s_a_step``).  Its last step
    (sigma_down == 0) returns the first model call's denoised, so the second
    call, which the JAX step makes and discards, is not made."""
    def step(carry, s):
        x = carry["x"]
        host = s["host"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        if host["sigma_down"] == 0.0:
            x_new = den
        else:
            t = -torch.log(s["sigma"])
            h = -torch.log(s["sigma_down"]) - t
            sigma_s = torch.exp(-(t + 0.5 * h))
            x2 = (sigma_s / s["sigma"]) * x - (torch.exp(-h * 0.5) - 1.0) * den
            den2, _ = model_fn(x2, sigma_s, s["i"])
            x_new = (s["sigma_down"] / s["sigma"]) * x - (torch.exp(-h) - 1.0) * den2
        if "noise" in s and host["sigma_next"] > 0:
            x_new = x_new + s["noise"] * s["sigma_up"]
        return {"x": x_new}

    return step


def _dpmpp_2m_step(model_fn: Callable):
    """DPM++ 2M (``_dpmpp_2m_step``, v2 off): the first and last steps are
    first order, the rest extrapolate from the previous denoised."""
    def step(carry, s):
        x, old_den = carry["x"], carry["old_denoised"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        if s["i"] == 0 or s["host"]["sigma_next"] == 0.0:
            x_new = s["a"] * x - s["b_first"] * den
        else:
            r = s["r"]
            den_d = (1.0 + 1.0 / (2.0 * r)) * den - (1.0 / (2.0 * r)) * old_den
            x_new = s["a"] * x - s["b_multi"] * den_d
        return {"x": x_new, "old_denoised": den}

    return step


def _ipndm_step(model_fn: Callable):
    """iPNDM (``_ipndm_step``, fixed step): Adams-Bashforth of order
    min(i + 1, 4) over the last three derivatives."""
    def step(carry, s):
        x, hist = carry["x"], carry["hist"]  # newest last
        den, _ = model_fn(x, s["sigma"], s["i"])
        d = (x - den) / s["sigma"]
        h_n = s["sigma_next"] - s["sigma"]
        h1, h2, h3 = hist[2], hist[1], hist[0]
        order = min(s["i"] + 1, 4)
        if order == 1:
            upd = d
        elif order == 2:
            upd = (3.0 * d - h1) / 2.0
        elif order == 3:
            upd = (23.0 * d - 16.0 * h1 + 5.0 * h2) / 12.0
        else:
            upd = (55.0 * d - 59.0 * h1 + 37.0 * h2 - 9.0 * h3) / 24.0
        return {"x": x + upd * h_n, "hist": [hist[1], hist[2], d]}

    return step


def _lcm_step(model_fn: Callable, is_flow: bool):
    """LCM (``_lcm_step``): x = the denoised estimate, re-noised to the next
    sigma (times its noise scale) unless that is the last, 0."""
    def step(carry, s):
        den, _ = model_fn(carry["x"], s["sigma"], s["i"])
        if s["host"]["sigma_next"] <= 0.0:
            return {"x": den}
        x_new = den * (1.0 - s["sigma_next"]) if is_flow else den
        if "noise" in s:
            x_new = x_new + s["noise"] * (s["sigma_next"] * s["noise_scale"])
        return {"x": x_new}

    return step


def sample(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray, method: str = "euler",
           noises: Optional[np.ndarray] = None, eta: float = 0.0, is_flow: bool = False,
           step_callback: Optional[Callable] = None,
           extra_args: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Run the denoise loop.  model_fn(x, sigma, i) → (denoised,
    uncond_denoised), with sigma a 0-dim float32 tensor on x's device.
    noises: [steps, *x.shape] where ``method_needs_noise``.  extra_args: the
    sampler's keys of ``extra_sample_args`` (``lcm``'s noise scales).
    step_callback(i, x) runs after each step; returning False stops the loop
    (cancellation)."""
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"sampler {method!r} is not ported yet; ported: {list(PORTED_METHODS)}")
    per = per_step_arrays(sigmas, method, eta, is_flow, extra_args)
    n = len(per["i"])
    if method_needs_noise(method, eta) and noises is None:
        raise ValueError(f"{method} needs its per-step noises")
    carry = {"x": x}
    if method == "euler":
        step = _euler_step(model_fn)
    elif method == "euler_a":
        step = _euler_a_step(model_fn, is_flow)
    elif method == "heun":
        step = _heun_step(model_fn)
    elif method == "dpm++2s_a":
        step = _dpmpp_2s_a_step(model_fn)
    elif method == "dpm++2m":
        step = _dpmpp_2m_step(model_fn)
        carry["old_denoised"] = x
    elif method == "lcm":
        step = _lcm_step(model_fn, is_flow)
    else:
        step = _ipndm_step(model_fn)
        carry["hist"] = [torch.zeros_like(x)] * 3
    dev = x.device
    for i in range(n):
        s = {k: torch.tensor(per[k][i], device=dev) for k in DEVICE_SCALARS[method]}
        s["i"] = int(per["i"][i])
        s["host"] = {k: float(v[i]) for k, v in per.items()}
        if noises is not None and method in NOISY_METHODS:
            s["noise"] = torch.from_numpy(np.ascontiguousarray(noises[i])).to(dev)
        carry = step(carry, s)
        if step_callback is not None and step_callback(i, carry["x"]) is False:
            break
    return carry["x"]
