"""The samplers (counterpart of ``sdtpu/diffusion/samplers.py``: every step
function of its ``build_sampler`` but SeFi's dual-schedule Euler, the
per-step tables ``ancestral_steps``, ``_per_step_common``,
``_dpmpp_2m_coeffs``, ``_ipndm_h_prev``, ``_tcd_coeffs``, ``_er_sde_coeffs``,
``NOISY_METHODS``, ``build_sampler`` and ``sample``).

Per-step scalars are precomputed on the host in numpy float32, as in the JAX
package; its ``lax.scan`` becomes a Python loop over the same per-step
arrays, so ``sample`` is also the JAX ``sample_stepwise`` (a step callback,
and a model function that may skip forwards on the host, as the step
caches do).  State a model function carries across steps (APG's momentum)
lives in the model function; the JAX scan threads it through its carry as
a ``StatefulModel``.  The arrays go to the device once, as one [steps, k]
float32 table whose row views are each step's 0-dim scalars, so the step
arithmetic is float32 throughout; the JAX steps' ``where`` selects on per-step values
become branches on their host copies (``s["host"]``).  A forward whose
result the JAX step computes and then discards is not made: the second
forward of ``heun``, ``dpm2``, ``dpm++2s_a`` and ``res_2s`` on their last
step, and of the flow ``dpm++2s_a`` on a step from sigma 1.  Noisy methods
take their noise from a precomputed ``noises[steps, ...]`` stack drawn from
the pipeline's sampler stream, as the JAX pipeline draws it; where a JAX
step adds noise that was not given, it adds zeros.  ``sefi_euler`` (the
SeFi model's) raises by name.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sdtpu_torch.diffusion.denoiser import compvis_alphas_cumprod

SAMPLE_METHODS = [
    "euler", "sefi_euler", "euler_a", "heun", "dpm2", "dpm++2s_a", "dpm++2m", "dpm++2m_v2",
    "dpm++2m_sde", "dpm++2m_sde_bt", "ipndm", "ipndm_v", "lcm", "ddim_trailing",
    "tcd", "res_multistep", "res_2s", "er_sde", "euler_cfg_pp", "euler_a_cfg_pp",
    "euler_ge",
]
PORTED_METHODS = tuple(m for m in SAMPLE_METHODS if m != "sefi_euler")
NOISY_METHODS = frozenset({
    "euler_a", "dpm++2s_a", "dpm++2m_sde", "dpm++2m_sde_bt", "lcm", "ddim_trailing",
    "tcd", "euler_a_cfg_pp", "euler_ge", "res_multistep", "res_2s", "er_sde",
})


def method_needs_noise(method: str, eta: float) -> bool:
    """Whether a method draws per-step noise (``_method_needs_noise`` of the
    JAX pipeline): ``lcm`` always, the other noisy methods at eta > 0."""
    return method == "lcm" or (method in NOISY_METHODS and eta > 0.0)


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


def _per_step_common(sigmas: np.ndarray, eta: float, is_flow: bool) -> Dict[str, np.ndarray]:
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n = len(sigmas) - 1
    down, up, alpha = ancestral_steps(sigmas, eta, is_flow)
    return {"i": np.arange(n, dtype=np.int32), "sigma": sigmas[:n], "sigma_next": sigmas[1:n + 1],
            "sigma_prev": np.concatenate([sigmas[:1], sigmas[:n - 1]]),
            "sigma_down": down, "sigma_up": up, "alpha_scale": alpha}


def dpmpp_2m_coeffs(sigmas: np.ndarray, v2: bool = False) -> Dict[str, np.ndarray]:
    """DPM++ 2M's per-step (a, b_first, b_multi, r) in float32
    (``_dpmpp_2m_coeffs``; ``v2``: the variant's symmetric step ratio)."""
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
            h_last = t - t_fn(sigmas[i - 1])
            if v2:
                h_min, h_max = min(h_last, h), max(h_last, h)
                r_arr[i] = h_max / h_min
                b_multi[i] = math.exp(-(h_max + h_min) / 2.0) - 1.0
            else:
                r_arr[i] = h_last / h
                b_multi[i] = b_first[i]
    return {"a": a, "b_first": b_first, "b_multi": b_multi, "r": r_arr}


def _ipndm_h_prev(sigmas: np.ndarray) -> np.ndarray:
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n = len(sigmas) - 1
    h_prev = np.zeros(n, dtype=np.float32)
    for i in range(n):
        h_n = sigmas[i + 1] - sigmas[i]
        h_prev[i] = (sigmas[i] - sigmas[i - 1]) if i > 0 else h_n
    return h_prev


def _tcd_coeffs(sigmas: np.ndarray, eta: float) -> Dict[str, np.ndarray]:
    """TCD's per-step coefficients on the DDPM ᾱ table (``alphas_cumprod``)."""
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n = len(sigmas) - 1
    ac = compvis_alphas_cumprod()
    compvis_sigmas = np.sqrt((1 - ac) / ac)
    coef_den = np.zeros(n, dtype=np.float32)
    coef_d = np.zeros(n, dtype=np.float32)
    coef_renoise_x = np.ones(n, dtype=np.float32)
    coef_noise = np.zeros(n, dtype=np.float32)
    for i in range(n):
        sigma_to = float(sigmas[i + 1])
        idx = int(np.searchsorted(compvis_sigmas, sigma_to))
        if idx == 0:
            prev_timestep = 0
        elif idx >= len(compvis_sigmas):
            prev_timestep = len(compvis_sigmas) - 1
        else:
            lo, hi = idx - 1, idx
            prev_timestep = hi if abs(compvis_sigmas[hi] - sigma_to) < abs(
                compvis_sigmas[lo] - sigma_to) else lo
        timestep_s = int(math.floor((1 - eta) * prev_timestep))
        alpha_prod_t_prev = 1.0 / (sigma_to ** 2 + 1.0)
        alpha_prod_s = float(ac[timestep_s])
        beta_prod_s = 1.0 - alpha_prod_s
        coef_den[i] = math.sqrt(alpha_prod_s / alpha_prod_t_prev)
        coef_d[i] = math.sqrt(beta_prod_s / alpha_prod_t_prev)
        if eta > 0 and sigma_to > 0:
            coef_renoise_x[i] = math.sqrt(alpha_prod_t_prev / alpha_prod_s)
            coef_noise[i] = math.sqrt(max(1.0 / alpha_prod_t_prev - 1.0 / alpha_prod_s, 0.0))
    return {"coef_den": coef_den, "coef_d": coef_d, "coef_renoise_x": coef_renoise_x,
            "coef_noise": coef_noise}


def _er_sde_coeffs(sigmas: np.ndarray, eta: float, is_flow: bool) -> Dict[str, np.ndarray]:
    """ER-SDE's per-step coefficients (the reference's host math)."""
    sigmas = np.asarray(sigmas, dtype=np.float32).copy()
    n = len(sigmas) - 1

    def flow_sigma(s):
        return min(max(s, 1e-6), 1.0 - 1e-4)

    def to_lambda(s):
        if is_flow:
            s = flow_sigma(s)
            return s / max(1.0 - s, 1e-6)
        return max(s, 1e-6)

    def to_alpha(s):
        return 1.0 - flow_sigma(s) if is_flow else 1.0

    def noise_scaler(x):
        x = max(x, 0.0)
        return x * (math.exp(x ** 0.3) + 10.0)

    if is_flow:
        for i in range(n):
            if sigmas[i] > 1.0:
                sigmas[i] = flow_sigma(sigmas[i])
    lambdas = np.asarray([to_lambda(float(s)) for s in sigmas], dtype=np.float32)
    out = {k: np.ones(n, np.float32) for k in ("r_alpha", "r", "alpha_t")}
    out.update({k: np.zeros(n, np.float32) for k in (
        "coeff_d", "coeff_u", "denom_d", "denom_u", "use_stage2", "use_stage3", "noise_scale")})
    num_pts = 200
    for i in range(n):
        if sigmas[i + 1] == 0.0:
            continue
        l_s, l_t = float(lambdas[i]), float(lambdas[i + 1])
        a_s, a_t = to_alpha(float(sigmas[i])), to_alpha(float(sigmas[i + 1]))
        sc_s, sc_t = noise_scaler(l_s), noise_scaler(l_t)
        r = sc_t / sc_s if sc_s > 0 else 0.0
        out["r_alpha"][i] = a_t / a_s if a_s > 0 else 0.0
        out["r"][i] = r
        out["alpha_t"][i] = a_t
        stage = min(3, i + 1)
        if stage >= 2:
            dt = l_t - l_s
            step_sz = -dt / num_pts
            ssum = 0.0
            s_u = 0.0
            for p in range(num_pts):
                pos = l_t + p * step_sz
                sp = noise_scaler(pos)
                if sp <= 0:
                    continue
                ssum += 1.0 / sp
                if stage >= 3:
                    s_u += (pos - l_s) / sp
            ssum *= step_sz
            denom_d = l_s - float(lambdas[i - 1])
            if abs(denom_d) > 1e-12:
                out["use_stage2"][i] = 1.0
                out["denom_d"][i] = denom_d
                out["coeff_d"][i] = a_t * (dt + ssum * sc_t)
                if stage >= 3:
                    denom_u = (l_s - float(lambdas[i - 2])) * 0.5
                    if abs(denom_u) > 1e-12:
                        out["use_stage3"][i] = 1.0
                        out["denom_u"][i] = denom_u
                        s_u *= step_sz
                        out["coeff_u"][i] = a_t * (0.5 * dt * dt + s_u * sc_t)
        nsq = l_t * l_t - l_s * l_s * r * r
        if eta > 0 and nsq > 0:
            out["noise_scale"][i] = a_t * math.sqrt(max(nsq, 0.0))
    return out


def per_step_arrays(sigmas: np.ndarray, method: str = "euler", eta: float = 0.0,
                    is_flow: bool = False,
                    extra_args: Optional[Dict[str, float]] = None) -> Dict[str, np.ndarray]:
    """The per-step arrays of the JAX ``build_sampler`` for ``method`` (its
    ``per`` before the noise stack): the common ones of ``_per_step_common``
    and the method's own (ancestral splits, DPM++ 2M's coefficients, iPNDM's
    previous step, LCM's noise scale from ``noise_scale_start`` /
    ``noise_scale_end`` of ``extra_args``, TCD's and ER-SDE's tables)."""
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"sampler {method!r} is not ported yet; ported: {list(PORTED_METHODS)}")
    extra_args = extra_args or {}
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n = len(sigmas) - 1
    per = _per_step_common(sigmas, eta, is_flow)
    method = {"ddim_trailing": "euler_a"}.get(method, method)
    if method == "euler_a" and eta == 0.0:
        per["sigma_down"] = per["sigma_next"]
        per["sigma_up"] = np.zeros(n, dtype=np.float32)
    elif method in ("euler_a_cfg_pp", "dpm++2s_a"):
        flow = is_flow and method == "dpm++2s_a"
        d, u, a = ancestral_steps(sigmas, eta, flow)
        per["sigma_down"], per["sigma_up"] = d, u
        if flow:
            per["alpha_scale"] = a
    elif method in ("dpm++2m", "dpm++2m_v2"):
        per.update(dpmpp_2m_coeffs(sigmas, v2=method.endswith("v2")))
    elif method in ("dpm++2m_sde", "dpm++2m_sde_bt"):
        per["eta"] = np.full(n, eta, dtype=np.float32)
    elif method in ("ipndm", "ipndm_v"):
        per["h_prev"] = _ipndm_h_prev(sigmas)
    elif method == "lcm":
        ns_start = float(extra_args.get("noise_scale_start", 1.0))
        ns_end = float(extra_args.get("noise_scale_end", ns_start))
        t = np.arange(n, dtype=np.float32) / max(n - 1, 1)
        per["noise_scale"] = (ns_start + (ns_end - ns_start) * t).astype(np.float32)
    elif method == "tcd":
        per.update(_tcd_coeffs(sigmas, eta))
    elif method == "er_sde":
        per.update(_er_sde_coeffs(sigmas, eta, is_flow))
    return per


def _noise(s, scale):
    """The step's noise times ``scale``, or None where no noise was given
    (the JAX step adds zeros there)."""
    return s["noise"] * scale if "noise" in s else None


def _plus(x, term):
    return x if term is None else x + term


def _phi1(t):
    small = torch.abs(t) < 1e-6
    safe = (torch.exp(t) - 1.0) / torch.where(small, torch.ones_like(t), t)
    taylor = 1.0 + t * 0.5 + (t * t) / 6.0
    return torch.where(small, taylor, safe)


def _phi2(t):
    small = torch.abs(t) < 1e-6
    safe = (_phi1(t) - 1.0) / torch.where(small, torch.ones_like(t), t)
    taylor = 0.5 + t / 6.0 + (t * t) / 24.0
    return torch.where(small, taylor, safe)


# ---------------------------------------------------------------- euler family


def _euler_step(model_fn: Callable):
    def step(carry, s):
        x = carry["x"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        d = (x - den) / s["sigma"]
        return {"x": x + d * (s["sigma_next"] - s["sigma"])}

    return step


def _euler_a_step(model_fn: Callable, is_flow: bool):
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
        return {"x": _plus(x_new, _noise(s, s["sigma_up"]))}

    return step


def _euler_cfg_pp_step(model_fn: Callable):
    """Euler CFG++: the step's direction from the uncond estimate."""
    def step(carry, s):
        x = carry["x"]
        den, den_u = model_fn(x, s["sigma"], s["i"])
        d = (x - den_u) / s["sigma"]
        return {"x": den + d * s["sigma_next"]}

    return step


def _euler_a_cfg_pp_step(model_fn: Callable):
    def step(carry, s):
        x = carry["x"]
        den, den_u = model_fn(x, s["sigma"], s["i"])
        d = (x - den_u) / s["sigma"]
        x_new = den + d * s["sigma_down"]
        if s["host"]["sigma_next"] > 0:
            x_new = _plus(x_new, _noise(s, s["sigma_up"]))
        return {"x": x_new}

    return step


def _euler_ge_step(model_fn: Callable, is_flow: bool, gamma: float):
    """Euler with gradient estimation: the derivative mixed with the last
    step's by ``gamma``."""
    def step(carry, s):
        x = carry["x"]
        host = s["host"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        d = (x - den) / s["sigma"]
        dt = s["sigma_down"] - s["sigma"]
        d_bar = d * gamma + carry["old_d"] * (1.0 - gamma) if carry["has_old"] else d
        x_new = x + d_bar * dt
        if is_flow and host["sigma_up"] > 0:
            x_new = x_new * s["alpha_scale"]
        x_new = _plus(x_new, _noise(s, s["sigma_up"]))
        if host["sigma_next"] == 0.0:
            x_new = den
        return {"x": x_new, "old_d": d, "has_old": True}

    return step


# ------------------------------------------------------------- 2nd order (2 calls)


def _heun_step(model_fn: Callable):
    """Heun: an Euler step, then the trapezoid of its two derivatives; the
    last step (sigma_next == 0) keeps the Euler step."""
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


def _dpm2_step(model_fn: Callable):
    """DPM2: the derivative at the geometric midpoint sigma; the last step
    is an Euler step."""
    def step(carry, s):
        x = carry["x"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        d = (x - den) / s["sigma"]
        if s["host"]["sigma_next"] == 0.0:
            return {"x": x + d * (s["sigma_next"] - s["sigma"])}
        sigma_mid = torch.exp(0.5 * (torch.log(s["sigma"]) + torch.log(s["sigma_next"])))
        x2 = x + d * (sigma_mid - s["sigma"])
        den2, _ = model_fn(x2, sigma_mid, s["i"])
        return {"x": x + ((x2 - den2) / sigma_mid) * (s["sigma_next"] - s["sigma"])}

    return step


def _dpmpp_2s_a_step(model_fn: Callable):
    """DPM++ 2S ancestral (eps / v): its last step (sigma_down == 0) returns
    the first forward's denoised."""
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
        if host["sigma_next"] > 0:
            x_new = _plus(x_new, _noise(s, s["sigma_up"]))
        return {"x": x_new}

    return step


def _dpmpp_2s_a_flow_step(model_fn: Callable):
    """DPM++ 2S ancestral on a flow schedule: the midpoint in the flow's
    log-SNR; from sigma 1 the first forward's denoised stands for the
    second's; the last step returns the denoised."""
    def step(carry, s):
        x = carry["x"]
        host = s["host"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        if host["sigma_next"] == 0.0:
            return {"x": den}
        if 1.0 - host["sigma"] < 1e-6:
            d_i = den
        else:
            sd = s["sigma_down"] if host["sigma_down"] > 0.0 else torch.full_like(s["sigma"], 0.5)
            exp_s = torch.sqrt(((1.0 - s["sigma"]) / s["sigma"]) * ((1.0 - sd) / sd))
            sigma_s = 1.0 / (exp_s + 1.0)
            r = sigma_s / s["sigma"]
            d_i, _ = model_fn(x * r + den * (1.0 - r), sigma_s, s["i"])
        rd = s["sigma_down"] / s["sigma"]
        x_new = x * rd + d_i * (1.0 - rd)
        if host["sigma_up"] > 0:
            x_new = _plus(s["alpha_scale"] * x_new, _noise(s, s["sigma_up"]))
        return {"x": x_new}

    return step


def _res_2s_step(model_fn: Callable, is_flow: bool):
    """RES 2S: a second-order exponential-integrator step through the
    half-way log sigma; the last step (sigma_down == 0) returns the
    denoised."""
    def step(carry, s):
        x = carry["x"]
        host = s["host"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        if host["sigma_down"] == 0.0 or host["sigma"] == 0.0:
            x_new = den
        else:
            c2 = 0.5
            t = -torch.log(s["sigma"])
            h = -torch.log(s["sigma_down"]) - t
            a21 = c2 * _phi1(-h * c2)
            b2 = _phi2(-h) / c2
            b1 = _phi1(-h) - b2
            sigma_c2 = torch.exp(-(t + h * c2))
            eps1 = den - x
            den2, _ = model_fn(x + eps1 * (h * a21), sigma_c2, s["i"])
            x_new = x + h * (b1 * eps1 + b2 * (den2 - x))
        if is_flow and host["sigma_up"] > 0:
            x_new = x_new * s["alpha_scale"]
        if host["sigma_next"] > 0:
            x_new = _plus(x_new, _noise(s, s["sigma_up"]))
        return {"x": x_new}

    return step


# --------------------------------------------------------------- multistep


def _dpmpp_2m_step(model_fn: Callable):
    """DPM++ 2M (and 2M v2, by its coefficients): the first and last steps
    are first order, the rest extrapolate from the previous denoised."""
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


def _dpmpp_2m_sde_step(model_fn: Callable):
    """DPM++ 2M SDE (its noise from the stack: per-step draws, or the
    Brownian tree's for ``dpm++2m_sde_bt``)."""
    def step(carry, s):
        x = carry["x"]
        host = s["host"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        if host["sigma_next"] == 0.0:
            return {"x": den, "old_denoised": den, "have_old": True, "h_last": carry["h_last"]}
        t = -torch.log(s["sigma"])
        h = -torch.log(s["sigma_next"]) - t
        eta_h = s["eta"] * h
        a = s["sigma_next"] / s["sigma"] * torch.exp(-eta_h)
        b = -torch.expm1(-h - eta_h)
        x_new = a * x + b * den
        if carry["have_old"]:
            r = carry["h_last"] / h
            x_new = x_new + (0.5 * b / r) * (den - carry["old_denoised"])
        if host["eta"] > 0:
            x_new = _plus(x_new, _noise(s, s["sigma_next"] * torch.sqrt(-torch.expm1(-2.0 * eta_h))))
        return {"x": x_new, "old_denoised": den, "have_old": True, "h_last": h}

    return step


def _ipndm_step(model_fn: Callable, variable_step: bool):
    """iPNDM: Adams-Bashforth of order min(i + 1, 4) over the last three
    derivatives; ``variable_step`` (``ipndm_v``) weighs the second order by
    the ratio of the step to the previous one."""
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
            if variable_step:
                rr = h_n / s["h_prev"]
                upd = ((2.0 + rr) * d - rr * h1) / 2.0
            else:
                upd = (3.0 * d - h1) / 2.0
        elif order == 3:
            upd = (23.0 * d - 16.0 * h1 + 5.0 * h2) / 12.0
        else:
            upd = (55.0 * d - 59.0 * h1 + 37.0 * h2 - 9.0 * h3) / 24.0
        return {"x": x + upd * h_n, "hist": [hist[1], hist[2], d]}

    return step


def _lcm_step(model_fn: Callable, is_flow: bool):
    """LCM: x = the denoised estimate, re-noised to the next sigma (times its
    noise scale) unless that is the last, 0."""
    def step(carry, s):
        den, _ = model_fn(carry["x"], s["sigma"], s["i"])
        if s["host"]["sigma_next"] <= 0.0:
            return {"x": den}
        x_new = den * (1.0 - s["sigma_next"]) if is_flow else den
        return {"x": _plus(x_new, _noise(s, s["sigma_next"] * s["noise_scale"]))}

    return step


def _tcd_step(model_fn: Callable):
    """TCD: the DDIM-like jump to the table's timestep, re-noised to the
    next sigma by ``eta``."""
    def step(carry, s):
        x = carry["x"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        d = (x - den) / s["sigma"]
        x_new = s["coef_den"] * den + s["coef_d"] * d
        if s["host"]["sigma_next"] > 0:
            renoise = s["coef_renoise_x"] * x_new - x_new
            x_new = x_new + _plus(renoise, _noise(s, s["coef_noise"]))
        return {"x": x_new}

    return step


def _res_multistep_step(model_fn: Callable, is_flow: bool):
    """RES multistep: the exponential integrator over the last two denoised
    estimates; Euler on the first and last steps."""
    def step(carry, s):
        x = carry["x"]
        host = s["host"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        if host["sigma_down"] == 0.0 or not carry["have_old"]:
            x_new = x + ((x - den) / s["sigma"]) * (s["sigma_down"] - s["sigma"])
        else:
            t = -torch.log(s["sigma"])
            t_old = -torch.log(torch.clamp(carry["old_sigma_down"], min=1e-20))
            t_next = -torch.log(s["sigma_down"])
            t_prev = -torch.log(torch.clamp(s["sigma_prev"], min=1e-20))
            h = t_next - t
            c2 = (t_prev - t_old) / h
            phi1_v, phi2_v = _phi1(-h), _phi2(-h)
            b1 = phi1_v - phi2_v / c2
            b2 = phi2_v / c2
            b1 = torch.where(torch.isfinite(b1), b1, torch.zeros_like(b1))
            b2 = torch.where(torch.isfinite(b2), b2, torch.zeros_like(b2))
            x_new = torch.exp(-h) * x + h * (b1 * den + b2 * carry["old_denoised"])
        if is_flow and host["sigma_up"] > 0:
            x_new = x_new * s["alpha_scale"]
        if host["sigma_next"] > 0 and host["sigma_up"] > 0:
            x_new = _plus(x_new, _noise(s, s["sigma_up"]))
        return {"x": x_new, "old_denoised": den, "have_old": True,
                "old_sigma_down": s["sigma_down"]}

    return step


def _er_sde_step(model_fn: Callable):
    """ER-SDE: up to third order over the denoised estimates' divided
    differences, by the step's stage flags."""
    def step(carry, s):
        x = carry["x"]
        host = s["host"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        x_new = s["r_alpha"] * s["r"] * x + s["alpha_t"] * (1.0 - s["r"]) * den
        stage2 = host["use_stage2"] > 0 and carry["have_old"]
        old_den_d, have_old_d = carry["old_denoised_d"], carry["have_old_d"]
        if stage2:
            den_d = (den - carry["old_denoised"]) / (s["denom_d"] if host["denom_d"] != 0 else 1.0)
            x_new = x_new + s["coeff_d"] * den_d
            if host["use_stage3"] > 0 and have_old_d:
                den_u = (den_d - old_den_d) / (s["denom_u"] if host["denom_u"] != 0 else 1.0)
                x_new = x_new + s["coeff_u"] * den_u
            old_den_d, have_old_d = den_d, True
        if host["noise_scale"] > 0:
            x_new = _plus(x_new, _noise(s, s["noise_scale"]))
        if host["sigma_next"] == 0.0:
            x_new = den
        return {"x": x_new, "old_denoised": den, "have_old": True, "old_denoised_d": old_den_d,
                "have_old_d": have_old_d}

    return step


# ------------------------------------------------------------------ dispatch


def build_sampler(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray, method: str = "euler",
                  eta: float = 0.0, is_flow: bool = False,
                  extra_args: Optional[Dict[str, float]] = None):
    """→ (step(carry, s) → carry, the initial carry, the per-step arrays)."""
    extra_args = extra_args or {}
    per = per_step_arrays(sigmas, method, eta, is_flow, extra_args)
    method = {"ddim_trailing": "euler_a"}.get(method, method)
    carry = {"x": x}
    if method == "euler":
        step = _euler_step(model_fn)
    elif method == "euler_a":
        step = _euler_a_step(model_fn, is_flow)
    elif method == "euler_cfg_pp":
        step = _euler_cfg_pp_step(model_fn)
    elif method == "euler_a_cfg_pp":
        step = _euler_a_cfg_pp_step(model_fn)
    elif method == "euler_ge":
        step = _euler_ge_step(model_fn, is_flow, float(extra_args.get("gamma", 2.0)))
        carry.update(old_d=torch.zeros_like(x), has_old=False)
    elif method == "heun":
        step = _heun_step(model_fn)
    elif method == "dpm2":
        step = _dpm2_step(model_fn)
    elif method == "dpm++2s_a":
        step = _dpmpp_2s_a_flow_step(model_fn) if is_flow else _dpmpp_2s_a_step(model_fn)
    elif method in ("dpm++2m", "dpm++2m_v2"):
        step = _dpmpp_2m_step(model_fn)
        carry["old_denoised"] = x
    elif method in ("dpm++2m_sde", "dpm++2m_sde_bt"):
        step = _dpmpp_2m_sde_step(model_fn)
        carry.update(old_denoised=x, have_old=False,
                     h_last=torch.ones((), dtype=torch.float32, device=x.device))
    elif method in ("ipndm", "ipndm_v"):
        step = _ipndm_step(model_fn, variable_step=method == "ipndm_v")
        carry["hist"] = [torch.zeros_like(x)] * 3
    elif method == "lcm":
        step = _lcm_step(model_fn, is_flow)
    elif method == "tcd":
        step = _tcd_step(model_fn)
    elif method == "res_multistep":
        step = _res_multistep_step(model_fn, is_flow)
        carry.update(old_denoised=x, have_old=False,
                     old_sigma_down=torch.ones((), dtype=torch.float32, device=x.device))
    elif method == "res_2s":
        step = _res_2s_step(model_fn, is_flow)
    else:  # er_sde
        step = _er_sde_step(model_fn)
        carry.update(old_denoised=x, have_old=False, old_denoised_d=torch.zeros_like(x),
                     have_old_d=False)
    return step, carry, per


def sample(model_fn, x: torch.Tensor, sigmas: np.ndarray, method: str = "euler",
           noises: Optional[np.ndarray] = None, eta: float = 0.0, is_flow: bool = False,
           step_callback: Optional[Callable] = None,
           extra_args: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Run the denoise loop.  model_fn(x, sigma, i) → (denoised,
    uncond_denoised), with sigma a 0-dim float32 tensor on x's device.  noises: [steps, *x.shape] where
    ``method_needs_noise``.  extra_args: the sampler's keys of
    ``extra_sample_args`` (``gamma``, ``lcm``'s noise scales).
    step_callback(i, x) runs after each step; returning False stops the loop
    (cancellation)."""
    if method_needs_noise(method, eta) and noises is None:
        raise ValueError(f"{method} needs its per-step noises")
    step, carry, per = build_sampler(model_fn, x, sigmas, method, eta, is_flow, extra_args)
    n = len(per["i"])
    names = [k for k in per if k != "i"]
    dev = x.device
    table = torch.from_numpy(np.stack([per[k].astype(np.float32) for k in names], axis=1)).to(dev)
    for i in range(n):
        s = {k: table[i, j] for j, k in enumerate(names)}
        s["i"] = int(per["i"][i])
        s["host"] = {k: float(per[k][i]) for k in names}
        if noises is not None and method in NOISY_METHODS:
            s["noise"] = torch.from_numpy(np.ascontiguousarray(noises[i])).to(dev)
        carry = step(carry, s)
        if step_callback is not None and step_callback(i, carry["x"]) is False:
            break
    return carry["x"]
