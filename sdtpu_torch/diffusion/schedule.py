"""Sigma schedules (counterpart of ``sdtpu/diffusion/schedule.py``): all
17 of the JAX package's, ``get_sigmas`` with its keywords, and the helpers
``log_linear_interpolation``, ``_gits_tables`` (its own copy of the GITS
table, ``data/gits_noise.json.gz``), ``_incbeta`` / ``_beta_ppf``,
``_ndtri`` and ``sefi_dual_schedule``.

Host-side numpy, n steps → n + 1 descending sigmas ending in 0.  The port
carries its own copy because importing ``sdtpu.diffusion.schedule`` pulls in
the JAX samplers through ``sdtpu/diffusion/__init__.py``; the tests hold this
copy equal to ``sdtpu.diffusion.schedule.get_sigmas``.
"""
from __future__ import annotations

import gzip
import json
import math
from importlib import resources

import numpy as np

TIMESTEPS = 1000

AYS_NOISE_LEVELS = {
    # Align-Your-Steps published optimal levels (NVIDIA research page)
    "sd1": [14.6146412293, 6.4745760956, 3.8636745985, 2.6946151520, 1.8841921177,
            1.3943805092, 0.9642583904, 0.6523686016, 0.3977456272, 0.1515232662,
            0.0291671582],
    "sdxl": [14.6146412293, 6.3184485287, 3.7681790315, 2.1811480769, 1.3405244945,
             0.8620721141, 0.5550693289, 0.3798540708, 0.2332364134, 0.1114188177,
             0.0291671582],
    "svd": [700.00, 54.5, 15.886, 7.977, 4.248, 1.789, 0.981, 0.403, 0.173, 0.034,
            0.002],
}


def log_linear_interpolation(sigma_in: np.ndarray, new_len: int) -> np.ndarray:
    """Stretch a descending sigma table to new_len points in log space."""
    s = np.asarray(sigma_in, dtype=np.float64)
    y = np.log(s[::-1])
    x = np.linspace(0.0, 1.0, len(s))
    new_x = np.linspace(0.0, 1.0, new_len)
    new_y = np.interp(new_x, x, y)
    return np.exp(new_y[::-1]).astype(np.float32)


def schedule_discrete(n, sigma_min, sigma_max, t_to_sigma):
    t_max = TIMESTEPS - 1
    if n == 1:
        return np.array([t_to_sigma(float(t_max)), 0.0], dtype=np.float32)
    ts = t_max - (t_max / (n - 1)) * np.arange(n, dtype=np.float32)
    sig = np.asarray(t_to_sigma(ts), dtype=np.float32)
    return np.append(sig, np.float32(0.0))


def schedule_exponential(n, sigma_min, sigma_max, t_to_sigma):
    lmin, lmax = math.log(sigma_min), math.log(sigma_max)
    step = (lmax - lmin) / (n - 1)
    sig = np.exp(lmax - step * np.arange(n, dtype=np.float32))
    return np.append(sig.astype(np.float32), np.float32(0.0))


def schedule_karras(n, sigma_min, sigma_max, t_to_sigma, rho: float = 7.0):
    sigma_min = max(sigma_min, 1e-6)
    min_r, max_r = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    i = np.arange(n, dtype=np.float32)
    sig = (max_r + i / (n - 1) * (min_r - max_r)) ** rho
    return np.append(sig.astype(np.float32), np.float32(0.0))


def schedule_sgm_uniform(n, sigma_min, sigma_max, t_to_sigma):
    ts = np.linspace(TIMESTEPS - 1, 0, n + 1, dtype=np.float32)[:n]
    sig = np.asarray(t_to_sigma(ts), dtype=np.float32)
    return np.append(sig, np.float32(0.0))


def schedule_simple(n, sigma_min, sigma_max, t_to_sigma):
    step_factor = TIMESTEPS / n
    idx = np.maximum(TIMESTEPS - 1 - (np.arange(n) * step_factor).astype(np.int64), 0)
    sig = np.asarray(t_to_sigma(idx.astype(np.float32)), dtype=np.float32)
    return np.append(sig, np.float32(0.0))


def schedule_lcm(n, sigma_min, sigma_max, t_to_sigma):
    original_steps = 50
    k = TIMESTEPS // original_steps
    idx = (np.arange(n) * original_steps) // n
    timesteps = (original_steps - idx) * k - 1
    sig = np.asarray(t_to_sigma(timesteps.astype(np.float32)), dtype=np.float32)
    return np.append(sig, np.float32(0.0))


def schedule_kl_optimal(n, sigma_min, sigma_max, t_to_sigma):
    if n == 1:
        return np.array([sigma_max, 0.0], dtype=np.float32)
    sigma_min = max(sigma_min, 1e-6)
    a_min, a_max = math.atan(sigma_min), math.atan(sigma_max)
    t = np.arange(n, dtype=np.float32) / (n - 1)
    sig = np.tan(t * a_min + (1 - t) * a_max)
    return np.append(sig.astype(np.float32), np.float32(0.0))


def schedule_smoothstep(n, sigma_min, sigma_max, t_to_sigma):
    t_max = TIMESTEPS - 1
    if n == 1:
        return np.array([t_to_sigma(float(t_max)), 0.0], dtype=np.float32)
    u = 1.0 - np.arange(n, dtype=np.float32) / n
    ss = u * u * (3.0 - 2.0 * u)
    sig = np.asarray(t_to_sigma(np.round(ss * t_max)), dtype=np.float32)
    return np.append(sig, np.float32(0.0))


def schedule_ays(n, sigma_min, sigma_max, t_to_sigma, version: str = "sd1"):
    key = "sd1"
    if "xl" in version:
        key = "sdxl"
    elif version == "svd":
        key = "svd"
    levels = np.asarray(AYS_NOISE_LEVELS[key], dtype=np.float32)
    out = levels if len(levels) == n + 1 else log_linear_interpolation(levels, n + 1)
    out = out.copy()
    out[n] = 0.0
    return out


_GITS_CACHE = None


def _gits_tables():
    global _GITS_CACHE
    if _GITS_CACHE is None:
        ref = resources.files("sdtpu_torch.diffusion").joinpath("data/gits_noise.json.gz")
        with ref.open("rb") as f:
            _GITS_CACHE = json.loads(gzip.decompress(f.read()))
    return _GITS_CACHE


def schedule_gits(n, sigma_min, sigma_max, t_to_sigma, coeff: float = 1.20):
    data = _gits_tables()
    coeff = round(coeff * 20.0) / 20.0
    idx = int(round((coeff - 0.80) / 0.05))
    idx = max(0, min(idx, len(data["order"]) - 1))
    rows = data["tables"][data["order"][idx]]
    if n <= 20 and n - 2 < len(rows):
        sig = np.asarray(rows[n - 2], dtype=np.float32)
        if len(sig) != n + 1:
            sig = log_linear_interpolation(sig, n + 1)
    else:
        sig = log_linear_interpolation(np.asarray(rows[-1], dtype=np.float32), n + 1)
    sig = sig.copy()
    sig[n] = 0.0
    return sig


def schedule_bong_tangent(n, sigma_min, sigma_max, t_to_sigma):
    def stage(steps, slope, pivot, start, end):
        if steps <= 0:
            return np.zeros((0,), dtype=np.float32)
        x = np.arange(steps, dtype=np.float32)
        v = ((2.0 / math.pi) * np.arctan(-slope * (x - pivot)) + 1.0) * 0.5
        smax = ((2.0 / math.pi) * math.atan(-slope * (0.0 - pivot)) + 1.0) * 0.5
        smin = ((2.0 / math.pi) * math.atan(-slope * ((steps - 1) - pivot)) + 1.0) * 0.5
        srange = smax - smin
        if abs(srange) < 1e-8:
            if steps == 1:
                return np.array([start], dtype=np.float32)
            t = x / (steps - 1)
            return (start + (end - start) * t).astype(np.float32)
        return (((v - smin) / srange) * (start - end) + end).astype(np.float32)

    start, end = sigma_max, sigma_min
    middle = sigma_min + (sigma_max - sigma_min) * 0.5
    pivot_1 = pivot_2 = 0.6
    slope_1 = slope_2 = 0.2
    steps = n + 2
    midpoint = int((steps * pivot_1 + steps * pivot_2) * 0.5)
    pivot_1_i = int(steps * pivot_1)
    pivot_2_i = int(steps * pivot_2)
    slope_scale = steps / 40.0
    slope_1 /= slope_scale
    slope_2 /= slope_scale
    stage_2_len = steps - midpoint
    stage_1_len = steps - stage_2_len
    s1 = stage(stage_1_len, slope_1, float(pivot_1_i), start, middle)
    s2 = stage(stage_2_len, slope_2, float(pivot_2_i - stage_1_len), middle, end)
    if len(s1):
        s1 = s1[:-1]
    out = np.concatenate([s1, s2])
    if len(out) < n + 1:
        out = np.concatenate([out, np.full(n + 1 - len(out), end, dtype=np.float32)])
    out = out[: n + 1].copy()
    out[n] = 0.0
    return out.astype(np.float32)


def _incbeta(x, a, b):
    """Regularized incomplete beta via Lentz continued fraction (reference
    BetaScheduler::incbeta, itself the classic NR algorithm)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    lbeta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    tiny = 1e-30
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < tiny:
        d = tiny
    d = 1.0 / d
    h = d
    for m in range(1, 201):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < tiny:
            d = tiny
        c = 1.0 + aa / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < tiny:
            d = tiny
        c = 1.0 + aa / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 3.0e-7:
            break
    return math.exp(a * math.log(x) + b * math.log(1.0 - x) - lbeta) / a * h


def _beta_cdf(x, a, b):
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    if x < (a + 1.0) / (a + b + 2.0):
        return _incbeta(x, a, b)
    return 1.0 - _incbeta(1.0 - x, b, a)


def _beta_ppf(u, a, b, max_iter=30):
    lbeta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    x = 0.5
    for _ in range(max_iter):
        f = _beta_cdf(x, a, b) - u
        if abs(f) < 1e-10:
            break
        df = math.exp((a - 1.0) * math.log(x) + (b - 1.0) * math.log(1.0 - x) - lbeta)
        x -= f / df
        x = min(max(x, 1e-10), 1.0 - 1e-10)
    return x


def schedule_beta(n, sigma_min, sigma_max, t_to_sigma, alpha=0.6, beta=0.6):
    t_max = TIMESTEPS - 1
    if n == 1:
        return np.array([t_to_sigma(float(t_max)), 0.0], dtype=np.float32)
    out = []
    last_t = -1
    for i in range(n):
        u = 1.0 - i / n
        t = int(round(_beta_ppf(u, alpha, beta) * t_max))
        if t != last_t:
            out.append(float(t_to_sigma(np.float32(t))))
            last_t = t
    out.append(0.0)
    return np.asarray(out, dtype=np.float32)


def _ndtri(p: float) -> float:
    """Acklam's inverse normal CDF (reference LogitNormalScheduler::ndtri)."""
    if p <= 0.0:
        return -math.inf
    if p >= 1.0:
        return math.inf
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01, 1.0]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00, 1.0]
    p_low = 0.02425
    if p < p_low:
        q = math.sqrt(-2.0 * math.log(p))
        num = c[0]
        for v in c[1:]:
            num = num * q + v
        den = d[0]
        for v in d[1:]:
            den = den * q + v
        return num / den
    if p > 1.0 - p_low:
        q = math.sqrt(-2.0 * math.log(1.0 - p))
        num = c[0]
        for v in c[1:]:
            num = num * q + v
        den = d[0]
        for v in d[1:]:
            den = den * q + v
        return -num / den
    q = p - 0.5
    r = q * q
    num = a[0]
    for v in a[1:]:
        num = num * r + v
    num *= q
    den = b[0]
    for v in b[1:]:
        den = den * r + v
    return num / den


def schedule_logit_normal(
    n, sigma_min, sigma_max, t_to_sigma, mean=0.0, std=1.75,
    logsnr_min=-15.0, logsnr_max=18.0, image_seq_len=0, resolution_aware=True,
):
    known_seq_len = (512 * 512) / (16 * 16)
    if image_seq_len > 0 and resolution_aware:
        mean = mean + 0.5 * math.log(image_seq_len / known_seq_len)
    hi = 1.0 / (1.0 + math.exp(-0.5 * logsnr_max))
    lo = 1.0 / (1.0 + math.exp(-0.5 * logsnr_min))
    out = []
    for i in range(n + 1):
        t = i / n
        z = -_ndtri(t)
        y = mean + std * z
        ts = 1.0 / (1.0 + math.exp(-y)) if math.isfinite(y) else (1.0 if y > 0 else 0.0)
        ts = min(max(ts, lo), hi)
        out.append(ts)
    out[n] = 0.0
    return np.asarray(out, dtype=np.float32)


def flux_time_shift_np(mu, sigma, t):
    return math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma)


def schedule_flux(n, sigma_min, sigma_max, t_to_sigma, image_seq_len=0,
                  base_shift=0.5, max_shift=1.15):
    m = (max_shift - base_shift) / (4096.0 - 256.0)
    b = base_shift - m * 256.0
    mu = image_seq_len * m + b
    out = []
    for i in range(n + 1):
        t = 1.0 - i / n
        out.append(0.0 if t <= 0 else flux_time_shift_np(mu, 1.0, t))
    out[n] = 0.0
    return np.asarray(out, dtype=np.float32)


def schedule_flux2(n, sigma_min, sigma_max, t_to_sigma, image_seq_len=0):
    a1, b1 = 8.73809524e-05, 1.89833333
    a2, b2 = 0.00016927, 0.45666666
    if image_seq_len > 4300:
        mu = a2 * image_seq_len + b2
    else:
        m_200 = a2 * image_seq_len + b2
        m_10 = a1 * image_seq_len + b1
        a = (m_200 - m_10) / 190.0
        b = m_200 - 200.0 * a
        mu = a * n + b
    out = []
    for i in range(n + 1):
        t = 1.0 - i / n
        if t <= 0:
            out.append(0.0)
        elif t >= 1:
            out.append(1.0)
        else:
            out.append(flux_time_shift_np(mu, 1.0, t))
    out[n] = 0.0
    return np.asarray(out, dtype=np.float32)


def sefi_dual_schedule(n, alpha=1.0, delta_t=0.1):
    """SeFi dual flow schedule → (sem_sigmas, tex_sigmas), each n+1 values
    (reference SefiFlowDenoiser::get_sigmas, denoiser.hpp:1302-1350): the
    semantic channels run delta_t ahead of the texture channels on a
    1000-step quantized grid."""
    T = 1000
    sem, tex = [], []
    for i in range(n + 1):
        u = i / n
        if alpha != 1.0:
            u = (alpha * u) / (1.0 + (alpha - 1.0) * u)
        u_sem_raw = u * (1.0 + delta_t)
        u_sem = min(u_sem_raw, 1.0)
        u_tex = max(0.0, min(u_sem_raw - delta_t, 1.0))
        idx_sem = min(T - 1, max(0, int(u_sem * (T - 1))))
        idx_tex = min(T - 1, max(0, int(u_tex * (T - 1))))
        sem.append((T - idx_sem) / T)
        tex.append((T - idx_tex) / T)
    return (np.asarray(sem, dtype=np.float32),
            np.asarray(tex, dtype=np.float32))


def schedule_sefi(n, sigma_min, sigma_max, t_to_sigma, alpha=1.0, delta_t=0.1):
    return sefi_dual_schedule(n, alpha, delta_t)[1]


def schedule_ltx2(n, sigma_min, sigma_max, t_to_sigma, token_count=4096,
                  max_shift=2.05, base_shift=0.95, stretch=True, terminal=0.1):
    m = (max_shift - base_shift) / (4096.0 - 1024.0)
    b = base_shift - m * 1024.0
    sigma_shift = token_count * m + b
    exp_shift = math.exp(sigma_shift)
    target_terminal = min(max(terminal, 0.0), 0.99)
    sig = []
    for i in range(n + 1):
        s = 1.0 - i / n
        if s != 0.0:
            s = exp_shift / (exp_shift + (1.0 / s - 1.0))
        sig.append(s)
    if stretch and len(sig) > 2:
        one_minus_last = 1.0 - sig[n - 1]
        scale = one_minus_last / (1.0 - target_terminal)
        if scale > 1e-8:
            for i in range(n):
                sig[i] = 1.0 - (1.0 - sig[i]) / scale
    sig[n] = 0.0
    return np.asarray(sig, dtype=np.float32)


SCHEDULERS = {
    "discrete": schedule_discrete,
    "karras": schedule_karras,
    "exponential": schedule_exponential,
    "ays": schedule_ays,
    "gits": schedule_gits,
    "sgm_uniform": schedule_sgm_uniform,
    "simple": schedule_simple,
    "smoothstep": schedule_smoothstep,
    "bong_tangent": schedule_bong_tangent,
    "kl_optimal": schedule_kl_optimal,
    "lcm": schedule_lcm,
    "beta": schedule_beta,
    "logit_normal": schedule_logit_normal,
    "flux": schedule_flux,
    "flux2": schedule_flux2,
    "sefi": schedule_sefi,
    "ltx2": schedule_ltx2,
}


def get_sigmas(
    denoiser,
    n: int,
    scheduler: str = "discrete",
    version: str = "sd1",
    image_seq_len: int = 0,
    **kwargs,
) -> np.ndarray:
    """n sampling steps → n+1 descending sigmas ending in 0."""
    fn = SCHEDULERS.get(scheduler)
    if fn is None:
        raise ValueError(f"unknown scheduler {scheduler!r}; choose from {sorted(SCHEDULERS)}")
    extra = {}
    if scheduler == "ays":
        extra["version"] = version
    if scheduler in ("flux", "flux2"):
        extra["image_seq_len"] = image_seq_len
    if scheduler == "logit_normal":
        extra["image_seq_len"] = image_seq_len
    if scheduler == "ltx2":
        extra["token_count"] = image_seq_len or 4096
    extra.update(kwargs)
    return fn(n, denoiser.sigma_min(), denoiser.sigma_max(), denoiser.t_to_sigma, **extra)
