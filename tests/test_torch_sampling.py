"""The sampling layer against ``sdtpu``: all 17 schedules, the Brownian-tree
noise, the 20 runnable sample methods, APG with momentum, Skip-Layer
Guidance on FLUX, SD3 and Wan, the guidance schedule and the five step
caches.

Inputs and noises come from numpy seeds; the pipelines' weights from the
JAX package's small inits through ``from_jax_params``.  Float32 on both
sides.  Tolerances:
  - schedules: exact (host numpy on both sides), or within 1e-7 where a
    value is computed in another order;
  - Brownian noise: exact (the same numpy draws from the same seeds);
  - the sampler loops: rtol = atol = 1e-5 on an analytic model function, as
    the other samplers' loops (the JAX steps run stepwise, the same step
    functions as its scan);
  - the pipelines: the goldens' rtol = atol = 5e-4 on latents, and a step
    cache's skipped-forward count equal to the JAX one's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.diffusion import brownian as jbrownian
from sdtpu.diffusion import denoiser as jden
from sdtpu.diffusion import samplers as jsamplers
from sdtpu.diffusion import schedule as jschedule
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu.rng import create_rng as jcreate_rng
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.diffusion import brownian as tbrownian
from sdtpu_torch.diffusion import denoiser as tden
from sdtpu_torch.diffusion import samplers as tsamplers
from sdtpu_torch.diffusion import schedule as tschedule
from sdtpu_torch.factory import create_pipeline
from sdtpu_torch.rng import create_rng
from sdtpu_torch.weights import from_jax_params

# (name, JAX denoiser, the port's, the version get_sigmas is given)
DENOISERS = [
    ("eps", jden.CompVisDenoiser, tden.CompVisDenoiser, "sd1"),
    ("v", jden.CompVisVDenoiser, tden.CompVisVDenoiser, "sdxl"),
    ("edm_v", jden.EDMVDenoiser, tden.EDMVDenoiser, "svd"),
    ("flow", lambda: jden.DiscreteFlowDenoiser(shift=3.0),
     lambda: tden.DiscreteFlowDenoiser(shift=3.0), "sd3"),
]


def _jgp(gp):
    return jconfig.GenerationParams(**dataclasses.asdict(gp))


# ------------------------------------------------------------- schedules


def test_every_jax_schedule_is_ported():
    assert list(tschedule.SCHEDULERS) == list(jschedule.SCHEDULERS)


@pytest.mark.parametrize("scheduler", list(jschedule.SCHEDULERS))
@pytest.mark.parametrize("den", DENOISERS, ids=[d[0] for d in DENOISERS])
def test_schedule_matches_jax(scheduler, den):
    """Each schedule on each denoiser at 1, 2, 4 and 20 steps, with the
    pipeline's keywords (its version for ``ays``, a token count for the
    flow shifts): the same float32 sigmas, NaNs in the same places, or the
    same exception."""
    _, jcls, tcls, version = den
    for n in (1, 2, 4, 20):
        for seq in (0, 4096) if scheduler in ("flux", "flux2", "logit_normal", "ltx2") else (0,):
            kw = dict(scheduler=scheduler, version=version, image_seq_len=seq)
            try:
                want = jschedule.get_sigmas(jcls(), n, **kw)
            except Exception as e:  # noqa: BLE001 — the port must fail the same way
                with pytest.raises(type(e)):
                    tschedule.get_sigmas(tcls(), n, **kw)
                continue
            got = tschedule.get_sigmas(tcls(), n, **kw)
            assert got.dtype == np.float32 and got.shape == want.shape, (n, seq)
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=0, err_msg=f"n={n} seq={seq}")


def test_schedule_helpers_match_jax():
    levels = np.asarray(jschedule.AYS_NOISE_LEVELS["sdxl"], np.float32)
    for n in (3, 11, 40):
        np.testing.assert_array_equal(tschedule.log_linear_interpolation(levels, n),
                                      jschedule.log_linear_interpolation(levels, n))
        for a in (0.6, 0.6 + n / 100):
            assert tschedule._beta_ppf(1.0 / n, a, 0.6) == jschedule._beta_ppf(1.0 / n, a, 0.6)
    for p in (1e-4, 0.02, 0.3, 0.5, 0.97, 0.99999):
        assert tschedule._ndtri(p) == jschedule._ndtri(p)
    for n, alpha in ((4, 1.0), (9, 1.7)):
        for got, want in zip(tschedule.sefi_dual_schedule(n, alpha),
                             jschedule.sefi_dual_schedule(n, alpha)):
            np.testing.assert_array_equal(got, want)
    assert tschedule._gits_tables() == jschedule._gits_tables()


# ------------------------------------------------------------- Brownian noise


@pytest.mark.parametrize("rng_type", ["cuda", "std_default"])
def test_brownian_step_noise_matches_jax(rng_type):
    """The tree's seed drawn from the sampler stream, then every step's
    increment: the same float32 noise, and the stream left in the same
    state."""
    sig = jschedule.get_sigmas(jden.CompVisDenoiser(), 5, scheduler="karras")
    trng, jrng = create_rng(rng_type, 7), jcreate_rng(rng_type, 7)
    got = tbrownian.brownian_step_noise(trng, (3, 4, 2), sig)
    want = jbrownian.brownian_step_noise(jrng, (3, 4, 2), sig)
    assert got.shape == (5, 3, 4, 2) and not got[-1].any() and got[:-1].std() > 0.5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(trng.randn(4), jrng.randn(4))
    tree = tbrownian.BrownianTreeNoiseSampler((2, 3), 0.03, 14.6, seed=12345)
    jtree = jbrownian.BrownianTreeNoiseSampler((2, 3), 0.03, 14.6, seed=12345)
    np.testing.assert_array_equal(tree(6.0, 2.5), jtree(6.0, 2.5))


# ------------------------------------------------------------- sample methods


def test_runnable_methods_are_the_jax_ones_but_sefi():
    assert set(tsamplers.SAMPLE_METHODS) == set(jsamplers.SAMPLE_METHODS)
    assert set(tsamplers.PORTED_METHODS) == set(jsamplers.SAMPLE_METHODS) - {"sefi_euler"}
    assert tsamplers.NOISY_METHODS == jsamplers.NOISY_METHODS
    with pytest.raises(NotImplementedError, match="sefi_euler"):
        tsamplers.sample(lambda x, s, i: (x, x), torch.zeros(1), np.asarray([1.0, 0.0]),
                         method="sefi_euler")


def _loop_inputs(is_flow: bool, steps: int = 5):
    if is_flow:
        sig = jschedule.get_sigmas(jden.DiscreteFlowDenoiser(shift=3.0), steps)
        assert sig[0] == 1.0  # the flow dpm++2s_a's first-step branch
    else:
        sig = jschedule.get_sigmas(jden.CompVisDenoiser(), steps, scheduler="karras")
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((2, 4, 4, 3), dtype=np.float32) * np.float32(sig[0])
    w = rng.standard_normal((4, 4, 3), dtype=np.float32) * 0.1
    wu = rng.standard_normal((4, 4, 3), dtype=np.float32) * 0.1
    noises = rng.standard_normal((steps,) + x0.shape, dtype=np.float32)
    return sig, x0, w, wu, noises


@pytest.mark.parametrize("method", tsamplers.PORTED_METHODS)
@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("is_flow", [False, True], ids=["eps", "flow"])
def test_sample_method_matches_jax(method, eta, is_flow):
    """The whole loop on an analytic model function whose cond and uncond
    estimates differ (the cfg++ methods read the uncond one), with the same
    noise stack where the method draws noise and ``gamma`` for
    ``euler_ge``: the port's steps against the JAX step functions."""
    sig, x0, w, wu, noises = _loop_inputs(is_flow)
    extra = {"gamma": 1.5} if method == "euler_ge" else None
    scale = (lambda s: 1.0 - s) if is_flow else (lambda s: 1.0 / (1.0 + s))

    def jmodel(x, sigma, i):
        base = x * scale(sigma)
        return base + jnp.asarray(w) * jnp.tanh(sigma), base + jnp.asarray(wu) * sigma

    def tmodel(x, sigma, i):
        base = x * scale(sigma)
        return base + torch.from_numpy(w) * torch.tanh(sigma), base + torch.from_numpy(wu) * sigma

    needs = tsamplers.method_needs_noise(method, eta)
    assert needs == (method == "lcm" or (eta > 0 and method in jsamplers.NOISY_METHODS))
    want = jsamplers.sample_stepwise(jmodel, jnp.asarray(x0), sig, method=method,
                                     noises=jnp.asarray(noises) if needs else None, eta=eta,
                                     is_flow=is_flow, extra_args=extra)
    got = tsamplers.sample(tmodel, torch.from_numpy(x0), sig, method=method,
                           noises=noises if needs else None, eta=eta, is_flow=is_flow,
                           extra_args=extra)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- pipelines


@pytest.fixture(scope="module")
def flux_pipes():
    jp = jax_create_pipeline(jconfig.SDVersion.FLUX, small=True, seed=0)
    params = {"diffusion": from_jax_params(jp.diffusion_params, device="cpu"),
              "clip_l": from_jax_params(jp.conditioner.pl, device="cpu"),
              "t5": from_jax_params(jp.conditioner.pt, device="cpu"),
              "vae": from_jax_params(jp.vae_params, device="cpu")}
    return jp, create_pipeline(SDVersion.FLUX, params=params, small=True, device="cpu")


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=3, cfg_scale=3.0, seed=11, sample_method="euler")
    base.update(kw)
    return GenerationParams(**base)


def test_apg_and_guidance_schedule_match_jax(flux_pipes):
    """APG with momentum, a norm threshold and eta in place of the CFG
    combine, its buffer carried across steps (two forwards a step under
    heun), beside a per-step guidance schedule shorter than the run."""
    jp, tp = flux_pipes
    gp = _gp(sample_method="heun", apg_eta=0.5, apg_momentum=0.4, apg_norm_threshold=6.0,
             extra_sample_args="guidance_schedule=4.0x1+2.0x1")
    got, want = tp.generate(gp), jp.generate(_jgp(gp))
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    plain = tp.generate(dataclasses.replace(gp, apg_eta=1.0, apg_momentum=0.0,
                                            apg_norm_threshold=0.0)).latents
    assert np.abs(got.latents - plain).max() > 1e-3


# each cache's options: sized so that it skips forwards in 8 steps; one runs
# under CFG with APG momentum, whose buffer survives the skipped forwards
CACHES = {
    "easycache": ({"reuse_threshold": 0.5}, {}),
    "ucache": ({"threshold": 0.6}, {}),
    "taylorseer": ({}, dict(cfg_scale=3.0, apg_momentum=0.5)),
    "spectrum": ({"warmup_steps": 2}, {}),
    "cache_dit": ({"max_warmup_steps": 1, "scm_mask": "1,1,0,0,1,0,1,1",
                   "scm_policy_dynamic": False}, {}),
}


@pytest.mark.parametrize("kind", sorted(CACHES))
def test_step_cache_matches_jax(flux_pipes, kind):
    """The same skipped forwards (``last_timings["cache_skipped"]`` against
    the JAX cache's ``steps_skipped``) and latents within 5e-4."""
    from sdtpu.diffusion import stepcache as jstepcache

    jp, tp = flux_pipes
    options, kw = CACHES[kind]
    gp = _gp(**{"sample_steps": 8, "cfg_scale": 1.0, **kw})
    counts = []
    make = jstepcache.make_step_cache

    def spy(*a, **k):
        counts.append(make(*a, **k))
        return counts[-1]

    jstepcache.make_step_cache = spy
    try:
        want = jp.generate(_jgp(gp), step_cache=kind, cache_options=dict(options))
    finally:
        jstepcache.make_step_cache = make
    got = tp.generate(gp, step_cache=kind, cache_options=dict(options))
    assert tp.last_timings["cache_skipped"] == counts[0].steps_skipped > 0
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def sd3_pipes():
    jp = jax_create_pipeline(jconfig.SDVersion.SD3, small=True, seed=0)
    c = jp.conditioner
    params = {"diffusion": from_jax_params(jp.diffusion_params, device="cpu"),
              "clip_l": from_jax_params(c.pl, device="cpu"),
              "clip_g": from_jax_params(c.pg, device="cpu"),
              "t5": from_jax_params(c.pt, device="cpu"),
              "vae": from_jax_params(jp.vae_params, device="cpu")}
    return jp, create_pipeline(SDVersion.SD3, params=params, small=True, device="cpu")


def test_slg_on_sd3_matches_jax(sd3_pipes):
    """The small MMDiT's second joint block skipped in the cond-only
    forward at steps 1 and 2 of 4 (the window 0.25-0.75)."""
    jp, tp = sd3_pipes
    gp = _gp(sample_steps=4, slg_scale=2.5, skip_layers=(1,), slg_start=0.25, slg_end=0.75)
    got, want = tp.generate(gp), jp.generate(_jgp(gp))
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def wan_pipes():
    jp = jax_create_pipeline(jconfig.SDVersion.WAN2, small=True, seed=0)
    params = {"diffusion": from_jax_params(jp.diffusion_params, device="cpu"),
              "t5": from_jax_params(jp.conditioner.pt, device="cpu"),
              "vae": from_jax_params(jp.vae_params, device="cpu")}
    return jp, create_pipeline(SDVersion.WAN2, params=params, small=True, device="cpu")


def test_slg_on_wan_matches_jax(wan_pipes):
    """A video: the small DiT's first block is identity in the cond-only
    forward of step 0 of 2."""
    jp, tp = wan_pipes
    gp = _gp(sample_steps=2, slg_scale=2.0, skip_layers=(0,), slg_start=0.0, slg_end=0.5,
             negative_prompt="")
    got, want = tp.generate_video(gp, frames=5), jp.generate_video(_jgp(gp), frames=5)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    plain = tp.generate_video(dataclasses.replace(gp, slg_scale=0.0), frames=5).latents
    assert np.abs(got.latents - plain).max() > 1e-3


def test_slg_without_skip_layers_warns_and_is_dropped():
    """A model whose forward takes no ``skip_layers`` (the UNets, Z-Image,
    Qwen-Image): SLG warns and the request runs without it, as the JAX
    pipeline does."""
    tp = create_pipeline(SDVersion.SD1, small=True, seed=3, device="cpu")
    gp = _gp(sample_steps=2, slg_scale=2.5)
    with pytest.warns(UserWarning, match="skip_layers"):
        got = tp.generate(gp)
    assert np.array_equal(got.latents, tp.generate(dataclasses.replace(gp, slg_scale=0.0)).latents)
