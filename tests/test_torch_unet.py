"""The port's SD1.x UNet, CompVis denoiser, discrete schedule and samplers
against ``sdtpu``.

The UNet runs at the JAX factory's small SD1 config on weights from
``sdtpu.models.unet.init_unet_params``, bridged with ``from_jax_params``;
float32 on both sides.  Tolerance: 1e-4 relative L2 — float32 results of a
UNet of convolutions, matmuls and softmaxes whose sums run in another order
(MKL / oneDNN against XLA), observed at ~3e-6.  The denoiser's tables and
the per-step arrays are host numpy in both packages: equal.  The step
arithmetic runs in float32 on both sides, in another order of operations
(the JAX steps' ``where`` selects are the port's branches): rtol 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.diffusion import denoiser as jden
from sdtpu.diffusion import samplers as jsamplers
from sdtpu.diffusion.schedule import get_sigmas as jget_sigmas
from sdtpu.factory import unet_config_for
from sdtpu.models import unet as ju
from sdtpu.models import vae as jvae
from sdtpu_torch.config import SDVersion
from sdtpu_torch.diffusion import denoiser as tden
from sdtpu_torch.diffusion import samplers as tsamplers
from sdtpu_torch.diffusion.schedule import get_sigmas
from sdtpu_torch import factory as tfactory
from sdtpu_torch.factory import create_pipeline, sd1_configs
from sdtpu_torch.models import unet as tu
from sdtpu_torch.models import vae as tvae
from sdtpu_torch.weights import from_jax_params

JSMALL = unet_config_for(jconfig.SDVersion.SD1, small=True)
TSMALL, _, _ = sd1_configs(small=True)
NEW_METHODS = ("dpm++2s_a", "dpm++2m", "ipndm")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def unet_pair():
    jp = ju.init_unet_params(JSMALL, seed=0)
    return jp, from_jax_params(jp, device="cpu")


@pytest.mark.parametrize("port,ref", [(tu.SD1_UNET_CONFIG, ju.SD1_UNET_CONFIG), (TSMALL, JSMALL),
                                      (tvae.SD_VAE_CONFIG, jvae.SD_VAE_CONFIG)])
def test_configs_match(port, ref):
    """The port's fields, the rest of the JAX config at its defaults (the
    port's UNet config has no fields of the unported families)."""
    assert type(ref)(**dataclasses.asdict(port)) == ref


@pytest.mark.parametrize("port,ref", [(tu.SD1_UNET_CONFIG, ju.SD1_UNET_CONFIG), (TSMALL, JSMALL)],
                         ids=["full", "small"])
def test_param_specs_match_unet_param_shapes(port, ref):
    """Names, shapes and inits of ``param_specs`` are ``unet_param_shapes``'s."""
    want = {k: (shape, {"w": "normal", "g": "ones", "b": "zeros"}[kind])
            for k, (kind, shape) in ju.unet_param_shapes(ref).items()}
    assert tu.param_specs(port) == want


def test_sd_vae_specs_match_jax_init():
    """``SD_VAE_CONFIG`` goes through ``param_specs`` unchanged: the decoder
    half of the JAX init at the small SD VAE."""
    _, _, vae_cfg = sd1_configs(small=True)
    jp = jvae.init_vae_params(jvae.VAEConfig(**dataclasses.asdict(vae_cfg)), seed=0)
    want = {k: tuple(v.shape) for k, v in jp.items() if not k.startswith(("encoder.", "quant_conv."))}
    assert {k: s for k, (s, _) in tvae.param_specs(vae_cfg).items()} == want


def test_from_jax_params_bridges_the_unet_tree(unet_pair):
    jp, tp = unet_pair
    specs = tu.param_specs(TSMALL)
    assert set(tp) == set(specs) == set(jp)
    for k, (shape, _) in specs.items():
        assert tuple(tp[k].shape) == shape and tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("t,ctx_len", [((999.0, 10.5), 77), ((411.25, 0.0), 154)])
def test_unet_forward_matches_jax(unet_pair, t, ctx_len):
    jp, tp = unet_pair
    rng = np.random.default_rng(ctx_len)
    x = rng.standard_normal((2, 16, 8, 4), dtype=np.float32)
    ts = np.asarray(t, np.float32)
    ctx = rng.standard_normal((2, ctx_len, JSMALL.context_dim), dtype=np.float32)
    want = ju.unet_forward(jp, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), cfg=JSMALL)
    got = tu.unet_forward(tp, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                          cfg=TSMALL)
    assert got.shape == want.shape == (2, 16, 8, 4)
    assert _rel(got.numpy(), want) <= 1e-4


def test_attention_calls_count_the_forward(monkeypatch):
    """A full-width SD1.5 forward at 512² under CFG, on the meta device (shapes
    only), makes ``chip_smoke.UNET_ATTENTION_CALLS`` attention calls per head
    dim, the counts the card check holds each path's flash launches to."""
    import chip_smoke

    seen = {}

    def counting(q, k, v, *a, **kw):
        seen[q.shape[-1]] = seen.get(q.shape[-1], 0) + 1
        return torch.empty_like(q)

    monkeypatch.setattr(tu, "attention", counting)
    cfg = tu.SD1_UNET_CONFIG
    p = {k: torch.empty(shape, device="meta") for k, (shape, _) in tu.param_specs(cfg).items()}
    out = tu.unet_forward(p, torch.empty((2, 64, 64, 4), device="meta"),
                          torch.empty((2,), device="meta"),
                          torch.empty((2, 77, cfg.context_dim), device="meta"), cfg=cfg)
    assert out.shape == (2, 64, 64, 4)
    assert seen == chip_smoke.UNET_ATTENTION_CALLS == {40: 10, 80: 10, 160: 12}


def test_unported_unet_variants_raise_by_name():
    """SVD stays refused by name; the tiny UNets, refused before the port
    had them, build (small: the JAX factory's small SD1 UNet) and take
    their full configs from ``unet_config_for`` as the JAX factory does."""
    with pytest.raises(NotImplementedError, match=SDVersion.SVD.name):
        create_pipeline(SDVersion.SVD, small=True, device="cpu")
    for version in (SDVersion.SD2_TINY_UNET, SDVersion.SD1_TINY_UNET):
        assert create_pipeline(version, small=True, device="cpu").version == version
        full = tfactory.unet_config_for(version)
        assert full.tiny_unet and ju.UNetConfig(**dataclasses.asdict(full)) == unet_config_for(
            getattr(jconfig.SDVersion, version.name))
    with pytest.raises(ValueError, match="label embedding"):
        tu.unet_forward({}, torch.zeros((1, 8, 8, 4)), torch.zeros(1), torch.zeros((1, 77, 64)),
                        y=torch.zeros((1, 8)), cfg=TSMALL)


# ------------------------------------------------------------- denoiser


def test_compvis_tables_and_scalings_match():
    j, t = jden.CompVisDenoiser(), tden.CompVisDenoiser()
    np.testing.assert_array_equal(tden.compvis_alphas_cumprod(), jden.compvis_alphas_cumprod())
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.log_sigmas, j.log_sigmas)
    assert (t.sigma_min(), t.sigma_max()) == (j.sigma_min(), j.sigma_max())
    ts = np.asarray([0.0, 0.5, 17.25, 500.0, 998.9, 999.0], np.float32)
    np.testing.assert_array_equal(t.t_to_sigma(ts), j.t_to_sigma(ts))
    x = np.ones((2, 3), np.float32)
    np.testing.assert_array_equal(t.noise_scaling(np.float32(2.5), x, 0 * x),
                                  j.noise_scaling(np.float32(2.5), x, 0 * x))


@pytest.mark.parametrize("sigma", [0.0292, 0.1, 0.731, 1.0, 5.5, 14.6146])
def test_compvis_device_forms_match_jnp(sigma):
    """``sigma_to_t_torch`` / ``get_scalings_torch`` (the model function's
    on-device forms) against ``sigma_to_t_jnp`` / ``get_scalings_jnp``."""
    j, t = jden.CompVisDenoiser(), tden.CompVisDenoiser()
    st = torch.tensor(sigma, dtype=torch.float32)
    sj = jnp.float32(sigma)
    np.testing.assert_allclose(t.sigma_to_t_torch(st).item(), float(j.sigma_to_t_jnp(sj)),
                               rtol=1e-6, atol=1e-4)
    _, c_out, c_in = t.get_scalings_torch(st)
    _, jc_out, jc_in = j.get_scalings_jnp(sj)
    assert c_out.item() == float(jc_out)
    np.testing.assert_allclose(c_in.item(), float(jc_in), rtol=1e-7)


@pytest.mark.parametrize("steps", [1, 3, 4, 20])
def test_discrete_sigmas_match_for_sd1(steps):
    want = jget_sigmas(jden.CompVisDenoiser(), steps, scheduler="discrete", version="sd1")
    got = get_sigmas(tden.CompVisDenoiser(), steps, scheduler="discrete")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- samplers


# the method's own per-step arrays, beside i, sigma and sigma_next
STEP_ARRAYS = {"euler_a": ("sigma_down", "sigma_up", "alpha_scale"),
               "dpm++2s_a": ("sigma_down", "sigma_up"), "dpm++2m": ("a", "b_first", "b_multi", "r"),
               "ipndm": ()}


def _sigmas(steps=4):
    return jget_sigmas(jden.CompVisDenoiser(), steps, scheduler="discrete")


@pytest.mark.parametrize("method", ("euler_a",) + NEW_METHODS)
@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("steps", [3, 20])
def test_per_step_arrays_match_build_sampler(method, eta, steps):
    """Every per-step array a ported step reads equals the JAX
    ``build_sampler``'s."""
    sig = _sigmas(steps)
    _, _, want = jsamplers.build_sampler(lambda x, s, i: (x, x), jnp.zeros((1, 2)), sig,
                                         method=method, eta=eta)
    got = tsamplers.per_step_arrays(sig, method, eta)
    assert {"i", "sigma", "sigma_next", *STEP_ARRAYS[method]} <= set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("method", ("euler", "euler_a") + NEW_METHODS)
@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_sampler_steps_match_jax(method, eta):
    """The whole loop on a model of a few float32 operations, with the same
    noise stack: the port's steps against the JAX scan."""
    sig = _sigmas(5)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((2, 4, 4, 3), dtype=np.float32) * float(sig[0])
    w = rng.standard_normal((4, 4, 3), dtype=np.float32) * 0.1
    noises = rng.standard_normal((5,) + x0.shape, dtype=np.float32)
    needs = tsamplers.method_needs_noise(method, eta)

    def jmodel(x, sigma, i):
        den = x / (1.0 + sigma) + jnp.asarray(w) * jnp.tanh(sigma)
        return den, den

    def tmodel(x, sigma, i):
        den = x / (1.0 + sigma) + torch.from_numpy(w) * torch.tanh(sigma)
        return den, den

    want = jsamplers.sample(jmodel, jnp.asarray(x0), sig, method=method,
                            noises=jnp.asarray(noises) if needs else None, eta=eta)
    got = tsamplers.sample(tmodel, torch.from_numpy(x0), sig, method=method,
                           noises=noises if needs else None, eta=eta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unported_samplers_raise_by_name():
    """SeFi's dual-schedule Euler (its model is not ported) and a name
    outside the JAX package's raise by name from the loop and the per-step
    arrays; since the sampling slice every other JAX method runs."""
    for method in ("sefi_euler", "dpm++_2m"):
        with pytest.raises(NotImplementedError, match=method.replace("+", r"\+")):
            tsamplers.sample(lambda x, s, i: (x, x), torch.zeros(1), _sigmas(2), method=method)
        with pytest.raises(NotImplementedError, match=method.replace("+", r"\+")):
            tsamplers.per_step_arrays(np.asarray([1.0, 0.5, 0.0], np.float32), method, 1.0,
                                      is_flow=True)
    assert {"dpm2", "dpm++2m_v2", "ipndm_v", "tcd"} <= set(tsamplers.PORTED_METHODS)
