"""The slice as a whole for SD2.x: the port's v-prediction denoiser, OpenCLIP-H
configuration, SD2 conditioner, ``heun`` sampler, SD2 UNet layout and small
SD2 pipeline against ``sdtpu`` and its ``sd2_heun`` golden latents.

Weights come from ``sdtpu.factory.create_pipeline(SDVersion.SD2, small=True,
seed=0)`` (the small SD1 UNet and the small CLIP-L, with ``is_sd2``: pad id
0, clip skip 2 by default) through ``from_jax_params``; the noise comes
from the port's own ``sdtpu_torch.rng``.  Latents are held at the goldens'
rtol = atol = 5e-4; the conditioning (float32 on both sides) at rtol 1e-4 /
atol 1e-5, as the SD1 conditioner's; a UNet forward at 1e-4 relative L2, as
the SD1 UNet's; the denoiser's host scalings are equal, its on-device forms
within float32 rounding; the samplers' loops at rtol 1e-5, as the other
ported samplers'.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.diffusion import denoiser as jden
from sdtpu.diffusion import samplers as jsamplers
from sdtpu.diffusion.schedule import get_sigmas as jget_sigmas
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu.factory import unet_config_for as jax_unet_config_for
from sdtpu.models import clip as jclip
from sdtpu.models import unet as ju
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.diffusion import denoiser as tden
from sdtpu_torch.diffusion import samplers as tsamplers
from sdtpu_torch.factory import create_pipeline, unet_config_for
from sdtpu_torch.io.model_loader import UNET_VERSIONS
from sdtpu_torch.models import clip as tclip
from sdtpu_torch.models import unet as tu
from sdtpu_torch.weights import from_jax_params
from tests.torch_ref import samplers_oracle as oracle

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def pipes():
    """{prediction: (JAX pipeline, port pipeline)} on the same small SD2
    weights, eps and v."""
    out = {}
    for v in (False, True):
        jp = jax_create_pipeline(jconfig.SDVersion.SD2, small=True, seed=0, v_prediction=v)
        params = {"diffusion": from_jax_params(jp.diffusion_params, device="cpu"),
                  "clip_l": from_jax_params(jp.conditioner.params, device="cpu"),
                  "vae": from_jax_params(jp.vae_params, device="cpu")}
        out["v" if v else "eps"] = (jp, create_pipeline(SDVersion.SD2, params=params, small=True,
                                                        v_prediction=v, device="cpu"))
    return out


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=3, cfg_scale=4.0, seed=11)
    base.update(kw)
    return GenerationParams(**base)


def test_reproduces_sd2_heun_golden(pipes):
    """``tests/test_golden_latents.py``'s ``sd2_heun``: the small SD2
    pipeline (eps), 64², 3 heun steps at CFG 4."""
    _, tp = pipes["eps"]
    res = tp.generate(_gp(sample_method="heun"))
    want = np.load(os.path.join(GOLDEN_DIR, "sd2_heun.npz"))["latents"]
    assert res.latents.shape == want.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(res.latents, want, rtol=5e-4, atol=5e-4)
    assert tp.last_timings["steps"] == 3


@pytest.mark.parametrize("pred,kw", [
    ("v", dict(sample_method="heun")),  # the v scalings under CFG, heun's two calls
    ("v", dict(sample_method="euler_a", eta=1.0, batch_count=2, seed=5)),  # per-seed noise
    ("v", dict(sample_method="dpm++2m", cfg_scale=1.0, sample_steps=4)),  # no CFG
    ("eps", dict(sample_method="heun", clip_skip=1, width=96)),  # the final layer, a wide latent
])
def test_sd2_latents_match_jax_pipeline(pipes, pred, kw):
    """``create_pipeline(SD2, small=True, v_prediction=...)`` against the JAX
    pipeline on the same weights and request."""
    jp, tp = pipes[pred]
    gp = _gp(**kw)
    assert isinstance(tp.denoiser, tden.CompVisVDenoiser) == (pred == "v")
    want = jp.generate(jconfig.GenerationParams(**dataclasses.asdict(gp)))
    got = tp.generate(gp)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert got.seeds == want.seeds
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


# ------------------------------------------------------------- denoiser


@pytest.mark.parametrize("sigma", [0.0292, 0.1, 0.731, 1.0, 5.5, 14.6146])
def test_v_denoiser_scalings_match_jax(sigma):
    """``CompVisVDenoiser``'s scalings (``get_scalings_torch``, the port's
    only form) are the JAX host ones (``get_scalings``) and its on-device
    ones (``get_scalings_jnp``) within float32 rounding: c_out = −σ·σ_d /
    √(σ² + σ_d²) is negative."""
    j, t = jden.CompVisVDenoiser(), tden.CompVisVDenoiser()
    assert t.prediction == j.prediction == "v"
    st = torch.tensor(sigma, dtype=torch.float32)
    for got, host, dev in zip(t.get_scalings_torch(st), j.get_scalings(np.float32(sigma)),
                              j.get_scalings_jnp(jnp.float32(sigma))):
        np.testing.assert_allclose(float(got), float(host), rtol=2e-7)
        np.testing.assert_allclose(float(got), float(dev), rtol=2e-7)
    assert float(t.get_scalings_torch(st)[1]) < 0
    np.testing.assert_allclose(t.sigma_to_t_torch(st).item(),
                               float(j.sigma_to_t_jnp(jnp.float32(sigma))), rtol=1e-6, atol=1e-4)
    # the eps form's scalings, which the v form overrides
    for got, want in zip(tden.CompVisDenoiser().get_scalings_torch(st),
                         jden.CompVisDenoiser().get_scalings(np.float32(sigma))):
        np.testing.assert_allclose(float(got), float(want), rtol=2e-7)


# ------------------------------------------------------------- heun


def _toy(x0_shape=(2, 4, 4, 3), seed=3):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(x0_shape, dtype=np.float32)
    w = rng.standard_normal(x0_shape[1:], dtype=np.float32) * 0.1
    return x0, w


@pytest.mark.parametrize("steps", [1, 4, 9])
def test_heun_matches_the_oracle_and_jax(steps):
    """The port's heun against ``tests/torch_ref/samplers_oracle.py``'s
    ``sample_heun`` and the JAX scan, on a model of a few float32 operations;
    it calls the model 2 × steps − 1 times (the last step's second call,
    which the JAX step makes and discards, is not made)."""
    sig = jget_sigmas(jden.CompVisDenoiser(), steps, scheduler="discrete")
    x0, w = _toy()
    x0 = x0 * float(sig[0])
    calls = []

    def tmodel(x, sigma, i):
        calls.append(i)
        den = x / (1.0 + sigma) + torch.from_numpy(w) * torch.tanh(sigma)
        return den, den

    def omodel(x, sigma, i):
        den = x / (1.0 + float(sigma)) + torch.from_numpy(w) * np.tanh(float(sigma))
        return den, den

    def jmodel(x, sigma, i):
        den = x / (1.0 + sigma) + jnp.asarray(w) * jnp.tanh(sigma)
        return den, den

    got = tsamplers.sample(tmodel, torch.from_numpy(x0), sig, method="heun")
    assert len(calls) == 2 * steps - 1
    want_oracle = oracle.sample_heun(omodel, torch.from_numpy(x0), [float(s) for s in sig])
    want_jax = jsamplers.sample(jmodel, jnp.asarray(x0), sig, method="heun")
    np.testing.assert_allclose(got.numpy(), want_oracle.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=1e-5, atol=1e-5)
    assert "heun" in tsamplers.PORTED_METHODS and not tsamplers.method_needs_noise("heun", 1.0)


# ------------------------------------------------------------- conditioner

# an OpenCLIP-H-shaped small text tower: gelu, four layers, 64 wide
SMALL_H = dataclasses.replace(tclip.CLIP_H_CONFIG, hidden_size=64, intermediate_size=128,
                              num_layers=4, num_heads=4)


@pytest.fixture(scope="module")
def clip_h_pair():
    jcfg = jclip.CLIPTextConfig(**dataclasses.asdict(SMALL_H))
    jparams = dict(jclip.init_clip_params(jcfg, 0))
    bias = "text_model.final_layer_norm.bias"  # nonzero, as the SD1 conditioner's test sets it
    jparams[bias] = jnp.asarray(
        np.random.default_rng(1).standard_normal(jparams[bias].shape, dtype=np.float32) * 0.1 + 0.2)
    return jcfg, jparams


@pytest.mark.parametrize("clip_skip", [-1, 1, 2, 3])
def test_sd2_conditioner_matches_jax(pipes, clip_h_pair, clip_skip):
    """``SD1Conditioner(is_sd2=True)``: a weighted prompt over three chunks
    with a BREAK, padded with id 0; clip_skip -1 → 2 (the penultimate
    layer, no final layer norm); 1 the final layer after it; 3 two layers
    down."""
    from sdtpu.conditioning.conditioner import SD1Conditioner as JSD1Conditioner
    from sdtpu_torch.conditioning.conditioner import SD1Conditioner

    jcfg, jparams = clip_h_pair
    tok = pipes["eps"][0].conditioner.tokenizer
    jcond = JSD1Conditioner(tok, jparams, jcfg, is_sd2=True)
    tcond = SD1Conditioner(pipes["eps"][1].conditioner.tokenizer,
                           from_jax_params(jparams, device="cpu"), SMALL_H, is_sd2=True,
                           device="cpu")
    assert tcond.pad_token_id == jcond.pad_token_id == 0
    text = "a (photo:1.3) of a [cat] BREAK on a (red:0.8) sofa, " + "soft light, " * 40
    want = np.asarray(jcond.get_learned_condition(text, clip_skip=clip_skip).c_crossattn)
    got = tcond.get_learned_condition(text, clip_skip=clip_skip).c_crossattn
    assert want.shape[1] >= 3 * 77 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the skip reaches the layers: another skip gives another context
    other = tcond.get_learned_condition(text, clip_skip=2 if clip_skip in (-1, 2) else -1)
    assert not np.allclose(other.c_crossattn.numpy(), want)


# ------------------------------------------------------------- configs, UNet


def test_sd2_configs_match_jax():
    """``SD2_UNET_CONFIG``, the three inpainting configs, ``CLIP_H_CONFIG``
    and ``unet_config_for`` of every ported UNet version, small and full,
    are the JAX package's."""
    for name in ("SD2_UNET_CONFIG", "SD2_INPAINT_UNET_CONFIG", "SD1_INPAINT_UNET_CONFIG",
                 "SDXL_INPAINT_UNET_CONFIG"):
        port, ref = getattr(tu, name), getattr(ju, name)
        assert type(ref)(**dataclasses.asdict(port)) == ref, name
    assert jclip.CLIPTextConfig(**dataclasses.asdict(tclip.CLIP_H_CONFIG)) == jclip.CLIP_H_CONFIG
    for version in UNET_VERSIONS:
        for small in (False, True):
            want = jax_unet_config_for(getattr(jconfig.SDVersion, version.name), small)
            assert type(want)(**dataclasses.asdict(unet_config_for(version, small))) == want


SD2_LIKE = tu.UNetConfig(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
                         attention_resolutions=(1, 2), transformer_depth=(1, 1), context_dim=48,
                         num_heads=None, num_head_channels=16, use_linear_in_transformer=True)


def test_sd2_shaped_unet_forward_matches_jax():
    """SD2's transformer form (linear proj in / out, 16-channel heads here)
    on a small config, against the JAX UNet on the same weights."""
    jcfg = ju.UNetConfig(**dataclasses.asdict(SD2_LIKE))
    jp = ju.init_unet_params(jcfg, seed=4)
    tp = from_jax_params(jp, device="cpu")
    assert set(tp) == set(tu.param_specs(SD2_LIKE))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 8, 4), dtype=np.float32)
    ts = np.asarray([811.0, 3.5], np.float32)
    ctx = rng.standard_normal((2, 77, 48), dtype=np.float32)
    want = ju.unet_forward(jp, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), cfg=jcfg)
    got = tu.unet_forward(tp, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                          cfg=SD2_LIKE)
    assert _rel(got.numpy(), want) <= 1e-4


def test_sd2_attention_calls_count_the_forward(monkeypatch):
    """A full-width SD2.1 forward at 768² under CFG and an OpenCLIP-H prompt
    encode at clip skip 2, on the meta device (shapes only): every attention
    at D 64, ``chip_smoke.SD2_UNET_ATTENTION_CALLS`` a forward (the SD1
    layout's 32: 5, 10 and 20 heads over 9216, 2304 and 576 tokens, the
    middle block's 20 over 144) and ``chip_smoke.SD2_CLIP_ATTENTION_CALLS``
    an encode (22 of CLIP-H's 23 layers)."""
    import chip_smoke

    seen = []

    def counting(q, k, v, *a, **kw):
        seen.append(tuple(q.shape[1:3]) + (k.shape[2], q.shape[-1]))
        return torch.empty_like(q)

    monkeypatch.setattr(tu, "attention", counting)
    cfg = tu.SD2_UNET_CONFIG
    p = {k: torch.empty(shape, device="meta") for k, (shape, _) in tu.param_specs(cfg).items()}
    out = tu.unet_forward(p, torch.empty((2, 96, 96, 4), device="meta"),
                          torch.empty((2,), device="meta"),
                          torch.empty((2, 77, 1024), device="meta"), cfg=cfg)
    assert out.shape == (2, 96, 96, 4)
    assert len(seen) == chip_smoke.SD2_UNET_ATTENTION_CALLS == 32
    assert {s[-1] for s in seen} == {64}
    assert {s[:3] for s in seen} == {(5, 9216, 9216), (5, 9216, 77), (10, 2304, 2304),
                                     (10, 2304, 77), (20, 576, 576), (20, 576, 77),
                                     (20, 144, 144), (20, 144, 77)}
    seen.clear()
    monkeypatch.setattr(tclip, "attention", counting)
    hp = {k: torch.empty(shape, device="meta")
          for k, (shape, _) in tclip.param_specs(tclip.CLIP_H_CONFIG).items()}
    tclip.clip_text_forward(hp, torch.zeros((1, 77), dtype=torch.int64, device="meta"),
                            tclip.CLIP_H_CONFIG, clip_skip=2)
    assert len(seen) == chip_smoke.SD2_CLIP_ATTENTION_CALLS == 22
    assert set(seen) == {(16, 77, 77, 64)}
