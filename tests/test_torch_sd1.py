"""The slice as a whole for SD1.x: the port's small SD1 txt2img pipeline
against the JAX pipeline and its golden latents.

Weights come from ``sdtpu.factory.create_pipeline(SDVersion.SD1, small=True,
seed=0)`` through ``from_jax_params``; the noise comes from the port's own
``sdtpu_torch.rng``.  The golden cases are ``tests/test_golden_latents.py``'s
four SD1 cases (64², 3 steps, cfg 4.0, so the CFG path runs; euler_a and
dpm++2s_a at eta 1, so their noise is drawn), held at its own rtol = atol =
5e-4.  Decoded images may differ by one uint8 level where a float32 pixel
sits on a rounding boundary.  The conditioning is float32 on both sides:
rtol 1e-4 / atol 1e-5, as the FLUX conditioner's.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.factory import create_pipeline
from sdtpu_torch.weights import from_jax_params

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN = {"sd1_euler_a": dict(sample_method="euler_a", eta=1.0),
          "sd1_dpmpp2m": dict(sample_method="dpm++2m"),
          "sd1_dpmpp2sa": dict(sample_method="dpm++2s_a", eta=1.0),
          "sd1_ipndm": dict(sample_method="ipndm")}


@pytest.fixture(scope="module")
def pipes():
    jp = jax_create_pipeline(jconfig.SDVersion.SD1, small=True, seed=0)
    params = {"diffusion": from_jax_params(jp.diffusion_params, device="cpu"),
              "clip_l": from_jax_params(jp.conditioner.params, device="cpu"),
              "vae": from_jax_params(jp.vae_params, device="cpu")}
    return jp, create_pipeline(SDVersion.SD1, params=params, small=True, device="cpu")


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=3, cfg_scale=4.0, seed=11)
    base.update(kw)
    return GenerationParams(**base)


def _jgp(gp):
    return jconfig.GenerationParams(**dataclasses.asdict(gp))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_reproduces_sd1_golden_latents(pipes, name):
    _, tp = pipes
    res = tp.generate(_gp(**GOLDEN[name]))
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["latents"]
    assert res.latents.dtype == np.float32 and res.latents.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(res.latents, want, rtol=5e-4, atol=5e-4)
    assert tp.last_timings["steps"] == 3 and tp.last_t5_ids is None


@pytest.mark.parametrize("kw", [
    dict(sample_method="euler_a"),  # the bench's sampler at eta 0, the CFG path
    dict(sample_method="dpm++2m", cfg_scale=1.0, batch_count=2, seed=5),  # no CFG, two seeds
    dict(sample_method="ipndm", sample_steps=5, width=96, height=64),  # order 4, a wide latent
    dict(sample_method="dpm++2s_a", eta=1.0, batch_count=2, seed=3),  # per-seed noise, CFG
    # a cond of two 77-token chunks against an uncond of one: the last chunk
    # repeated to match, as the reference aligns them
    dict(sample_method="euler", prompt="a red fox " + "in deep snow " * 30),
])
def test_images_match_jax_pipeline(pipes, kw):
    jp, tp = pipes
    gp = _gp(**kw)
    want, got = jp.generate(_jgp(gp)), tp.generate(gp)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert got.images.shape == want.images.shape and got.images.dtype == np.uint8
    assert got.seeds == want.seeds
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


@pytest.mark.parametrize("clip_skip", [-1, 2])
def test_sd1_conditioner_matches_jax(pipes, clip_skip):
    """A weighted prompt over 77 tokens (three chunks, a BREAK): EOS padding,
    the per-chunk weighting, the chunks concatenated; clip_skip -1 → 1.
    The final layer norm gets a nonzero bias on both sides: with the init's
    zero bias a chunk's mean is ~0 and the mean-preserving weight scale
    (original mean / weighted mean) divides by it, in both packages alike."""
    from sdtpu.conditioning.conditioner import SD1Conditioner as JSD1Conditioner
    from sdtpu_torch.conditioning.conditioner import SD1Conditioner

    jp, tp = pipes
    jparams = dict(jp.conditioner.params)
    bias = "text_model.final_layer_norm.bias"
    jparams[bias] = jnp.asarray(
        np.random.default_rng(1).standard_normal(jparams[bias].shape, dtype=np.float32) * 0.1 + 0.2)
    jcond = JSD1Conditioner(jp.conditioner.tokenizer, jparams, jp.conditioner.cfg)
    tcond = SD1Conditioner(tp.conditioner.tokenizer, from_jax_params(jparams, device="cpu"),
                           tp.conditioner.cfg, device="cpu")
    text = "a (photo:1.3) of a [cat] BREAK on a (red:0.8) sofa, " + "soft light, " * 40
    cj = jcond.get_learned_condition(text, clip_skip=clip_skip)
    ct = tcond.get_learned_condition(text, clip_skip=clip_skip)
    want = np.asarray(cj.c_crossattn)
    assert want.shape[1] >= 3 * 77 and ct.c_crossattn.shape == want.shape
    np.testing.assert_allclose(ct.c_crossattn.numpy(), want, rtol=1e-4, atol=1e-5)
    assert ct.c_vector is None and cj.c_vector is None


def test_match_context_repeats_the_last_chunk():
    import sdtpu.pipeline as jpipe
    from sdtpu.conditioning.conditioner import SDCondition as JCond
    from sdtpu_torch.pipeline import _match_context

    rng = np.random.default_rng(0)
    c, u = (rng.standard_normal((1, n, 8), dtype=np.float32) for n in (231, 77))
    wc, wu = jpipe._match_context(JCond(c_crossattn=jnp.asarray(c)), JCond(c_crossattn=jnp.asarray(u)), 2)
    gc, gu = _match_context(torch.from_numpy(c), torch.from_numpy(u), 2)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))


def test_synthesized_small_sd1_pipeline_runs():
    """Random weights drawn by the port itself (no JAX params), at the
    default dtype, float32."""
    tp = create_pipeline(SDVersion.SD1, small=True, seed=3, device="cpu")
    assert tp.compute_dtype == torch.float32 and tp.latent_channels == 4
    assert all(v.dtype == torch.float32 for v in tp.diffusion_params.values())
    res = tp.generate(_gp(sample_steps=2))
    assert res.images.shape == (1, 64, 64, 3) and np.isfinite(res.latents).all()
    assert res.images.std() > 0
