"""The slice as a whole: the port's small FLUX txt2img pipeline against the
JAX pipeline and its golden latents.

Weights come from ``sdtpu.factory.create_pipeline(SDVersion.FLUX, small=True,
seed=0)`` through ``from_jax_params``; the noise comes from the port's own
``sdtpu_torch.rng``.  Each package gets its own ``SDVersion`` and
``GenerationParams`` (the same fields), and the port runs on the CPU.  The
golden case is ``tests/test_golden_latents.py``'s
``_generate`` (64², 3 Euler steps, cfg 4.0, so the CFG path runs), held at
its own rtol = atol = 5e-4.  Decoded images may differ by one uint8 level
where a float32 pixel sits on a rounding boundary.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.factory import create_pipeline
from sdtpu_torch.weights import from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "flux_euler.npz")


@pytest.fixture(scope="module")
def pipes():
    jp = jax_create_pipeline(jconfig.SDVersion.FLUX, small=True, seed=0)
    params = {"diffusion": from_jax_params(jp.diffusion_params, device="cpu"),
              "clip_l": from_jax_params(jp.conditioner.pl, device="cpu"),
              "t5": from_jax_params(jp.conditioner.pt, device="cpu"),
              "vae": from_jax_params(jp.vae_params, device="cpu")}
    return jp, create_pipeline(SDVersion.FLUX, params=params, small=True, device="cpu")


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=3, cfg_scale=4.0, seed=11, sample_method="euler")
    base.update(kw)
    return GenerationParams(**base)


def _jgp(gp):
    """The same request as the JAX package's GenerationParams."""
    return jconfig.GenerationParams(**dataclasses.asdict(gp))


def test_reproduces_flux_golden_latents(pipes):
    _, tp = pipes
    res = tp.generate(_gp())
    want = np.load(GOLDEN)["latents"]
    assert res.latents.dtype == np.float32
    np.testing.assert_allclose(res.latents, want, rtol=5e-4, atol=5e-4)
    assert set(tp.last_timings) == {"cond", "sample", "decode", "total", "steps"}
    assert tp.last_timings["steps"] == 3


def test_images_match_jax_pipeline(pipes):
    jp, tp = pipes
    gp = _gp()
    want, got = jp.generate(_jgp(gp)), tp.generate(gp)
    assert got.images.shape == want.images.shape == (1, 64, 64, 3)
    assert got.images.dtype == np.uint8 and got.seeds == want.seeds
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


@pytest.mark.parametrize("kw", [
    dict(cfg_scale=1.0, guidance=2.0, seed=5, batch_count=2),  # no CFG; per-seed noise
    dict(sample_steps=2, schedule="flux", width=96, height=64),  # FLUX shifted schedule
])
def test_latents_match_jax_pipeline(pipes, kw):
    jp, tp = pipes
    gp = _gp(**kw)
    want, got = jp.generate(_jgp(gp)), tp.generate(gp)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert got.seeds == want.seeds


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_euler_a_latents_match_jax_pipeline(pipes, eta):
    """euler_a, the default sampler: at eta 0 the deterministic ratio form,
    at eta 1 the ancestral noise drawn after each item's initial noise from
    its own stream; a batch of two, with and without CFG."""
    jp, tp = pipes
    for cfg in (1.0, 3.0):
        gp = _gp(sample_method="euler_a", eta=eta, cfg_scale=cfg, batch_count=2, seed=3)
        want, got = jp.generate(_jgp(gp)), tp.generate(gp)
        np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
        assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


def test_progress_and_cancel_match_jax(pipes):
    """The per-step callbacks of the JAX pipeline: progress(step, steps, x)
    after each step; a cancel stops the loop, and the latents it reached are
    decoded."""
    jp, tp = pipes
    gp = _gp(cfg_scale=1.0, sample_steps=3)
    seen = {"jax": [], "port": []}
    for side, pipe, req in (("jax", jp, _jgp(gp)), ("port", tp, gp)):
        pipe.generate(req, progress_callback=lambda i, n, x, s=side: seen[s].append((i, n)))
    assert seen["port"] == seen["jax"] == [(1, 3), (2, 3), (3, 3)]
    def canceller():
        calls = []

        def cancel():  # stop after the second step
            calls.append(1)
            return len(calls) > 1

        return cancel, calls

    jcancel, jcalls = canceller()
    want = jp.generate(_jgp(gp), cancel_check=jcancel)
    cancel, calls = canceller()
    got = tp.generate(gp, cancel_check=cancel)
    assert len(calls) == len(jcalls) == 2
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)


def test_tiled_decode_matches_jax_pipeline(pipes):
    jp, tp = pipes
    gp = _gp(width=128, height=96, sample_steps=1)
    jp.set_vae_tiling(True, tile_size=8, overlap=2)
    tp.set_vae_tiling(True, tile_size=8, overlap=2)
    try:
        want, got = jp.generate(_jgp(gp)), tp.generate(gp)
    finally:
        jp.set_vae_tiling(False)
        tp.set_vae_tiling(False)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


def _tiny_t5_tokenizer(cls):
    pieces = ["<pad>", "</s>", "<unk>", "\u2581", "\u2581a", "\u2581red", "\u2581fox", "\u2581in",
              "\u2581snow"] + list("abcdefghijklmnopqrstuvwxyz")
    return cls([(p, -float(i)) for i, p in enumerate(pieces)])


@pytest.mark.parametrize("t5_tokenizer", [None, "tiny"])
def test_conditioning_matches_jax(pipes, t5_tokenizer):
    """CLIP pooled vector and T5 tokens, each package with its own T5
    tokenizer on the same vocab; without a T5 tokenizer the T5 ids are
    zeros, as in the bench."""
    from sdtpu.tokenizers.t5 import T5UnigramTokenizer as JT5
    from sdtpu_torch.tokenizers.t5 import T5UnigramTokenizer

    jp, tp = pipes
    jp.conditioner.t5_tokenizer = _tiny_t5_tokenizer(JT5) if t5_tokenizer else None
    tp.conditioner.t5_tokenizer = _tiny_t5_tokenizer(T5UnigramTokenizer) if t5_tokenizer else None
    try:
        cj = jp.conditioner.get_learned_condition("a (red:1.3) fox BREAK in snow")
        ct = tp.conditioner.get_learned_condition("a (red:1.3) fox BREAK in snow")
    finally:
        jp.conditioner.t5_tokenizer = tp.conditioner.t5_tokenizer = None
    np.testing.assert_allclose(ct.c_crossattn.numpy(), np.asarray(cj.c_crossattn),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ct.c_vector.numpy(), np.asarray(cj.c_vector), rtol=1e-4, atol=1e-5)


def test_token_weighting_matches_jax():
    import jax.numpy as jnp

    from sdtpu.conditioning import conditioner as jc
    from sdtpu.tokenizers.clip import CLIPTokenizer as JCLIPTokenizer
    from sdtpu_torch.conditioning import conditioner as tc
    from sdtpu_torch.tokenizers.clip import CLIPTokenizer

    jtok, tok = JCLIPTokenizer(), CLIPTokenizer()
    text = "a (photo:1.4) of a [cat] BREAK " + "word " * 90
    tj, wj = jc.tokenize_with_weights(jtok, text, jtok.eos_token_id)
    tt, wt = tc.tokenize_with_weights(tok, text, tok.eos_token_id)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(wt, wj)
    n = len(tt) // 77
    hidden = np.random.default_rng(0).standard_normal((n, 77, 16), dtype=np.float32)
    want = jc.apply_token_weights(jnp.asarray(hidden), jnp.asarray(wj.reshape(n, 77)))
    got = tc.apply_token_weights(torch.from_numpy(hidden), torch.from_numpy(wt.reshape(n, 77)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_synthesized_small_pipeline_runs():
    """Random weights drawn by the port itself (no JAX params)."""
    tp = create_pipeline(SDVersion.FLUX, small=True, seed=3, device="cpu")
    res = tp.generate(_gp(cfg_scale=1.0, sample_steps=2))
    assert res.images.shape == (1, 64, 64, 3) and np.isfinite(res.latents).all()
    assert res.images.std() > 0


def test_unported_requests_raise(pipes):
    _, tp = pipes
    with pytest.raises(NotImplementedError, match="sefi_euler"):
        tp.generate(_gp(sample_method="sefi_euler"))
    with pytest.raises(NotImplementedError, match="HUNYUAN_VIDEO"):
        create_pipeline(SDVersion.HUNYUAN_VIDEO, small=True, device="cpu")


def test_slg_is_refused_under_cfg(pipes):
    """The FLUX diffusion functions take ``skip_layers``, so both pipelines
    run Skip-Layer Guidance under CFG (the small DiT's single blocks, indexed
    depth + i; the window the CLI's 0.01-0.2 stretched to every step):
    the port matches the JAX pipeline there, and without CFG ignores it as
    the JAX pipeline does.  (The name is the refusal's this test held
    before the sampling slice.)"""
    import inspect

    jp, tp = pipes
    assert "skip_layers" in inspect.signature(jp.diffusion_fn).parameters
    assert "skip_layers" in inspect.signature(tp.diffusion_fn).parameters
    from sdtpu_torch.factory import flux_configs

    dit_cfg = flux_configs(True)[0]
    assert dit_cfg.depth_single > 1  # skip the first single block
    slg = _gp(slg_scale=2.5, skip_layers=(dit_cfg.depth,), slg_end=1.0, sample_steps=2)
    got, want = tp.generate(slg), jp.generate(_jgp(slg))
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert np.abs(got.latents - tp.generate(dataclasses.replace(slg, slg_scale=0.0)).latents
                  ).max() > 1e-3
    no_cfg = _gp(cfg_scale=1.0, sample_steps=2)
    got = tp.generate(dataclasses.replace(no_cfg, slg_scale=2.5))
    want = jp.generate(_jgp(dataclasses.replace(no_cfg, slg_scale=2.5)))
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert np.array_equal(got.latents, tp.generate(no_cfg).latents)


def test_create_pipeline_defaults_to_float32_as_the_reference():
    """The port's default dtype is the reference's, float32: a call that
    names no dtype runs float32 weights and compute (on the card too, where
    every kernel on that path has a float32 form)."""
    import inspect

    import jax.numpy as jnp

    assert inspect.signature(create_pipeline).parameters["dtype"].default is torch.float32
    assert inspect.signature(jax_create_pipeline).parameters["dtype"].default is jnp.float32
    tp = create_pipeline(SDVersion.FLUX, small=True, seed=0, device="cpu")
    assert tp.compute_dtype == torch.float32
    dense = [v for v in tp.diffusion_params.values() if isinstance(v, torch.Tensor)]
    assert dense and all(v.dtype == torch.float32 for v in dense)
