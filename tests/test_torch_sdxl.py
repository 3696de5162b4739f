"""The SDXL slice against ``sdtpu``: the SDXL UNet (label embedding, linear
projections, 64-channel heads), CLIP-G, the SDXL conditioner, TAESD-XL's
decoder, the LCM sampler, ``set_tae`` and the small SDXL pipeline.

Weights come from the JAX package's own inits (``create_pipeline(SDVersion.
SDXL, small=True, seed=0)``, ``init_unet_params``, ``init_clip_params``,
``init_tae_params``) through ``from_jax_params``; inputs and noises from
numpy seeds.  Float32 on both sides.  Tolerances:
  - the UNet and the TAE decode: 1e-4 relative L2, as the SD1 UNet's
    (float32 sums of convolutions, matmuls and softmaxes in another order;
    observed ~3e-6; the TAE's 24 convolutions differ by ~1e-5 at outputs
    of ~2, so an element near 0 is off by more than 1e-4 of itself);
  - CLIP-G and the conditioner: rtol 1e-4 / atol 1e-5, as the SD1
    conditioner's;
  - the LCM loop: rtol = atol = 1e-5, as the other samplers' loops;
  - the pipelines: the golden's rtol = atol = 5e-4 on latents, images within
    one uint8 level (a float32 pixel on a rounding boundary).
Full-width specs are compared by name and shape only (``device_init.
param_specs`` builds no array).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.conditioning import conditioner as jcond
from sdtpu.diffusion import denoiser as jden
from sdtpu.diffusion import samplers as jsamplers
from sdtpu.diffusion.schedule import get_sigmas as jget_sigmas
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu.factory import unet_config_for
from sdtpu.models import clip as jclip
from sdtpu.models import tae as jtae
from sdtpu.models import unet as ju
from sdtpu.models import vae as jvae
from sdtpu.utils.device_init import param_specs as jparam_specs
from sdtpu_torch.conditioning import conditioner as tcond
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.diffusion import samplers as tsamplers
from sdtpu_torch.factory import create_pipeline, sdxl_configs
from sdtpu_torch.models import clip as tclip
from sdtpu_torch.models import tae as ttae
from sdtpu_torch.models import unet as tu
from sdtpu_torch.models import vae as tvae
from sdtpu_torch.weights import from_jax_params, synthesize

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sdxl_euler.npz")
JSMALL = unet_config_for(jconfig.SDVersion.SDXL, small=True)
TSMALL, TCLIP_L, TCLIP_G, TVAE = sdxl_configs(small=True)
# the small SDXL UNet as the full one runs its transformers: linear
# projections, heads of num_head_channels (16 → 2 and 4 heads), depth 2
TLINEAR = dataclasses.replace(TSMALL, num_heads=None, num_head_channels=16,
                              use_linear_in_transformer=True, transformer_depth=(1, 2))


def _j(cfg):
    """The JAX class of a port config (the port's fields, the rest at their
    defaults)."""
    mod = {tu.UNetConfig: ju, tclip.CLIPTextConfig: jclip, tvae.VAEConfig: jvae,
           ttae.TAEConfig: jtae}[type(cfg)]
    return getattr(mod, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("port,ref", [
    (tu.SDXL_UNET_CONFIG, ju.SDXL_UNET_CONFIG), (TSMALL, JSMALL),
    (tclip.CLIP_G_CONFIG, jclip.CLIP_G_CONFIG), (tvae.SDXL_VAE_CONFIG, jvae.SDXL_VAE_CONFIG),
    (ttae.TAESD_CONFIG, jtae.TAESD_CONFIG), (ttae.TAESD_XL_CONFIG, jtae.TAESD_XL_CONFIG),
    (ttae.TAESD_SD3_CONFIG, jtae.TAESD_SD3_CONFIG),
    (ttae.TAESD_FLUX_CONFIG, jtae.TAESD_FLUX_CONFIG),
], ids=["unet", "unet_small", "clip_g", "vae", "taesd", "taesd_xl", "taesd_sd3", "taesd_flux"])
def test_configs_match(port, ref):
    assert _j(port) == ref


# ------------------------------------------------------------- specs


def test_full_width_unet_specs_match_unet_param_shapes():
    """Names, shapes and inits at ``SDXL_UNET_CONFIG`` (label embedding,
    linear projections) are ``unet_param_shapes``'s."""
    want = {k: (shape, {"w": "normal", "g": "ones", "b": "zeros"}[kind])
            for k, (kind, shape) in ju.unet_param_shapes(ju.SDXL_UNET_CONFIG).items()}
    got = tu.param_specs(tu.SDXL_UNET_CONFIG)
    assert got == want
    assert got["label_emb.0.0.weight"][0] == (1280, 2816)
    assert got["middle_block.1.proj_in.weight"][0] == (1280, 1280)
    assert "middle_block.1.transformer_blocks.9.attn2.to_k.weight" in got


@pytest.mark.parametrize("module", ["clip_g", "tae"])
def test_full_width_specs_match_jax_init(module):
    if module == "clip_g":
        want = jparam_specs(jclip.init_clip_params, jclip.CLIP_G_CONFIG, 0)
        got = tclip.param_specs(tclip.CLIP_G_CONFIG)
        assert got["text_projection.weight"][0] == (1280, 1280)
    else:
        want = {k: v for k, v in jparam_specs(jtae.init_tae_params, jtae.TAESD_XL_CONFIG).items()
                if k.startswith("decoder.")}
        got = ttae.param_specs(ttae.TAESD_XL_CONFIG)
    assert {k: tuple(v.shape) for k, v in want.items()} == {k: s for k, (s, _) in got.items()}


def test_from_jax_params_and_synthesize_carry_all_three():
    """The small UNet, CLIP-G and the TAE bridged value for value; their full
    specs drawn dense (no quantized class), the TAE at its init's std."""
    jps = {"unet": ju.init_unet_params(JSMALL, seed=0),
           "clip_g": jclip.init_clip_params(_j(TCLIP_G), 1),
           "tae": jtae.init_tae_params(jtae.TAESD_XL_CONFIG, seed=5)}
    specs = {"unet": tu.param_specs(TSMALL), "clip_g": tclip.param_specs(TCLIP_G),
             "tae": ttae.param_specs(ttae.TAESD_XL_CONFIG)}
    for name, jp in jps.items():
        tp = from_jax_params(jp, device="cpu")
        assert set(specs[name]) <= set(tp)
        for k, v in jp.items():
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v), err_msg=k)
        drawn = synthesize(specs[name], seed=3, device="cpu", dtype=torch.float32)
        assert all(type(v) is torch.Tensor and tuple(v.shape) == specs[name][k][0]
                   for k, v in drawn.items())
    w = synthesize(ttae.param_specs(ttae.TAESD_XL_CONFIG), seed=3, device="cpu",
                   dtype=torch.float32)["decoder.layers.2.conv.0.weight"]
    assert abs(w.std().item() - ttae.WEIGHT_STD) < 0.002


# ------------------------------------------------------------- UNet


@pytest.fixture(scope="module", params=["small", "linear"])
def unet_pair(request):
    tcfg = TSMALL if request.param == "small" else TLINEAR
    jp = ju.init_unet_params(_j(tcfg), seed=0)
    return tcfg, jp, from_jax_params(jp, device="cpu")


@pytest.mark.parametrize("t", [(999.0, 10.5), (411.25, 0.0)])
def test_unet_forward_with_y_matches_jax(unet_pair, t):
    tcfg, jp, tp = unet_pair
    rng = np.random.default_rng(int(t[0]))
    x = rng.standard_normal((2, 16, 8, 4), dtype=np.float32)
    ts = np.asarray(t, np.float32)
    ctx = rng.standard_normal((2, 77, tcfg.context_dim), dtype=np.float32)
    y = rng.standard_normal((2, tcfg.adm_in_channels), dtype=np.float32)
    want = ju.unet_forward(jp, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), y=jnp.asarray(y),
                           cfg=_j(tcfg))
    got = tu.unet_forward(tp, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                          y=torch.from_numpy(y), cfg=tcfg)
    assert got.shape == want.shape == (2, 16, 8, 4)
    assert _rel(got.numpy(), want) <= 1e-4
    # y moves the output: the label embedding is in the path
    no_y = ju.unet_forward(jp, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), cfg=_j(tcfg))
    assert _rel(no_y, want) > 1e-3


def _count_attention(monkeypatch, mod):
    seen = {}

    def counting(q, k, v, *a, **kw):
        seen[q.shape[-1]] = seen.get(q.shape[-1], 0) + 1
        return torch.empty_like(q)

    monkeypatch.setattr(mod, "attention", counting)
    return seen


def test_attention_calls_count_the_forward(monkeypatch):
    """A full-width SDXL forward at 1024² under CFG on the meta device (shapes
    only): ``chip_smoke.SDXL_UNET_ATTENTION_CALLS`` attention calls at D 64
    (70 transformer blocks, a self- and a cross-attention each); one prompt
    encode ``chip_smoke.SDXL_CLIP_ATTENTION_CALLS`` (CLIP-L's 11 layers at
    clip skip 2, CLIP-G's 31 and its top layer for the pooled output)."""
    import chip_smoke

    seen = _count_attention(monkeypatch, tu)
    cfg = tu.SDXL_UNET_CONFIG
    p = {k: torch.empty(shape, device="meta") for k, (shape, _) in tu.param_specs(cfg).items()}
    out = tu.unet_forward(p, torch.empty((2, 128, 128, 4), device="meta"),
                          torch.empty((2,), device="meta"),
                          torch.empty((2, 77, cfg.context_dim), device="meta"),
                          y=torch.empty((2, cfg.adm_in_channels), device="meta"), cfg=cfg)
    assert out.shape == (2, 128, 128, 4)
    assert seen == chip_smoke.SDXL_UNET_ATTENTION_CALLS == {64: 140}

    clip_seen = _count_attention(monkeypatch, tclip)

    def meta(specs):
        return {k: torch.empty(shape, device="meta") for k, (shape, _) in specs.items()}

    from sdtpu_torch.tokenizers.clip import CLIPTokenizer

    cond = tcond.SDXLConditioner(CLIPTokenizer(), meta(tclip.param_specs(tclip.CLIP_L_CONFIG)),
                                 tclip.CLIP_L_CONFIG, meta(tclip.param_specs(tclip.CLIP_G_CONFIG)),
                                 tclip.CLIP_G_CONFIG, device="meta")
    c = cond.get_learned_condition("a photograph of an astronaut riding a horse")
    assert c.c_crossattn.shape == (1, 77, 2048) and c.c_vector.shape == (1, 2816)
    assert sum(clip_seen.values()) == chip_smoke.SDXL_CLIP_ATTENTION_CALLS == 43


# ------------------------------------------------------------- CLIP-G, conditioner


@pytest.fixture(scope="module")
def jpipe():
    return jax_create_pipeline(jconfig.SDVersion.SDXL, small=True, seed=0)


@pytest.mark.parametrize("clip_skip", [2, 1])
def test_clip_g_hidden_and_pooled_match_jax(jpipe, clip_skip):
    cfg = jpipe.conditioner.cg
    rng = np.random.default_rng(clip_skip)
    ids = rng.integers(0, 1000, (3, 77)).astype(np.int32)
    ids[:, 30] = cfg.eos_token_id
    ids[1, 5] = cfg.eos_token_id  # the first EOS is pooled
    hj, pj = jclip.clip_text_forward(jpipe.conditioner.pg, jnp.asarray(ids), cfg,
                                     clip_skip=clip_skip, return_pooled=True)
    ht, pt = tclip.clip_text_forward(from_jax_params(jpipe.conditioner.pg, device="cpu"),
                                     torch.from_numpy(ids.astype(np.int64)), TCLIP_G,
                                     clip_skip=clip_skip, return_pooled=True)
    assert pt.shape == (3, TCLIP_G.projection_dim)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("text,kw", [
    # a weighted prompt over 77 tokens (three chunks, a BREAK), crop and target
    ("a (photo:1.3) of a [cat] BREAK on a (red:0.8) sofa, " + "soft light, " * 40,
     dict(width=832, height=1216, crop_w=16, crop_h=32, target_width=1024, target_height=1024)),
    ("a photograph of an astronaut riding a horse", dict(width=1024, height=1024, clip_skip=1)),
])
def test_sdxl_conditioner_matches_jax(jpipe, text, kw):
    """The hidden state (CLIP-L ++ CLIP-G, 96 wide at the small configs),
    CLIP-G's ids zeroed after each chunk's first EOS, the token weights, and
    the vector (pooled ++ six 256-wide embeddings).  Both final layer norms
    get a nonzero bias (at clip skip 1 the hidden state is taken after it,
    and with the init's zero bias a chunk's mean is ~0: the mean-preserving
    weight scale would divide by it, in both packages alike)."""
    jc = jpipe.conditioner
    bias = "text_model.final_layer_norm.bias"
    pl, pg = dict(jc.pl), dict(jc.pg)
    for i, p in enumerate((pl, pg)):
        noise = np.random.default_rng(i).standard_normal(p[bias].shape, dtype=np.float32)
        p[bias] = jnp.asarray(noise * 0.1 + 0.2)
    j = jcond.SDXLConditioner(jc.tokenizer, pl, jc.cl, pg, jc.cg)
    t = tcond.SDXLConditioner(jc.tokenizer, from_jax_params(pl, device="cpu"), TCLIP_L,
                              from_jax_params(pg, device="cpu"), TCLIP_G, device="cpu")
    kw = dict(kw)
    skip = kw.pop("clip_skip", -1)
    cj = j.get_learned_condition(text, clip_skip=skip, **kw)
    ct = t.get_learned_condition(text, clip_skip=skip, **kw)
    want = np.asarray(cj.c_crossattn)
    assert ct.c_crossattn.shape == want.shape and want.shape[-1] == 96
    np.testing.assert_allclose(ct.c_crossattn.numpy(), want, rtol=1e-4, atol=1e-5)
    assert ct.c_vector.shape == cj.c_vector.shape == (1, 48 + 1536)
    assert ct.c_vector.dtype == torch.float32
    np.testing.assert_allclose(ct.c_vector.numpy(), np.asarray(cj.c_vector), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size", [(1024, 1024, 0, 0, None, None), (832, 1216, 16, 32, 1024, 2048)])
def test_sdxl_size_vector_matches_jax(size):
    w, h, cw, ch, tw, th = size
    pooled = np.random.default_rng(0).standard_normal((1, 1280), dtype=np.float32)
    want = jcond.sdxl_size_vector(jnp.asarray(pooled), w, h, cw, ch, tw, th)
    got = tcond.sdxl_size_vector(torch.from_numpy(pooled), w, h, cw, ch, tw, th)
    assert got.shape == (1, 2816)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- TAESD


@pytest.mark.parametrize("cfg", ["xl", "flux"])
def test_tae_decode_matches_jax(cfg):
    jcfg = jtae.TAESD_XL_CONFIG if cfg == "xl" else jtae.TAESD_FLUX_CONFIG
    tcfg = ttae.TAESD_XL_CONFIG if cfg == "xl" else ttae.TAESD_FLUX_CONFIG
    jp = jtae.init_tae_params(jcfg, seed=5)
    z = np.random.default_rng(1).standard_normal((2, 6, 5, jcfg.z_channels), dtype=np.float32)
    want = jtae.tae_decode(jp, jnp.asarray(z), jcfg)
    got = ttae.tae_decode(from_jax_params(jp, device="cpu"), torch.from_numpy(z), tcfg)
    assert got.shape == want.shape == (2, 48, 40, 3)
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("name", ["decoder.0.weight", "decoder.1.bias", "decoder.4.conv.2.weight",
                                  "encoder.0.weight", "encoder.3.skip.weight",
                                  "decoder.layers.5.weight", "encoder.layers.1.conv.0.bias",
                                  "taesd_decoder.0.weight", "decoder.conv_in.weight"])
def test_convert_taesd_name_matches_jax(name):
    assert ttae.convert_taesd_name(name) == jtae.convert_taesd_name(name)


@pytest.mark.parametrize("version,zc", [("sdxl", 4), ("sd1", 4), ("SDXL_INPAINT", 4), ("sd3", 16),
                                        ("flux", 16), ("wan2", 48)])
def test_tae_config_for_matches_jax(version, zc):
    assert _j(ttae.tae_config_for(version, zc)) == jtae.tae_config_for(version, zc)


# ------------------------------------------------------------- LCM


def _sigmas(steps=4):
    return jget_sigmas(jden.CompVisDenoiser(), steps, scheduler="discrete")


@pytest.mark.parametrize("extra", [None, {"noise_scale_start": 0.7, "noise_scale_end": 0.2},
                                   {"noise_scale_start": 0.5}])
@pytest.mark.parametrize("steps", [1, 4])
def test_lcm_per_step_arrays_match_build_sampler(extra, steps):
    sig = _sigmas(steps)
    _, _, want = jsamplers.build_sampler(lambda x, s, i: (x, x), jnp.zeros((1, 2)), sig,
                                         method="lcm", extra_args=extra)
    got = tsamplers.per_step_arrays(sig, "lcm", 0.0, extra_args=extra)
    for k in ("i", "sigma", "sigma_next", "noise_scale"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("extra", [None, {"noise_scale_start": 0.7, "noise_scale_end": 0.2}])
@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_lcm_loop_matches_jax(extra, eta):
    """LCM draws its noise whatever eta is; the whole loop on a toy model
    with the same noise stack, the port's steps against the JAX scan."""
    assert tsamplers.method_needs_noise("lcm", eta)
    sig = _sigmas(4)
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((2, 4, 4, 3), dtype=np.float32) * float(sig[0])
    w = rng.standard_normal((4, 4, 3), dtype=np.float32) * 0.1
    noises = rng.standard_normal((4,) + x0.shape, dtype=np.float32)

    def jmodel(x, sigma, i):
        den = x / (1.0 + sigma) + jnp.asarray(w) * jnp.tanh(sigma)
        return den, den

    def tmodel(x, sigma, i):
        den = x / (1.0 + sigma) + torch.from_numpy(w) * torch.tanh(sigma)
        return den, den

    want = jsamplers.sample(jmodel, jnp.asarray(x0), sig, method="lcm", noises=jnp.asarray(noises),
                            eta=eta, extra_args=extra)
    got = tsamplers.sample(tmodel, torch.from_numpy(x0), sig, method="lcm", noises=noises, eta=eta,
                           extra_args=extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="noises"):
        tsamplers.sample(tmodel, torch.from_numpy(x0), sig, method="lcm")


# ------------------------------------------------------------- pipeline


@pytest.fixture(scope="module")
def pipes(jpipe):
    params = {"diffusion": from_jax_params(jpipe.diffusion_params, device="cpu"),
              "clip_l": from_jax_params(jpipe.conditioner.pl, device="cpu"),
              "clip_g": from_jax_params(jpipe.conditioner.pg, device="cpu"),
              "vae": from_jax_params(jpipe.vae_params, device="cpu")}
    return jpipe, create_pipeline(SDVersion.SDXL, params=params, small=True, device="cpu")


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=3, cfg_scale=4.0, seed=11)
    base.update(kw)
    return GenerationParams(**base)


def _jgp(gp):
    return jconfig.GenerationParams(**dataclasses.asdict(gp))


def test_reproduces_sdxl_golden_latents(pipes):
    """``tests/test_golden_latents.py``'s ``sdxl_euler`` case: 64², 3 euler
    steps, CFG 4 (y_c and y_u, the CFG batch of two)."""
    _, tp = pipes
    res = tp.generate(_gp(sample_method="euler"))
    want = np.load(GOLDEN)["latents"]
    assert res.latents.shape == want.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(res.latents, want, rtol=5e-4, atol=5e-4)


@pytest.fixture
def tae_pair(pipes):
    """Both pipelines with the same TAESD-XL decoder attached; detached after."""
    jp, tp = pipes
    jparams = jtae.init_tae_params(jtae.TAESD_XL_CONFIG, seed=5)
    jp.set_tae(jparams, jtae.TAESD_XL_CONFIG)
    tp.set_tae(from_jax_params(jparams, device="cpu"), ttae.TAESD_XL_CONFIG)
    yield jp, tp
    jp.set_tae(None)
    tp.set_tae(None)


@pytest.mark.parametrize("kw", [
    # the bench's request, cut to 64²: 4 lcm steps, CFG 1, seed 42
    dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="",
         sample_method="lcm", sample_steps=4, cfg_scale=1.0, seed=42),
    # CFG, a batch of two, LCM's noise scales, a wide latent, VAE tiling
    dict(sample_method="lcm", sample_steps=2, batch_count=2, width=96, seed=3,
         extra_sample_args="noise_scale_start=0.8,noise_scale_end=0.3", tiling=True),
])
def test_lcm_taesd_pipeline_matches_jax(tae_pair, kw):
    jp, tp = tae_pair
    kw = dict(kw)
    tiling = kw.pop("tiling", False)
    for p in (jp, tp):
        p.set_vae_tiling(tiling, tile_size=8, overlap=2)
    try:
        gp = _gp(**kw)
        want, got = jp.generate(_jgp(gp)), tp.generate(gp)
    finally:
        for p in (jp, tp):
            p.set_vae_tiling(False)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert got.images.shape == want.images.shape and got.images.std() > 0
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


def test_set_tae_none_restores_the_vae(pipes):
    """Re-attaching keeps the original VAE pair; ``set_tae(None)`` restores
    it, and the images are the full VAE's again (the JAX pipeline's)."""
    jp, tp = pipes
    vae_fn, vae_p = tp.vae_decode_fn, tp.vae_params
    for seed in (5, 6):
        tp.set_tae(synthesize(ttae.param_specs(ttae.TAESD_XL_CONFIG), seed=seed, device="cpu",
                              dtype=torch.float32), ttae.TAESD_XL_CONFIG)
        assert tp.vae_params is not vae_p
    tp.set_tae(None)
    assert tp.vae_decode_fn is vae_fn and tp.vae_params is vae_p
    gp = _gp(sample_method="euler", sample_steps=2)
    want, got = jp.generate(_jgp(gp)), tp.generate(gp)
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1
    with pytest.raises(NotImplementedError, match="preview"):
        tp.set_tae({}, ttae.TAESD_XL_CONFIG, preview_only=True)
    with pytest.raises(NotImplementedError, match="guidance_schedule"):
        tp.generate(_gp(extra_sample_args="guidance_schedule=7.5x2"))


def test_synthesized_small_sdxl_pipeline_runs():
    """Random weights drawn by the port itself (CLIP-G at its seed offset),
    the default dtype, float32."""
    tp = create_pipeline(SDVersion.SDXL, small=True, seed=3, device="cpu")
    assert tp.compute_dtype == torch.float32 and tp.latent_channels == 4
    assert tp.conditioner.pg["text_projection.weight"].shape == (48, 48)
    res = tp.generate(_gp(sample_steps=2, sample_method="lcm", cfg_scale=1.0))
    assert res.images.shape == (1, 64, 64, 3) and np.isfinite(res.latents).all()
    assert res.images.std() > 0
