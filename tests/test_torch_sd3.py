"""The SD3 slice against ``sdtpu``: the MMDiT (qk RMS norms, MMDiT-X's second
self-attention, the pos-embed crop, ``skip_layers``), its config
fingerprint, the SD3 triple conditioner, the discrete flow samplers at
SD3's sigmas, the small SD3 pipeline and the SD3 loader split.

Weights come from the JAX package's own inits (``create_pipeline(SDVersion.
SD3, small=True, seed=0)``, ``init_mmdit_params``) through
``from_jax_params``; inputs and noises from numpy seeds.  Float32 on both
sides.  Tolerances:
  - the MMDiT: 1e-4 relative L2, as the UNet's (float32 sums of matmuls,
    norms and softmaxes in another order);
  - the conditioner: rtol 1e-4 / atol 1e-5, as the SD1 and SDXL ones';
  - the sampler loops: rtol = atol = 1e-5, as the other samplers' loops;
  - the pipelines: the golden's rtol = atol = 5e-4 on latents, images within
    one uint8 level (a float32 pixel on a rounding boundary).
Full-width specs are compared by name and shape only (``device_init.
param_specs`` builds no array); the full-width call counts run on the meta
device.
"""
import dataclasses
import json
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
from sdtpu.models import clip as jclip
from sdtpu.models import mmdit as jm
from sdtpu.models import vae as jvae
from sdtpu.utils.device_init import param_specs as jparam_specs
from sdtpu_torch.conditioning import conditioner as tcond
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.diffusion import denoiser as tden
from sdtpu_torch.diffusion import samplers as tsamplers
from sdtpu_torch.diffusion.schedule import get_sigmas
from sdtpu_torch.factory import create_pipeline, sd3_configs
from sdtpu_torch.models import clip as tclip
from sdtpu_torch.models import mmdit as tm
from sdtpu_torch.models import vae as tvae
from sdtpu_torch.weights import from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sd3_euler.npz")
TSMALL, TCLIP_L, TCLIP_G, TT5, TVAE = sd3_configs(small=True)


def _j(cfg):
    """The JAX class of a port config (the port's fields)."""
    mod = {tm.MMDiTConfig: jm, tclip.CLIPTextConfig: jclip, tvae.VAEConfig: jvae}[type(cfg)]
    return getattr(mod, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("port,ref", [
    (tm.SD3_MEDIUM_CONFIG, jm.SD3_MEDIUM_CONFIG), (tm.SD35_MEDIUM_CONFIG, jm.SD35_MEDIUM_CONFIG),
    (tm.SD35_LARGE_CONFIG, jm.SD35_LARGE_CONFIG), (tvae.SD3_VAE_CONFIG, jvae.SD3_VAE_CONFIG),
    # the JAX factory's small SD3 MMDiT (sdtpu/factory.py, _create_sd3_pipeline)
    (TSMALL, jm.MMDiTConfig(patch_size=2, in_channels=4, depth=2, context_size=96,
                            adm_in_channels=96, pos_embed_max_size=16)),
], ids=["sd3_medium", "sd35_medium", "sd35_large", "vae", "small"])
def test_configs_match(port, ref):
    assert _j(port) == ref
    if isinstance(port, tm.MMDiTConfig):
        assert (port.hidden_size, port.num_heads, port.out_channels) == \
            (ref.hidden_size, ref.num_heads, ref.out_channels)


@pytest.mark.parametrize("name", ["SD3_MEDIUM_CONFIG", "SD35_MEDIUM_CONFIG", "SD35_LARGE_CONFIG"])
def test_full_width_specs_and_fingerprint_match_jax(name):
    """Names and shapes at full width are ``init_mmdit_params``'s (no array
    built), and both ``detect_mmdit_config`` read them back as this config;
    so do they for a checkpoint cut to fewer blocks and one without
    ``pos_embed``."""
    cfg = getattr(tm, name)
    want = jparam_specs(jm.init_mmdit_params, getattr(jm, name), 0)
    got = tm.param_specs(cfg)
    shapes = {k: s for k, (s, _) in got.items()}
    assert {k: tuple(v.shape) for k, v in want.items()} == shapes
    assert tm.detect_mmdit_config(list(got), shapes) == cfg
    assert _j(cfg) == jm.detect_mmdit_config(list(got), shapes)
    cut = {k: s for k, s in shapes.items() if k != "pos_embed"
           and (not k.startswith("joint_blocks.") or int(k.split(".")[1]) < 3)}
    assert _j(tm.detect_mmdit_config(list(cut), cut)) == jm.detect_mmdit_config(list(cut), cut)
    if name == "SD35_MEDIUM_CONFIG":
        assert shapes["pos_embed"] == (1, 384 * 384, 1536)
        assert shapes["joint_blocks.12.x_block.attn2.qkv.weight"] == (4608, 1536)
        assert "joint_blocks.13.x_block.attn2.qkv.weight" not in shapes
        assert shapes["joint_blocks.23.context_block.adaLN_modulation.1.weight"] == (3072, 1536)
        assert shapes["joint_blocks.0.x_block.attn.ln_q.weight"] == (64,)


# ------------------------------------------------------------- MMDiT

FORWARD_CASES = {
    "plain": (dict(), (8, 8), ()),
    "qk_rms": (dict(qk_norm="rms"), (8, 8), ()),
    "mmdit_x": (dict(qk_norm="rms", num_x_self_attn_layers=2, depth=3), (8, 8), ()),
    # a non-square latent: the pos-embed grid cropped off-centre on one axis
    "non_square": (dict(qk_norm="rms", num_x_self_attn_layers=1), (6, 14), ()),
    "skip_layers": (dict(qk_norm="rms", num_x_self_attn_layers=1, depth=3), (8, 8), (1,)),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_mmdit_forward_matches_jax(case):
    over, (h, w), skip = FORWARD_CASES[case]
    tcfg = dataclasses.replace(TSMALL, **over)
    jp = jm.init_mmdit_params(_j(tcfg), seed=3)
    # nonzero biases and qk gains, so a dropped or misplaced one shows
    rng = np.random.default_rng(11)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape, dtype=np.float32) * 0.05 + 1.0)
              if ".ln_" in k else jnp.asarray(rng.standard_normal(v.shape, dtype=np.float32) * 0.02)
              if k.endswith(".bias") else v) for k, v in jp.items()}
    tp = from_jax_params(jp, device="cpu")
    x = rng.standard_normal((2, h, w, tcfg.in_channels), dtype=np.float32)
    ts = np.asarray([999.0, 321.5], np.float32)
    ctx = rng.standard_normal((2, 11, tcfg.context_size), dtype=np.float32)
    y = rng.standard_normal((2, tcfg.adm_in_channels), dtype=np.float32)
    want = jm.mmdit_forward(jp, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(y),
                            cfg=_j(tcfg), skip_layers=skip)
    got = tm.mmdit_forward(tp, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                           torch.from_numpy(y), cfg=tcfg, skip_layers=skip)
    assert got.shape == want.shape == x.shape
    assert _rel(got.numpy(), want) <= 1e-4
    if skip:  # the skipped block is out of the path
        full = tm.mmdit_forward(tp, torch.from_numpy(x), torch.from_numpy(ts),
                                torch.from_numpy(ctx), torch.from_numpy(y), cfg=tcfg)
        assert _rel(full.numpy(), want) > 1e-3


def _count_attention(monkeypatch, mod):
    seen = {}

    def counting(q, k, v, *a, **kw):
        seen[q.shape[-1]] = seen.get(q.shape[-1], 0) + 1
        return torch.empty_like(q)

    monkeypatch.setattr(mod, "attention", counting)
    return seen


def _meta(specs):
    return {k: torch.empty(shape, device="meta") for k, (shape, _) in specs.items()}


def test_calls_count_the_bench_request(monkeypatch):
    """At full width on the meta device (shapes only): one SD3.5-Medium
    forward at 1024² under CFG makes ``chip_smoke.SD3_MMDIT_ATTENTION_CALLS``
    attention calls at D 64 (24 joint over 154 + 4096 tokens, 13 MMDiT-X
    over 4096); one prompt encode ``chip_smoke.SD3_CLIP_ATTENTION_CALLS`` at
    D 64 (CLIP-L's 11 layers at clip skip 2 and its top layer for the
    pooled output, CLIP-G's 31 and its top one) and
    ``chip_smoke.SD3_T5_LINEARS`` T5 linears over 77 tokens (q, k, v, o,
    wi_0, wi_1, wo in each of 24 blocks: the 4-bit matmul's M = 77 calls)."""
    import chip_smoke
    from sdtpu_torch.models import t5 as tt5
    from sdtpu_torch.tokenizers.clip import CLIPTokenizer

    seen, lengths = {}, []

    def counting(q, k, v, *a, **kw):
        seen[q.shape[-1]] = seen.get(q.shape[-1], 0) + 1
        lengths.append(q.shape[2])
        return torch.empty_like(q)

    monkeypatch.setattr(tm, "attention", counting)
    cfg = tm.SD35_MEDIUM_CONFIG
    out = tm.mmdit_forward(_meta(tm.param_specs(cfg)), torch.empty((2, 128, 128, 16), device="meta"),
                           torch.empty((2,), device="meta"),
                           torch.empty((2, 154, cfg.context_size), device="meta"),
                           torch.empty((2, cfg.adm_in_channels), device="meta"), cfg=cfg)
    assert out.shape == (2, 128, 128, 16)
    assert seen == chip_smoke.SD3_MMDIT_ATTENTION_CALLS == {64: 37}
    assert lengths.count(4250) == 24 and lengths.count(4096) == 13

    clip_seen = _count_attention(monkeypatch, tclip)
    linears = []
    real_linear = tt5.linear

    def counted_linear(x, w, b=None):
        linears.append(x.shape[-2])
        return real_linear(x, w, b)

    monkeypatch.setattr(tt5, "linear", counted_linear)
    _, clip_l, clip_g, t5, _ = sd3_configs(small=False)
    cond = tcond.SD3Conditioner(CLIPTokenizer(), None, _meta(tclip.param_specs(clip_l)), clip_l,
                                _meta(tclip.param_specs(clip_g)), clip_g, _meta(tt5.param_specs(t5)),
                                t5, device="meta")
    c = cond.get_learned_condition("a photograph of an astronaut riding a horse")
    assert c.c_crossattn.shape == (1, 154, 4096) and c.c_vector.shape == (1, 2048)
    assert sum(clip_seen.values()) == chip_smoke.SD3_CLIP_ATTENTION_CALLS == 44
    assert set(clip_seen) == {64}
    assert len(linears) == chip_smoke.SD3_T5_LINEARS == 168 and set(linears) == {77}


# ------------------------------------------------------------- conditioner


@pytest.fixture(scope="module")
def jpipe():
    return jax_create_pipeline(jconfig.SDVersion.SD3, small=True, seed=0)


@pytest.fixture(scope="module")
def t5_tokenizers(tmp_path_factory):
    """The same 256-piece unigram vocab as each package's T5 tokenizer."""
    from sdtpu.tokenizers.t5 import T5UnigramTokenizer as JT5
    from sdtpu_torch.tokenizers.t5 import T5UnigramTokenizer as TT5
    from sdtpu_torch.tools.flux_files import synthetic_t5_vocab

    md = synthetic_t5_vocab(256, seed=3)
    path = tmp_path_factory.mktemp("t5tok") / "tokenizer.json"
    path.write_text(json.dumps({"model": {"type": "Unigram", "unk_id": 2, "vocab": [
        [p, s] for p, s in zip(md["tokenizer.ggml.tokens"], md["tokenizer.ggml.scores"])]}}))
    return TT5.from_tokenizer_json(str(path)), JT5.from_tokenizer_json(str(path))


@pytest.mark.parametrize("text,t5_tok,clip_skip", [
    ("a photograph of an astronaut riding a horse", False, -1),
    ("a photograph of an astronaut riding a horse", True, -1),
    # weights, a BREAK and more than 77 tokens: only the first chunk counts
    ("a (red:1.4) fox in [fresh] snow BREAK golden hour, " + "soft light, " * 40, True, -1),
    ("a red fox in snow", True, 1),
])
def test_sd3_conditioner_matches_jax(jpipe, t5_tokenizers, text, t5_tok, clip_skip):
    """The hidden state (CLIP-L ++ CLIP-G at clip skip 2, weighted, padded to
    T5's width, then T5's 77 tokens), the pooled vector (L ++ G) and the
    ids T5 was fed.  Both final layer norms get a nonzero bias (at clip skip
    1 the hidden state is taken after it, and with the init's zero bias a
    chunk's mean is ~0: the weight scale would divide by it)."""
    jc = jpipe.conditioner
    bias = "text_model.final_layer_norm.bias"
    pl, pg = dict(jc.pl), dict(jc.pg)
    for i, p in enumerate((pl, pg)):
        noise = np.random.default_rng(i).standard_normal(p[bias].shape, dtype=np.float32)
        p[bias] = jnp.asarray(noise * 0.1 + 0.2)
    ttok, jtok = t5_tokenizers if t5_tok else (None, None)
    j = jcond.SD3Conditioner(jc.clip_tokenizer, jtok, pl, jc.cl, pg, jc.cg, jc.pt, jc.ct)
    t = tcond.SD3Conditioner(jc.clip_tokenizer, ttok, from_jax_params(pl, device="cpu"), TCLIP_L,
                             from_jax_params(pg, device="cpu"), TCLIP_G,
                             from_jax_params(jc.pt, device="cpu"), TT5, device="cpu")
    cj = j.get_learned_condition(text, clip_skip=clip_skip)
    ct = t.get_learned_condition(text, clip_skip=clip_skip)
    want = np.asarray(cj.c_crossattn)
    assert ct.c_crossattn.shape == want.shape == (1, 77 + 77, TT5.d_model)
    np.testing.assert_allclose(ct.c_crossattn.numpy(), want, rtol=1e-4, atol=1e-5)
    assert ct.c_vector.shape == cj.c_vector.shape == (1, 96)
    np.testing.assert_allclose(ct.c_vector.numpy(), np.asarray(cj.c_vector), rtol=1e-4, atol=1e-5)
    want_ids = (jtok.pad(jtok.encode(text, add_eos=True), 77)[0] if t5_tok else [0] * 77)
    assert ct.t5_ids == list(want_ids) and (sum(1 for i in ct.t5_ids if i) > 2) is t5_tok


# ------------------------------------------------------------- flow sampling


@pytest.mark.parametrize("shift", [3.0, 2.0])
def test_discrete_flow_sigmas_and_set_shift_match_jax(shift):
    td, jd = tden.DiscreteFlowDenoiser(), jden.DiscreteFlowDenoiser()
    td.set_shift(shift)
    jd.set_shift(shift)
    for steps in (1, 4, 28):
        want = jget_sigmas(jd, steps, scheduler="discrete")
        np.testing.assert_array_equal(get_sigmas(td, steps, scheduler="discrete"), want)
    assert td.sigma_max() == jd.sigma_max() and td.sigma_min() == jd.sigma_min()


def _sd3_sigmas(steps):
    return jget_sigmas(jden.DiscreteFlowDenoiser(shift=3.0), steps, scheduler="discrete")


@pytest.mark.parametrize("method,eta", [("dpm++2m", 0.0), ("euler_a", 1.0), ("euler_a", 0.0),
                                        ("euler", 0.0)])
def test_flow_samplers_match_jax_at_sd3_sigmas(method, eta):
    """The per-step arrays (the flow ancestral split for euler_a) and the
    whole loop on a toy model with the same noise stack, at SD3's sigmas
    (shift 3, 6 steps, from 1.0)."""
    sig = _sd3_sigmas(6)
    assert sig[0] == 1.0
    _, _, want_per = jsamplers.build_sampler(lambda x, s, i: (x, x), jnp.zeros((1, 2)), sig,
                                             method=method, eta=eta, is_flow=True)
    got_per = tsamplers.per_step_arrays(sig, method, eta, is_flow=True)
    for k in got_per:
        np.testing.assert_array_equal(got_per[k], np.asarray(want_per[k]), err_msg=k)
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((2, 4, 4, 3), dtype=np.float32)
    w = rng.standard_normal((4, 4, 3), dtype=np.float32) * 0.1
    noises = rng.standard_normal((6,) + x0.shape, dtype=np.float32)

    def jmodel(x, sigma, i):
        den = x * (1.0 - sigma) + jnp.asarray(w) * jnp.tanh(sigma)
        return den, den

    def tmodel(x, sigma, i):
        den = x * (1.0 - sigma) + torch.from_numpy(w) * torch.tanh(sigma)
        return den, den

    noisy = tsamplers.method_needs_noise(method, eta)
    want = jsamplers.sample(jmodel, jnp.asarray(x0), sig, method=method, eta=eta, is_flow=True,
                            noises=jnp.asarray(noises) if noisy else None)
    got = tsamplers.sample(tmodel, torch.from_numpy(x0), sig, method=method, eta=eta, is_flow=True,
                           noises=noises if noisy else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- pipeline


@pytest.fixture(scope="module")
def pipes(jpipe):
    c = jpipe.conditioner
    params = {"diffusion": from_jax_params(jpipe.diffusion_params, device="cpu"),
              "clip_l": from_jax_params(c.pl, device="cpu"),
              "clip_g": from_jax_params(c.pg, device="cpu"),
              "t5": from_jax_params(c.pt, device="cpu"),
              "vae": from_jax_params(jpipe.vae_params, device="cpu")}
    return jpipe, create_pipeline(SDVersion.SD3, params=params, small=True, device="cpu")


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=3, cfg_scale=4.0, seed=11)
    base.update(kw)
    return GenerationParams(**base)


def _jgp(gp):
    return jconfig.GenerationParams(**dataclasses.asdict(gp))


def test_reproduces_sd3_golden_latents(pipes):
    """``tests/test_golden_latents.py``'s ``sd3_euler`` case: 64², 3 euler
    steps, CFG 4 (c_vector for both halves of the CFG batch)."""
    _, tp = pipes
    assert isinstance(tp.denoiser, tden.DiscreteFlowDenoiser) and tp.denoiser.shift == 3.0
    res = tp.generate(_gp(sample_method="euler"))
    want = np.load(GOLDEN)["latents"]
    assert res.latents.shape == want.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(res.latents, want, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("kw", [
    # the bench's request (bench_sd35_medium), cut to 64² and 4 steps
    dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
         sample_method="dpm++2m", sample_steps=4, cfg_scale=4.5, seed=42),
    # euler_a's flow noise, a batch of two, a wide latent, VAE tiling
    dict(sample_method="euler_a", eta=1.0, sample_steps=3, batch_count=2, width=96, seed=3,
         tiling=True),
])
def test_sd3_pipeline_matches_jax(pipes, kw):
    jp, tp = pipes
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


def test_flow_shift_matches_jax_and_slg_is_refused(pipes):
    """``create_pipeline(flow_shift=...)`` as the JAX factory's; SLG under CFG
    runs on the MMDiT (held to the JAX pipeline in
    ``tests/test_torch_sampling.py``) and changes the latents inside its
    window only, and without CFG it is ignored, as the JAX pipeline does."""
    jp, tp = pipes
    params = {"diffusion": tp.diffusion_params, "clip_l": tp.conditioner.pl,
              "clip_g": tp.conditioner.pg, "t5": tp.conditioner.pt, "vae": tp.vae_params}
    shifted = create_pipeline(SDVersion.SD3, params=params, small=True, device="cpu", flow_shift=1.5)
    jshifted = jax_create_pipeline(jconfig.SDVersion.SD3, small=True, seed=0, flow_shift=1.5)
    assert shifted.denoiser.shift == jshifted.denoiser.shift == 1.5
    gp = _gp(sample_method="euler", sample_steps=4)
    want, got = jshifted.generate(_jgp(gp)), shifted.generate(gp)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert _rel(got.latents, tp.generate(gp).latents) > 1e-3
    base = _gp(sample_method="euler", sample_steps=2)
    plain = tp.generate(base).latents
    base = dataclasses.replace(base, skip_layers=(1,))  # the small MMDiT's second joint block
    window = tp.generate(dataclasses.replace(base, slg_scale=2.5, slg_end=1.0)).latents
    assert _rel(window, plain) > 1e-3
    outside = tp.generate(dataclasses.replace(base, slg_scale=2.5, slg_start=0.6)).latents
    assert np.array_equal(outside, plain)  # its window (1, 0) holds no step
    no_cfg = _gp(sample_method="euler", sample_steps=2, cfg_scale=1.0)
    assert np.array_equal(tp.generate(dataclasses.replace(no_cfg, slg_scale=2.5)).latents,
                          tp.generate(no_cfg).latents)


def test_synthesized_small_sd3_pipeline_runs():
    """Random weights drawn by the port itself, the default dtype, float32."""
    tp = create_pipeline(SDVersion.SD3, small=True, seed=3, device="cpu")
    assert tp.compute_dtype == torch.float32 and tp.latent_channels == 4
    assert tp.conditioner.pl["text_projection.weight"].shape == (48, 48)
    res = tp.generate(_gp(sample_steps=2, sample_method="dpm++2m", cfg_scale=4.5))
    assert res.images.shape == (1, 64, 64, 3) and np.isfinite(res.latents).all()
    assert res.images.std() > 0


# ------------------------------------------------------------- loader


def _same_modules(got, want, modules):
    assert got.version.value == want.version.value == "sd3"
    for m in modules:
        g, w = getattr(got, m), getattr(want, m)
        assert sorted(g) == sorted(w), m
        for k, v in w.items():
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(v), err_msg=f"{m}.{k}")


SD3_PREFIXES = {"diffusion": "model.diffusion_model.", "vae": "first_stage_model.",
                "clip_l": "text_encoders.clip_l.transformer.",
                "clip_g": "text_encoders.clip_g.transformer.",
                "t5": "text_encoders.t5xxl.transformer."}


def _sd3_modules(jp):
    c = jp.conditioner
    mods = {"diffusion": jp.diffusion_params, "vae": jp.vae_params, "clip_l": c.pl, "clip_g": c.pg,
            "t5": c.pt}
    return {m: {k: np.asarray(v, np.float32) for k, v in p.items()} for m, p in mods.items()}


def test_sd3_split_modules_matches_jax(jpipe, tmp_path):
    """An SD3 single file holding every module (``text_encoders.*``
    prefixes), and a set of separate files (``-m`` with the MMDiT and the
    VAE, ``--clip_l``, ``--clip_g``, ``--t5xxl``): the port's split equals
    the JAX one by value on both, CLIP-G's projection transposed from the
    file and CLIP-L's kept."""
    from sdtpu.io.model_loader import load_model_bundle as jload
    from sdtpu.io.model_loader import split_modules as jsplit
    from sdtpu.io.safetensors import save_safetensors
    from sdtpu_torch.io.model_loader import load_model_bundle, split_modules

    mods = _sd3_modules(jpipe)
    names = ("diffusion", "clip_l", "clip_g", "t5", "vae")
    tensors = {SD3_PREFIXES[m] + k: v for m, p in mods.items() for k, v in p.items()}
    got, want = split_modules(tensors), jsplit(tensors)
    _same_modules(got, want, names)
    assert not got.extra and set(got.clip_g) == set(tclip.param_specs(TCLIP_G))
    tp = mods["clip_g"]["text_projection.weight"]
    np.testing.assert_array_equal(got.clip_g["text_projection.weight"], tp.T)
    np.testing.assert_array_equal(got.clip_l["text_projection.weight"],
                                  mods["clip_l"]["text_projection.weight"])
    paths = {"model_path": str(tmp_path / "sd3.safetensors")}
    save_safetensors(paths["model_path"], {SD3_PREFIXES[m] + k: v for m in ("diffusion", "vae")
                                           for k, v in mods[m].items()})
    for m, key in (("clip_l", "clip_l_path"), ("clip_g", "clip_g_path"), ("t5", "t5xxl_path")):
        paths[key] = str(tmp_path / f"{m}.safetensors")
        save_safetensors(paths[key], mods[m])
    _same_modules(load_model_bundle(**paths), jload(**paths), names)


def test_sd3_diffusers_names_are_refused(tmp_path):
    """An SD3 transformer under diffusers names (``pos_embed.proj``,
    ``transformer_blocks``) is refused by name: the port loads SD3 under its
    single-file names."""
    from sdtpu.io.safetensors import save_safetensors
    from sdtpu_torch.io.model_loader import load_model_bundle

    path = str(tmp_path / "sd3_diffusers.safetensors")
    save_safetensors(path, {"pos_embed.proj.weight": np.zeros((8, 4, 2, 2), np.float32),
                            "transformer_blocks.0.attn.to_q.weight": np.zeros((8, 8), np.float32),
                            "context_embedder.weight": np.zeros((8, 16), np.float32)})
    with pytest.raises(NotImplementedError, match="diffusers SD3"):
        load_model_bundle(diffusion_model_path=path)
