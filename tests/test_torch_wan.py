"""The port's Wan2.1 T2V slice against the JAX package, on the CPU.

The same numpy-seeded parameters go through both packages
(``from_jax_params``): the Wan DiT, the 3-D causal Wan VAE's decoder, the
temporal and 5-D spatial tiling, the UMT5 ``WanConditioner``, the plain
attention at the cross-attention's shape, and the whole pipeline
(``generate_video``).  Tolerances:
  - the forwards and the decode in float32: rtol = atol = 1e-4 (the same
    float32 formulas; XLA's and MKL's sums of up to a few thousand terms in
    another order);
  - the conditioner: rtol = atol = 1e-5 (two small UMT5 layers);
  - the plain attention against the Pallas flash in interpret mode:
    ``tests/test_torch_ops.py``'s rtol 2e-4 / atol 2e-5;
  - the pipelines: the golden's rtol = atol = 5e-4 on latents, frames within
    one uint8 level (a float32 pixel on a rounding boundary).
Full-width specs are compared by name and shape only (``device_init.
param_specs`` builds no array); the full-width call counts run on the meta
device.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.conditioning import conditioner as jcond
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu.io.detect import detect_version as jdetect_version
from sdtpu.models import t5 as jt5
from sdtpu.models import tiling as jtiling
from sdtpu.models import wan as jw
from sdtpu.models import wan_vae as jwv
from sdtpu.ops.flash_attention import flash_attention as jflash
from sdtpu.utils.device_init import param_specs as jparam_specs
from sdtpu_torch.conditioning import conditioner as tcond
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.factory import create_pipeline, wan_configs
from sdtpu_torch.io.model_loader import detect_version
from sdtpu_torch.models import t5 as tt5
from sdtpu_torch.models import tiling as ttiling
from sdtpu_torch.models import wan as tw
from sdtpu_torch.models import wan_vae as twv
from sdtpu_torch.ops.flash_attention import plain_attention
from sdtpu_torch.weights import from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "wan2_euler.npz")
TSMALL, TT5, TVAE, T5_SEQ = wan_configs(small=True)


def _j(cfg):
    """The JAX class of a port config (the port's fields)."""
    mod = {tw.WanConfig: jw, twv.WanVAEConfig: jwv, tt5.T5Config: jt5}[type(cfg)]
    return getattr(mod, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _perturbed(p: dict, seed: int) -> dict:
    """JAX params with nonzero biases and norm gains (the init's zeros and
    ones hide a dropped or misplaced one)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in p.items():
        a = np.asarray(v, np.float32)
        if k.endswith(".bias"):
            a = rng.standard_normal(a.shape, dtype=np.float32) * 0.02
        elif ".norm" in k or k.endswith(".gamma"):
            a = rng.standard_normal(a.shape, dtype=np.float32) * 0.05 + 1.0
        out[k] = jnp.asarray(a)
    return out


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("port,ref", [
    (tw.WAN21_T2V_1_3B_CONFIG, jw.WAN21_T2V_1_3B_CONFIG), (tw.WAN21_T2V_14B_CONFIG, jw.WAN21_T2V_14B_CONFIG),
    (tw.WAN21_I2V_14B_CONFIG, jw.WAN21_I2V_14B_CONFIG), (tw.WAN22_TI2V_5B_CONFIG, jw.WAN22_TI2V_5B_CONFIG),
    (twv.WAN21_VAE_CONFIG, jwv.WAN21_VAE_CONFIG), (tt5.UMT5_XXL_CONFIG, jt5.UMT5_XXL_CONFIG),
    # the JAX factory's small Wan2.1 T2V set (sdtpu/factory.py, _create_wan_pipeline)
    (TSMALL, jw.WanConfig(in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=96, out_dim=4,
                          num_heads=2, num_layers=2, axes_dim=(8, 12, 12))),
    (TT5, jt5.T5Config(vocab_size=256, d_model=96, d_kv=16, d_ff=128, num_layers=2, num_heads=4,
                       is_umt5=True)),
    (TVAE, jwv.WanVAEConfig(dim=8, z_dim=4, num_res_blocks=1)),
], ids=["1_3b", "14b", "i2v_14b", "ti2v_5b", "vae", "umt5_xxl", "small", "small_umt5", "small_vae"])
def test_configs_match(port, ref):
    assert _j(port) == ref


@pytest.mark.parametrize("name", ["WAN21_T2V_1_3B_CONFIG", "WAN21_T2V_14B_CONFIG"])
def test_full_width_specs_and_fingerprint_match_jax(name):
    """Names and shapes at full width are ``init_wan_params``'s (no array
    built), and both ``detect_wan_config`` read them back as this config;
    so do they for a checkpoint cut to fewer blocks."""
    cfg = getattr(tw, name)
    want = jparam_specs(jw.init_wan_params, getattr(jw, name), 0)
    got = tw.param_specs(cfg)
    shapes = {k: s for k, (s, _) in got.items()}
    assert {k: tuple(v.shape) for k, v in want.items()} == shapes
    assert tw.detect_wan_config(list(got), shapes) == cfg
    assert _j(cfg) == jw.detect_wan_config(list(got), shapes)
    cut = {k: s for k, s in shapes.items() if not k.startswith("blocks.") or int(k.split(".")[1]) < 2}
    assert tw.detect_wan_config(list(cut), cut).num_layers == 2
    assert _j(tw.detect_wan_config(list(cut), cut)) == jw.detect_wan_config(list(cut), cut)
    if name == "WAN21_T2V_1_3B_CONFIG":
        assert shapes["patch_embedding.weight"] == (1536, 16, 1, 2, 2)
        assert shapes["blocks.29.ffn.0.weight"] == (8960, 1536)
        assert shapes["head.head.weight"] == (64, 1536)


def test_vae_and_umt5_specs_match_jax():
    """The Wan VAE's decoder half (``init_wan_vae_params(decode_only=True)``)
    and UMT5-XXL (``init_t5_params``, a relative bias in every layer) by name
    and shape; the VAE's widths read back from its shapes."""
    want = jparam_specs(jwv.init_wan_vae_params, jwv.WAN21_VAE_CONFIG, 0, decode_only=True)
    got = twv.param_specs(twv.WAN21_VAE_CONFIG)
    assert {k: tuple(v.shape) for k, v in want.items()} == {k: s for k, (s, _) in got.items()}
    assert twv.detect_wan_vae_config({k: torch.empty(s, device="meta")
                                      for k, (s, _) in got.items()}) == twv.WAN21_VAE_CONFIG
    want = jparam_specs(jt5.init_t5_params, jt5.UMT5_XXL_CONFIG, 0)
    got = tt5.param_specs(tt5.UMT5_XXL_CONFIG)
    assert {k: tuple(v.shape) for k, v in want.items()} == {k: s for k, (s, _) in got.items()}
    assert "encoder.block.23.layer.0.SelfAttention.relative_attention_bias.weight" in got


@pytest.mark.parametrize("cfg", ["WAN21_I2V_14B_CONFIG", "WAN22_TI2V_5B_CONFIG", "vace"])
def test_unported_configs_refused_by_name(cfg):
    c = dataclasses.replace(TSMALL, vace_layers=1) if cfg == "vace" else getattr(tw, cfg)
    word = {"WAN21_I2V_14B_CONFIG": "i2v", "WAN22_TI2V_5B_CONFIG": "TI2V", "vace": "VACE"}[cfg]
    with pytest.raises(NotImplementedError, match=word):
        tw.param_specs(c)
    with pytest.raises(NotImplementedError, match=word):
        tw.wan_forward({}, torch.zeros((1, 1, 2, 2, 4)), torch.zeros(1), torch.zeros((1, 3, 96)),
                       cfg=c)


def _wan_names(jcfg):
    """Full-width Wan DiT names and shapes of ``init_wan_params`` (abstract:
    no array built), under the single-file prefix."""
    return {"model.diffusion_model." + k: tuple(v.shape)
            for k, v in jparam_specs(jw.init_wan_params, jcfg, 0).items()}


@pytest.mark.parametrize("case,want", [
    ("1_3b", SDVersion.WAN2), ("14b", SDVersion.WAN2), ("i2v_14b", SDVersion.WAN2_2_I2V),
    ("ti2v_5b", SDVersion.WAN2_2_TI2V), ("vace_1_3b", SDVersion.WAN2),
])
def test_version_detection_matches_jax(case, want):
    """The loader's fingerprint of full-width Wan shape tables, as the JAX
    package's ``detect_version``: T2V at 16 input channels, Wan2.2's I2V at
    36 and TI2V at 48, a VACE file as Wan2 (refused later by name)."""
    cfg = {"1_3b": jw.WAN21_T2V_1_3B_CONFIG, "14b": jw.WAN21_T2V_14B_CONFIG,
           "i2v_14b": jw.WAN21_I2V_14B_CONFIG, "ti2v_5b": jw.WAN22_TI2V_5B_CONFIG,
           "vace_1_3b": dataclasses.replace(jw.WAN21_T2V_1_3B_CONFIG, vace_layers=2)}[case]
    shapes = _wan_names(cfg)
    got = detect_version(list(shapes), shapes)
    assert got == want and got.value == jdetect_version(list(shapes), shapes).value


@pytest.mark.parametrize("case,word", [("i2v", "wan2_2_i2v"), ("ti2v", "wan2_2_ti2v"),
                                       ("vace", "VACE"), ("img_emb", "I2V"),
                                       ("diffusers", "WanTransformer3DModel")])
def test_unported_wan_files_refused_by_name(tmp_path, case, word):
    """A Wan2.2 I2V or TI2V file, a VACE file, a Wan2.1 I2V file at T2V's 16
    channels (``img_emb``) and a diffusers-named Wan transformer are refused
    by name when loaded."""
    from sdtpu.io.safetensors import save_safetensors
    from sdtpu_torch.io.model_loader import load_model_bundle

    in_dim = {"i2v": 36, "ti2v": 48}.get(case, 16)
    t = {"patch_embedding.weight": np.zeros((128, in_dim, 1, 2, 2), np.float32),
         "blocks.0.cross_attn.q.weight": np.zeros((128, 128), np.float32)}
    if case == "vace":
        t["vace_blocks.0.before_proj.weight"] = np.zeros((128, 128), np.float32)
    if case == "img_emb":
        t["img_emb.proj.1.weight"] = np.zeros((8, 8), np.float32)
    if case == "diffusers":
        t = {"condition_embedder.text_embedder.linear_1.weight": np.zeros((8, 8), np.float32),
             "patch_embedding.weight": t["patch_embedding.weight"]}
    path = str(tmp_path / "wan.safetensors")
    save_safetensors(path, t)
    with pytest.raises(NotImplementedError, match=word):
        load_model_bundle(diffusion_model_path=path)


# ------------------------------------------------------------- the DiT

FORWARD_CASES = {
    "t2v": ((2, 3, 6, 10), ()),
    # an odd height: the patch grid padded, the output cropped back
    "padded": ((1, 2, 5, 8), ()),
    "skip_layers": ((2, 2, 4, 6), (1,)),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_wan_forward_matches_jax(case):
    (b, t, h, w), skip = FORWARD_CASES[case]
    jp = _perturbed(jw.init_wan_params(_j(TSMALL), seed=3), 11)
    tp = from_jax_params(jp, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, t, h, w, TSMALL.in_dim), dtype=np.float32)
    ts = np.asarray([999.0, 321.5][:b], np.float32)
    ctx = rng.standard_normal((b, 7, TSMALL.text_dim), dtype=np.float32)
    jfwd = jax.jit(lambda *a: jw.wan_forward(*a, cfg=_j(TSMALL), skip_layers=skip))
    want = jfwd(jp, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    got = tw.wan_forward(tp, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                         cfg=TSMALL, skip_layers=skip)
    assert got.shape == want.shape == x.shape[:-1] + (TSMALL.out_dim,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if skip:  # the skipped block is out of the path
        full = tw.wan_forward(tp, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                              cfg=TSMALL)
        assert _rel(full.numpy(), want) > 1e-3


def test_plain_attention_matches_jax_flash_at_the_cross_attention_shape():
    """The port's plain attention (the CPU side of ``ops.attention``) against
    the JAX flash in interpret mode at Wan's cross-attention: a ragged query
    count over UMT5's 512 keys at head dim 128."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 2, 300, 128), dtype=np.float32)
    k, v = (rng.standard_normal((1, 2, 512, 128), dtype=np.float32) for _ in range(2))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = plain_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def _meta(specs):
    return {k: torch.empty(shape, device="meta") for k, (shape, _) in specs.items()}


def test_calls_count_the_bench_request(monkeypatch):
    """At full width on the meta device (shapes only): one Wan2.1-1.3B
    forward at 832x480 over 9 latent frames under CFG makes
    ``chip_smoke.WAN_ATTENTION_CALLS`` attention calls at D 128 (30
    self-attentions over 9 x 30 x 52 = 14040 tokens, 30 cross-attentions
    over UMT5's 512); one prompt encode ``chip_smoke.WAN_T5_LINEARS`` UMT5
    linears over 512 tokens (the 4-bit matmul's M = 512 calls)."""
    import chip_smoke

    seen = []

    def counting(q, k, v, *a, **kw):
        seen.append((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
        return torch.empty_like(q)

    monkeypatch.setattr(tw, "attention", counting)
    cfg = tw.WAN21_T2V_1_3B_CONFIG
    out = tw.wan_forward(_meta(tw.param_specs(cfg)), torch.empty((2, 9, 60, 104, 16), device="meta"),
                         torch.empty((2,), device="meta"), torch.empty((2, 512, 4096), device="meta"),
                         cfg=cfg)
    assert out.shape == (2, 9, 60, 104, 16)
    assert len(seen) == chip_smoke.WAN_ATTENTION_CALLS == 60
    assert seen.count(chip_smoke.WAN_FLASH_SHAPES[0][:5]) == 30
    assert seen.count(chip_smoke.WAN_FLASH_SHAPES[1][:5]) == 30

    linears = []
    real_linear = tt5.linear

    def counted_linear(x, w, b=None):
        linears.append(x.shape[-2])
        return real_linear(x, w, b)

    monkeypatch.setattr(tt5, "linear", counted_linear)
    t5 = tt5.UMT5_XXL_CONFIG
    cond = tcond.WanConditioner(None, _meta(tt5.param_specs(t5)), t5, device="meta")
    c = cond.get_learned_condition("a corgi running on a beach")
    assert c.c_crossattn.shape == (1, 512, 4096)
    assert len(linears) == chip_smoke.WAN_T5_LINEARS == 168 and set(linears) == {512}


# ------------------------------------------------------------- the VAE


@pytest.fixture(scope="module")
def vae_params():
    jp = _perturbed(jwv.init_wan_vae_params(_j(TVAE), seed=2, decode_only=True), 4)
    return jp, from_jax_params(jp, device="cpu")


# the JAX decode compiled once a shape (op by op it recompiles every primitive)
_jdecode = jax.jit(lambda p, z: jwv.wan_vae_decode(p, z, _j(TVAE)))


def _latent(seed, t, h, w, c=4):
    return np.random.default_rng(seed).standard_normal((1, t, h, w, c), dtype=np.float32)


@pytest.mark.parametrize("t,h,w", [(1, 4, 6), (3, 4, 6), (4, 3, 5)])
def test_wan_vae_decode_matches_jax(vae_params, t, h, w):
    jp, tp = vae_params
    z = _latent(t, t, h, w)
    want = _jdecode(jp, jnp.asarray(z))
    got = twv.wan_vae_decode(tp, torch.from_numpy(z), TVAE)
    assert got.shape == want.shape == (1, 1 + 4 * (t - 1), 8 * h, 8 * w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t", [1, 2, 3])
def test_wan_vae_decode_is_causal(vae_params, t):
    """Changing latent frame t leaves the output frames before 1 + 4(t - 1)
    (those of the latent frames before it) as they were, and changes the
    first of its own."""
    _, tp = vae_params
    z = torch.from_numpy(_latent(9, 4, 3, 4))
    z2 = z.clone()
    z2[:, t] += 1.0
    a, b = twv.wan_vae_decode(tp, z, TVAE), twv.wan_vae_decode(tp, z2, TVAE)
    first = 1 + 4 * (t - 1)
    assert torch.equal(a[:, :first], b[:, :first])
    assert (a[:, first] - b[:, first]).abs().max() > 1e-4


def test_full_vae_specs_match_jax():
    """The whole Wan VAE, encoder first (``init_wan_vae_params(
    decode_only=False)``), by name and shape."""
    want = jparam_specs(jwv.init_wan_vae_params, jwv.WAN21_VAE_CONFIG, 0, decode_only=False)
    got = twv.param_specs(twv.WAN21_VAE_CONFIG, decode_only=False)
    assert {k: tuple(v.shape) for k, v in want.items()} == {k: s for k, (s, _) in got.items()}
    assert any(k.startswith("encoder.") for k in got)


@pytest.fixture(scope="module")
def full_vae_params():
    jp = _perturbed(jwv.init_wan_vae_params(_j(TVAE), seed=6, decode_only=False), 7)
    return jp, from_jax_params(jp, device="cpu")


_jencode = jax.jit(lambda p, x: jwv.wan_vae_encode(p, x, _j(TVAE)))


@pytest.mark.parametrize("t,h,w", [(1, 32, 48), (5, 24, 16)])
def test_wan_vae_encode_matches_jax(full_vae_params, t, h, w):
    """The posterior mean of an image (one frame: the temporal downsamples
    pass it through) and of a 5-frame clip (5 → 3 → 2 frames), rtol = atol
    = 1e-4 as the decode."""
    jp, tp = full_vae_params
    x = np.random.default_rng(t * h).uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32)
    want = _jencode(jp, jnp.asarray(x))
    got = twv.wan_vae_encode(tp, torch.from_numpy(x), TVAE)
    assert got.shape == want.shape == (1, 1 + (t - 1) // 4, h // 8, w // 8, TVAE.z_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_latent_statistics_round_trip():
    z = _latent(3, 2, 3, 4, c=16)
    for fn_t, fn_j in ((twv.diffusion_to_vae_latents, jwv.diffusion_to_vae_latents),
                       (twv.vae_to_diffusion_latents, jwv.vae_to_diffusion_latents)):
        np.testing.assert_allclose(fn_t(torch.from_numpy(z)).numpy(), np.asarray(fn_j(jnp.asarray(z))),
                                   rtol=1e-6, atol=1e-6)
    zt = torch.from_numpy(z)
    np.testing.assert_allclose(twv.vae_to_diffusion_latents(twv.diffusion_to_vae_latents(zt)).numpy(),
                               z, rtol=1e-5, atol=1e-5)
    assert twv.diffusion_to_vae_latents(zt.to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("frames,overlap,t", [(2, 1, 5), (3, 1, 4), (3, 2, 6), (4, 0, 7), (8, 1, 5)])
def test_tiled_decode_temporal_matches_jax(vae_params, frames, overlap, t):
    """Windows of ``frames`` latent frames, ``overlap`` of context dropped
    after the first, against the JAX function on each package's decode (at
    overlap 0 each window's first latent frame decodes to one frame, as in
    the JAX package: 4 + 3 latent frames give 13 + 9)."""
    jp, tp = vae_params
    z = _latent(t, t, 3, 4)
    want = jtiling.tiled_decode_temporal(lambda zz: _jdecode(jp, jnp.asarray(zz)), z,
                                         frames=frames, overlap=overlap, temporal_scale=4)
    got = ttiling.tiled_decode_temporal(lambda zz: twv.wan_vae_decode(tp, zz, TVAE),
                                        torch.from_numpy(z), frames=frames, overlap=overlap,
                                        temporal_scale=4)
    n = 1 + 4 * (t - 1) if overlap else 22
    assert got.shape == want.shape == (1, n, 24, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tile,overlap", [(4, 2), (3, 1)])
def test_tiled_decode_5d_matches_jax(vae_params, tile, overlap):
    """The spatial tiling of a video latent [B, T, h, w, C] (feathered tiles
    whose frame count the decode changes), against the JAX function."""
    jp, tp = vae_params
    z = _latent(1, 2, 6, 9)
    want = jtiling.tiled_decode(lambda zz: _jdecode(jp, zz), z, tile=tile, overlap=overlap)
    got = ttiling.tiled_decode(lambda zz: twv.wan_vae_decode(tp, zz, TVAE), torch.from_numpy(z),
                               tile=tile, overlap=overlap)
    assert got.shape == want.shape == (1, 5, 48, 72, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- conditioner


@pytest.fixture(scope="module")
def jpipe():
    return jax_create_pipeline(jconfig.SDVersion.WAN2, small=True, seed=0)


@pytest.fixture(scope="module")
def t5_tokenizers(tmp_path_factory):
    """The same 256-piece unigram vocab as each package's T5 tokenizer."""
    from sdtpu.tokenizers.t5 import T5UnigramTokenizer as JT5
    from sdtpu_torch.tokenizers.t5 import T5UnigramTokenizer as TT5
    from sdtpu_torch.tools.flux_files import synthetic_t5_vocab

    md = synthetic_t5_vocab(256, seed=3)
    path = tmp_path_factory.mktemp("umt5tok") / "tokenizer.json"
    path.write_text(json.dumps({"model": {"type": "Unigram", "unk_id": 2, "vocab": [
        [p, s] for p, s in zip(md["tokenizer.ggml.tokens"], md["tokenizer.ggml.scores"])]}}))
    return TT5.from_tokenizer_json(str(path)), JT5.from_tokenizer_json(str(path))


@pytest.mark.parametrize("text,tok", [
    ("a corgi running on a beach", False),
    # a short prompt: most of the 32 tokens masked, their states zeroed
    ("a corgi running on a beach", True),
    # weighted spans; more tokens than the sequence holds
    ("a (red:1.4) fox in [fresh] snow, golden hour, " + "soft light, " * 6, True),
])
def test_wan_conditioner_matches_jax(jpipe, t5_tokenizers, text, tok):
    """UMT5 over the 32-token sequence under its attention mask, the token
    weights, the masked states zeroed; without a tokenizer all-zero ids and
    a full mask."""
    jc = jpipe.conditioner
    ttok, jtok = t5_tokenizers if tok else (None, None)
    want = jcond.WanConditioner(jtok, jc.pt, jc.ct, seq_len=T5_SEQ).get_learned_condition(text)
    cond = tcond.WanConditioner(ttok, from_jax_params(jc.pt, device="cpu"), TT5, seq_len=T5_SEQ,
                                device="cpu")
    got = cond.get_learned_condition(text)
    w = np.asarray(want.c_crossattn)
    assert got.c_crossattn.shape == w.shape == (1, T5_SEQ, TT5.d_model) and got.c_vector is None
    np.testing.assert_allclose(got.c_crossattn.numpy(), w, rtol=1e-5, atol=1e-5)
    if tok:  # the states past the end-of-sequence id are zero, none before it
        ids = got.t5_ids
        n = ids.index(ttok.eos_token_id) + 1 if ttok.eos_token_id in ids else T5_SEQ
        assert 1 < n and (n < T5_SEQ) == ("soft" not in text)
        assert not np.abs(w[0, n:]).any() and np.abs(w[0, :n]).max(axis=-1).min() > 0
    else:
        assert got.t5_ids == [0] * T5_SEQ


# ------------------------------------------------------------- pipeline


@pytest.fixture(scope="module")
def pipes(jpipe):
    c = jpipe.conditioner
    params = {"diffusion": from_jax_params(jpipe.diffusion_params, device="cpu"),
              "t5": from_jax_params(c.pt, device="cpu"),
              "vae": from_jax_params(jpipe.vae_params, device="cpu")}
    return jpipe, create_pipeline(SDVersion.WAN2, params=params, small=True, device="cpu")


def _gp(**kw):
    base = dict(prompt="a golden retriever", width=64, height=64, sample_steps=2, cfg_scale=4.0,
                seed=11, sample_method="euler")
    base.update(kw)
    return GenerationParams(**base)


def _jgp(gp):
    return jconfig.GenerationParams(**dataclasses.asdict(gp))


def test_reproduces_wan2_golden_latents(pipes):
    """``tests/test_golden_latents.py``'s ``wan2_euler`` case: 64², 5
    frames (2 latent frames), 2 euler steps, CFG 4, flow shift 5."""
    _, tp = pipes
    assert tp.denoiser.shift == 5.0 and tp.temporal_scale == 4
    res = tp.generate_video(_gp(), frames=5)
    want = np.load(GOLDEN)["latents"]
    assert res.latents.shape == want.shape == (1, 2, 8, 8, 4)
    np.testing.assert_allclose(res.latents, want, rtol=5e-4, atol=5e-4)
    assert res.frames.shape == (1, 5, 64, 64, 3) and res.frames.dtype == np.uint8
    assert set(tp.last_timings) == {"cond", "sample", "decode", "total", "steps", "frames"}


@pytest.mark.parametrize("kw", [
    # the bench's request (bench_wan21_t2v), cut to 64x48, 7 frames (rounded
    # down to 5) and 3 steps, with its tiling: temporal windows of 5 with
    # overlap 1 (one window here) and spatial tiles
    dict(prompt="a corgi running on a beach", negative_prompt="static", width=64, height=48,
         sample_steps=3, cfg_scale=6.0, seed=42, frames=7,
         tiling=dict(tile_size=4, overlap=2, temporal=True,
                     extra_tiling_args="temporal_tile_frames=5,temporal_tile_overlap=1")),
    # 13 frames (4 latent frames) in temporal windows of 2 with overlap 1,
    # euler_a's noise, a batch of two, a flow shift, no spatial tiling
    dict(sample_method="euler_a", eta=1.0, batch_count=2, frames=13, flow_shift=3.0,
         tiling=dict(tile_size=64, overlap=8, temporal=True,
                     extra_tiling_args="temporal_tile_frames=2,temporal_tile_overlap=1")),
    # no CFG, a wide clip, no tiling
    dict(cfg_scale=1.0, width=96, frames=9, sample_steps=3),
], ids=["bench_tiled", "euler_a_batch_temporal", "no_cfg"])
def test_wan_pipeline_matches_jax(pipes, kw):
    jp, tp = pipes
    kw = dict(kw)
    tiling, frames, shift = kw.pop("tiling", None), kw.pop("frames"), kw.pop("flow_shift", None)
    if shift is not None:
        tp = create_pipeline(SDVersion.WAN2, params={"diffusion": tp.diffusion_params,
                                                     "t5": tp.conditioner.pt, "vae": tp.vae_params},
                             small=True, device="cpu", flow_shift=shift)
        jp = jax_create_pipeline(jconfig.SDVersion.WAN2, small=True, seed=0, flow_shift=shift)
    for p in (jp, tp):
        p.set_vae_tiling(tiling is not None, **(tiling or {}))
    try:
        gp = _gp(**kw)
        want, got = jp.generate_video(_jgp(gp), frames=frames), tp.generate_video(gp, frames=frames)
    finally:
        for p in (jp, tp):
            p.set_vae_tiling(False)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert got.frames.shape == want.frames.shape and got.frames.std() > 0
    assert np.abs(got.frames.astype(int) - want.frames.astype(int)).max() <= 1
    assert tp.last_timings["frames"] == got.frames.shape[1] == 1 + 4 * ((frames - 1) // 4)


def test_generate_video_refuses_unported_inputs_by_name(pipes):
    _, tp = pipes
    gp = _gp(sample_steps=1)
    for kw in (dict(init_image=np.zeros((64, 64, 3), np.uint8)), dict(high_noise_params={}),
               dict(control_frames=[]), dict(preview_callback=print), dict(high_noise_steps=2),
               dict(moe_boundary=0.9)):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            tp.generate_video(gp, frames=5, **kw)


def test_synthesized_small_wan_pipeline_runs():
    """Random weights drawn by the port itself, the default dtype, float32."""
    tp = create_pipeline(SDVersion.WAN2, small=True, seed=3, device="cpu")
    assert tp.compute_dtype == torch.float32 and tp.latent_channels == 4
    res = tp.generate_video(_gp(sample_steps=2, cfg_scale=6.0), frames=5)
    assert res.frames.shape == (1, 5, 64, 64, 3) and np.isfinite(res.latents).all()
    assert res.frames.std() > 0


def test_wan_split_modules_matches_jax(jpipe, tmp_path):
    """A Wan file set as a user passes it (``--diffusion-model``, ``--vae``,
    ``--t5xxl`` as a q8_0 GGUF under llama.cpp names, a per-layer relative
    bias in each UMT5 block): the port's bundle equals the JAX one by value."""
    from sdtpu.io.gguf import save_gguf
    from sdtpu.io.model_loader import load_model_bundle as jload
    from sdtpu.io.safetensors import save_safetensors
    from sdtpu_torch.io.model_loader import load_model_bundle
    from sdtpu_torch.tools.flux_files import gguf_t5_name, synthetic_t5_vocab

    paths = {"diffusion_model_path": str(tmp_path / "wan.safetensors"),
             "vae_path": str(tmp_path / "wan_vae.safetensors"),
             "t5xxl_path": str(tmp_path / "umt5.gguf")}
    save_safetensors(paths["diffusion_model_path"],
                     {k: np.asarray(v, np.float32) for k, v in jpipe.diffusion_params.items()})
    save_safetensors(paths["vae_path"], {k: np.asarray(v, np.float32) for k, v in jpipe.vae_params.items()})
    save_gguf(paths["t5xxl_path"], {gguf_t5_name(k): np.asarray(v, np.float32)
                                    for k, v in jpipe.conditioner.pt.items()},
              out_type="q8_0", metadata=synthetic_t5_vocab(256))
    got, want = load_model_bundle(**paths), jload(**paths)
    assert got.version.value == want.version.value == "wan2"
    for m in ("diffusion", "vae", "t5"):
        g, w = getattr(got, m), getattr(want, m)
        assert sorted(g) == sorted(w), m
        for k, v in w.items():
            np.testing.assert_array_equal(np.asarray(g[k], np.float32), np.asarray(v, np.float32),
                                          err_msg=f"{m}.{k}")
    assert "encoder.block.1.layer.0.SelfAttention.relative_attention_bias.weight" in got.t5
