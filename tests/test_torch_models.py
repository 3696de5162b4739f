"""The port's models, configs, schedule and weight synthesis against ``sdtpu``.

Each model runs at the small FLUX configs of ``sdtpu/factory.py`` on weights
from the JAX init functions, bridged with ``from_jax_params``; float32 on
both sides (JAX at HIGHEST precision).  Tolerances: rtol 1e-4 / atol 1e-5 for
the encoders, the DiT and the VAE — float32 results of a few layers of
matmuls and convolutions whose sums run in another order (MKL against XLA),
observed at ~1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from sdtpu.diffusion.denoiser import FluxFlowDenoiser as JFluxDenoiser
from sdtpu.diffusion.schedule import get_sigmas as jget_sigmas
from sdtpu.models import clip as jclip
from sdtpu.models import flux as jflux
from sdtpu.models import t5 as jt5
from sdtpu.models import tiling as jtiling
from sdtpu.models import vae as jvae
from sdtpu.ops.quant import quantize_params
from sdtpu.utils.device_init import param_specs as jparam_specs
from sdtpu.utils.device_init import quantize_specs
from sdtpu_torch.diffusion.denoiser import FluxFlowDenoiser
from sdtpu_torch.diffusion.schedule import get_sigmas
from sdtpu_torch.factory import flux_configs
from sdtpu_torch.models import clip as tclip
from sdtpu_torch.models import flux as tflux
from sdtpu_torch.models import t5 as tt5
from sdtpu_torch.models import tiling as ttiling
from sdtpu_torch.models import vae as tvae
from sdtpu_torch.ops.quant import GroupQuantTensor, Q4Tensor, QuantTensor
from sdtpu_torch.weights import _quantizable, from_jax_params, synthesize

SMALL = flux_configs(small=True)
RTOL, ATOL = 1e-4, 1e-5


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.mark.parametrize("port,ref", [
    (tflux.FLUX_DEV_CONFIG, jflux.FLUX_DEV_CONFIG), (tflux.FLUX_SCHNELL_CONFIG, jflux.FLUX_SCHNELL_CONFIG),
    (tclip.CLIP_L_CONFIG, jclip.CLIP_L_CONFIG), (tt5.T5_XXL_CONFIG, jt5.T5_XXL_CONFIG),
    (tvae.FLUX_VAE_CONFIG, jvae.FLUX_VAE_CONFIG),
])
def test_configs_match(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_small_configs_match_jax_factory():
    from sdtpu.config import SDVersion
    from sdtpu.factory import create_pipeline

    jp = create_pipeline(SDVersion.FLUX, small=True, seed=0)
    dit, clip_cfg, t5_cfg, vae_cfg, t5_seq = SMALL
    assert dataclasses.asdict(clip_cfg) == dataclasses.asdict(jp.conditioner.cl)
    assert dataclasses.asdict(t5_cfg) == dataclasses.asdict(jp.conditioner.ct)
    assert jp.conditioner.t5_seq_len == t5_seq
    assert jp.latent_channels == vae_cfg.z_channels
    jd = {k: tuple(v.shape) for k, v in jp.diffusion_params.items()}
    assert jd == {k: s for k, (s, _) in tflux.param_specs(dit).items()}


def _specs(init_fn, *args, **kw):
    return {k: tuple(v.shape) for k, v in jparam_specs(init_fn, *args, **kw).items()}


@pytest.mark.parametrize("module", ["flux", "clip", "t5", "vae"])
def test_param_specs_match_jax_init_at_full_width(module):
    if module == "flux":
        want, got = _specs(jflux.init_flux_params, jflux.FLUX_DEV_CONFIG), tflux.param_specs(tflux.FLUX_DEV_CONFIG)
    elif module == "clip":
        want, got = _specs(jclip.init_clip_params, jclip.CLIP_L_CONFIG, 0), tclip.param_specs(tclip.CLIP_L_CONFIG)
    elif module == "t5":
        want, got = _specs(jt5.init_t5_params, jt5.T5_XXL_CONFIG), tt5.param_specs(tt5.T5_XXL_CONFIG)
    else:  # the port synthesizes the decoder half
        want = {k: s for k, s in _specs(jvae.init_vae_params, jvae.FLUX_VAE_CONFIG).items()
                if not k.startswith(("encoder.", "quant_conv."))}
        got = tvae.param_specs(tvae.FLUX_VAE_CONFIG)
    assert {k: s for k, (s, _) in got.items()} == want


@pytest.mark.parametrize("init_fn,jcfg,mode,specs,cls", [
    (jflux.init_flux_params, jflux.FLUX_DEV_CONFIG, "q8_0",
     tflux.param_specs(tflux.FLUX_DEV_CONFIG), QuantTensor),
    (jt5.init_t5_params, jt5.T5_XXL_CONFIG, "q4_0", tt5.param_specs(tt5.T5_XXL_CONFIG), Q4Tensor),
    (jflux.init_flux_params, jflux.FLUX_DEV_CONFIG, "q8_0_gguf",
     tflux.param_specs(tflux.FLUX_DEV_CONFIG), GroupQuantTensor),
])
def test_memory_classes_match_jax_synthesis(init_fn, jcfg, mode, specs, cls):
    """The same weights are quantized as in the JAX bench synthesis."""
    jspecs = quantize_specs(jparam_specs(init_fn, jcfg), mode=mode)
    want = {k for k, v in jspecs.items() if type(v).__name__ == cls.__name__}
    got = {k for k, (s, init) in specs.items() if _quantizable(k, s, init)}
    assert got == want and len(got) > 100


def test_synthesize_memory_classes_and_statistics():
    specs = tt5.param_specs(tt5.T5Config(vocab_size=256, d_model=256, d_kv=32, d_ff=512,
                                         num_layers=1, num_heads=8))
    q4 = synthesize(specs, quant="q4_0", seed=0, dtype=torch.float32, device="cpu")
    q8 = synthesize(specs, quant="q8_0", seed=0, dtype=torch.float32, device="cpu")
    gg = synthesize(specs, quant="q8_0_gguf", seed=0, dtype=torch.float32, device="cpu")
    q4g = synthesize(specs, quant="q4_0", seed=0, dtype=torch.float32, device="cpu", group=32)
    name = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight"
    assert isinstance(q4[name], Q4Tensor) and isinstance(q8[name], QuantTensor)
    # the group sets the scale grid only: the nibbles drawn are the same
    assert q4[name].group == 64 and q4g[name].group == 32 and q4g[name].scale.shape == (512, 8)
    assert torch.equal(q4g[name].packed, q4[name].packed)
    with pytest.raises(ValueError):
        synthesize(specs, quant="q4_0", device="cpu", group=128)
    assert isinstance(gg[name], GroupQuantTensor) and gg[name].group == 32
    assert q4[name].shape == q8[name].shape == gg[name].shape == (512, 256)
    assert isinstance(q4["shared.weight"], torch.Tensor)  # embeddings stay dense
    assert torch.equal(q4["encoder.final_layer_norm.weight"], torch.ones(256))
    from sdtpu_torch.ops.quant import dequantize, dequantize_group, dequantize_q4
    for w in (dequantize_q4(q4[name], torch.float32), dequantize_q4(q4g[name], torch.float32),
              dequantize(q8[name], torch.float32), dequantize_group(gg[name]), q4["shared.weight"]):
        assert 0.015 < w.std().item() < 0.025  # ~N(0, 0.02) statistics


def test_rope_freqs_match():
    ids = np.stack([np.zeros(40, np.int64), np.arange(40) % 7, np.arange(40) // 7], axis=1)
    np.testing.assert_array_equal(tflux.rope_freqs(ids, (16, 56, 56), 10000),
                                  jflux.rope_freqs(ids, (16, 56, 56), 10000))


def _flux_inputs(seed, dit, b=2, hw=8, l_txt=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, dit.in_channels // 4), dtype=np.float32)
    ctx = rng.standard_normal((b, l_txt, dit.context_in_dim), dtype=np.float32)
    y = rng.standard_normal((b, dit.vec_in_dim), dtype=np.float32)
    t = np.asarray([0.9, 0.25][:b], dtype=np.float32)
    g = np.full((b,), 3.5, dtype=np.float32)
    return x, t, ctx, y, g


def _q4_params(params: dict, group: int, min_size: int) -> dict:
    """The JAX package's ``quantize_q4`` at ``group`` on every large 2-D
    weight (``quantize_params(bits=4)``'s rule, which fixes group 64)."""
    from sdtpu.ops.quant import quantize_q4

    return {k: quantize_q4(np.asarray(v), group=group)
            if np.ndim(v) == 2 and np.size(v) >= min_size and k.endswith(".weight") else v
            for k, v in params.items()}


@pytest.mark.parametrize("quant", [False, True, "q4_0"])
def test_flux_forward_matches(quant):
    """Dense, per-row int8 and q4_0 (4-bit at group 32, a q4_0 GGUF's
    grid; both sides dequantize the same nibbles and scales in float32)."""
    dit = SMALL[0]
    jcfg = jflux.FluxConfig(**dataclasses.asdict(dit))
    jp = jflux.init_flux_params(jcfg, seed=0)
    if quant == "q4_0":
        jp = _q4_params(jp, group=32, min_size=1 << 12)
        assert sum(type(v).__name__ == "Q4Tensor" for v in jp.values()) > 10
    elif quant:  # per-row int8 weights: W8A8 in the port, bit-equal per linear
        jp = quantize_params(jp, min_size=1 << 12)
    tp = from_jax_params(jp, device="cpu")
    if quant == "q4_0":
        assert {v.group for v in tp.values() if isinstance(v, Q4Tensor)} == {32}
    x, t, ctx, y, g = _flux_inputs(1, dit)
    fwd = jax.jit(lambda p, x, t, c, y, g: jflux.flux_forward(p, x, t, c, y, guidance=g, cfg=jcfg))
    if quant is True:  # JAX's CPU dispatch would dequantize int8 linears (W8A16): pin W8A8
        import unittest.mock

        from sdtpu.ops import quant as jq

        with unittest.mock.patch.object(jq, "quant_matmul", jq.quant_matmul_w8a8):
            want = fwd(jp, x, t, ctx, y, g)
    else:
        want = fwd(jp, x, t, ctx, y, g)
    got = tflux.flux_forward(tp, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                             torch.from_numpy(y), guidance=torch.from_numpy(g), cfg=dit)
    assert got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def test_clip_text_forward_matches():
    cfg = SMALL[1]
    jp = jclip.init_clip_params(jclip.CLIPTextConfig(**dataclasses.asdict(cfg)), 0)
    tp = from_jax_params(jp, device="cpu")
    ids = np.random.default_rng(2).integers(0, 1000, (2, 77)).astype(np.int32)
    ids[0, 9] = ids[1, 30] = cfg.eos_token_id
    jcfg = jclip.CLIPTextConfig(**dataclasses.asdict(cfg))
    for skip in (-1, 2):
        h_j, p_j = jax.jit(lambda p, i: jclip.clip_text_forward(
            p, i, jcfg, clip_skip=skip, return_pooled=True))(jp, ids)
        h_t, p_t = tclip.clip_text_forward(tp, torch.from_numpy(ids.astype(np.int64)), cfg,
                                           clip_skip=skip, return_pooled=True)
        np.testing.assert_allclose(_np(h_t), _np(h_j), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(p_t), _np(p_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("q4", [False, True])
def test_t5_encoder_matches(q4):
    cfg = SMALL[2]
    jcfg = jt5.T5Config(**dataclasses.asdict(cfg))
    if q4:  # d_model 128 keeps K a multiple of the 4-bit kernel's group
        cfg = dataclasses.replace(cfg, d_model=128, d_kv=32)
        jcfg = jt5.T5Config(**dataclasses.asdict(cfg))
    jp = jt5.init_t5_params(jcfg, seed=2)
    if q4:
        jp = quantize_params(jp, min_size=1 << 12, skip_patterns=("shared",), bits=4)
        assert any(type(v).__name__ == "Q4Tensor" for v in jp.values())
    tp = from_jax_params(jp, device="cpu")
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[1, 20:] = 0
    fwd = jax.jit(lambda p, i, m: jt5.t5_encoder_forward(p, i, jcfg, attention_mask=m))
    for m in (None, mask):
        want = fwd(jp, ids, m)
        got = tt5.t5_encoder_forward(tp, torch.from_numpy(ids.astype(np.int64)), cfg,
                                     attention_mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def vae_pair():
    cfg = SMALL[3]
    jcfg = jvae.VAEConfig(**dataclasses.asdict(cfg))
    jp = jvae.init_vae_params(jcfg, seed=0)
    return cfg, jcfg, jp, from_jax_params(jp, device="cpu")


def test_vae_decode_matches(vae_pair):
    cfg, jcfg, jp, tp = vae_pair
    z = np.random.default_rng(4).standard_normal((1, 6, 8, cfg.z_channels), dtype=np.float32)
    want = jax.jit(lambda p, z: jvae.vae_decode(p, z, jcfg))(jp, z)
    got = tvae.vae_decode(tp, torch.from_numpy(z), cfg)
    assert got.shape == (1, 48, 64, 3)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def test_tiled_decode_matches(vae_pair):
    cfg, jcfg, jp, tp = vae_pair
    z = np.random.default_rng(5).standard_normal((1, 12, 10, cfg.z_channels), dtype=np.float32)
    dec = jax.jit(lambda p, t: jvae.vae_decode(p, t, jcfg))
    want = jtiling.tiled_decode(lambda t: dec(jp, t), z, tile=8, overlap=2)
    got = ttiling.tiled_decode(lambda t: tvae.vae_decode(tp, t, cfg), torch.from_numpy(z),
                               tile=8, overlap=2)
    assert got.shape == (1, 96, 80, 3)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("steps", [1, 3, 20])
@pytest.mark.parametrize("scheduler,seq", [("discrete", 0), ("flux", 16), ("flux", 4096)])
def test_flux_sigma_schedule_matches(steps, scheduler, seq):
    want = jget_sigmas(JFluxDenoiser(), steps, scheduler=scheduler, image_seq_len=seq)
    got = get_sigmas(FluxFlowDenoiser(), steps, scheduler=scheduler, image_seq_len=seq)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_unported_pieces_raise():
    with pytest.raises(NotImplementedError):
        tflux.check_supported(tflux.FluxConfig(is_chroma=True))
    with pytest.raises(ValueError):
        get_sigmas(FluxFlowDenoiser(), 4, scheduler="karras")


def test_weight_bytes_counts_group_scales_and_zeros():
    from sdtpu_torch.ops.quant import GroupQuantTensor
    from sdtpu_torch.weights import weight_bytes

    q = torch.zeros((8, 64), dtype=torch.int8)
    s = torch.ones((8, 2))
    sym = GroupQuantTensor(q=q, scale=s, zero=None, k=64, group=32)
    affine = GroupQuantTensor(q=q, scale=s, zero=s.clone(), k=64, group=32)
    assert weight_bytes({"a": sym}) == 8 * 64 + 8 * 2 * 4
    assert weight_bytes({"a": sym, "b": affine, "c": torch.zeros(3, dtype=torch.bfloat16)}) == \
        2 * (8 * 64 + 8 * 2 * 4) + 8 * 2 * 4 + 6
