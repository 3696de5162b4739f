"""The port's GGUF keep-quant path against ``sdtpu``: group-dequant and W8A16
matmuls, host-block staging, per-row requant, and the slice end to end.

* (a) ``group_quant_matmul`` (groups 16 and 32, symmetric and affine) is held
  to the JAX XLA form and to the Pallas kernels run interpreted
  (``_gq_matmul_kernel``, ``_gq_matmul_ws_kernel`` with ``SDTPU_GQ_WS=1`` and a
  small ``block_m``, ``_gq_zero_matmul_kernel``) at ``TOL``, rtol = atol =
  1e-5 in f32 (float32 sums in another order, far inside it); the XLA form
  also at one and two rows of K = 3072, the shape of the card's GEMV.
* (b) W8A16 ``quant_matmul`` (``SDTPU_QUANT_MODE=w8a16``) against
  ``_q_matmul_kernel`` interpreted, at ``TOL``, also at one row of K = 3072.
* (c) ``from_host_quant`` for every ggml type with an extractor: the same
  class, group and values as the JAX staging of the same blocks.
* (d) ``rowwise_requant_from_host_quant``: bit-equal.
* (e) ``from_jax_params`` of a ``GroupQuantTensor``: by value.
* (f) the small FLUX DiT written with ``save_gguf`` as q8_0 and as q4_1,
  loaded with each package's ``load_model_bundle(keep_quant=True)``, staged
  by both packages (``min_size=1`` so the small widths quantize) and run through both
  pipelines from one seed: latents at the golden tolerance, rtol = atol = 5e-4;
  and a file cut to one double and one single block, through
  ``load_flux_diffusion`` and ``create_pipeline(params=...)``, against the
  JAX DiT run at that depth.
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sdtpu.ops.attention  # noqa: F401 — registers the module
import sdtpu.models.flux as jflux
import sdtpu.ops.quant as jq
import sdtpu.config as jconfig
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu.io.gguf import (BLOCK_INFO, EXTRACT_FNS, GGML_Q2_K, GGML_Q3_K, GGML_Q4_0, GGML_Q4_1,
                           GGML_Q4_K, GGML_Q5_0, GGML_Q5_1, GGML_Q5_K, GGML_Q6_K, GGML_Q8_0,
                           extract_blocks, save_gguf)
from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.factory import create_pipeline
from sdtpu_torch.io.model_loader import load_model_bundle
from sdtpu_torch.loader import diffusion_to_device, load_flux_diffusion
from sdtpu_torch.ops import quant as tq
from sdtpu_torch.weights import from_jax_params

att = sys.modules["sdtpu.ops.attention"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def tpu_branch_interpret(monkeypatch):
    """Force the TPU kernel branch but execute pallas_call interpreted."""
    monkeypatch.setattr(att, "_FORCE_PLATFORM", "tpu")
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        kw.pop("cost_estimate", None)
        return orig(*a, **kw)

    monkeypatch.setattr(jq.pl, "pallas_call", patched)
    monkeypatch.delenv("SDTPU_DISABLE_QUANT_KERNEL", raising=False)
    monkeypatch.delenv("SDTPU_GQ_WS", raising=False)


def _jax_group_tensor(rng, n, k, group, affine):
    """A JAX GroupQuantTensor ([Kp, N] layout) with random blocks, scales
    and zeros: every group differs."""
    q = rng.integers(-127, 128, size=(k, n), dtype=np.int8)
    scale = rng.uniform(1e-4, 1e-3, size=(k // group, n)).astype(np.float32)
    zero = rng.uniform(0, 1e-2, size=(k // group, n)).astype(np.float32) if affine else None
    return jq.GroupQuantTensor(q=jnp.asarray(q), scale=jnp.asarray(scale),
                               zero=None if zero is None else jnp.asarray(zero), k=k, group=group)


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("affine", [False, True])
# (1, 3072, 48): the modulation linears' K at M = 1, the shape the card's
# GEMV takes (x carries a batch of two, so two rows)
@pytest.mark.parametrize("m,k,n", [(5, 256, 48), (70, 1024, 136), (1, 3072, 48)])
def test_group_quant_matmul_matches_xla_form(group, affine, m, k, n):
    rng = np.random.default_rng(group + m)
    qj = _jax_group_tensor(rng, n, k, group, affine)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    want = np.asarray(jq.group_quant_matmul(jnp.asarray(x), qj))
    got = tq.group_quant_matmul(torch.from_numpy(x), from_jax_params({"w": qj}, device="cpu")["w"])
    assert got.shape == (2, m, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("form", ["gq", "gq_ws", "gq_zero"])
def test_group_quant_matmul_matches_pallas_kernels(tpu_branch_interpret, monkeypatch, group, form):
    """gq: one M tile; gq_ws: three M tiles of 128 rows (weight-stationary
    grid, ragged M); gq_zero: affine weights.  K = 1024 is two K steps."""
    m, k, n = (300, 1024, 136) if form == "gq_ws" else (100, 1024, 136)
    if form == "gq_ws":
        monkeypatch.setenv("SDTPU_GQ_WS", "1")
    rng = np.random.default_rng(group)
    qj = _jax_group_tensor(rng, n, k, group, affine=form == "gq_zero")
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jq.group_quant_matmul(jnp.asarray(x), qj, block_m=128, ws_block_n=128))
    got = tq.group_quant_matmul(torch.from_numpy(x), from_jax_params({"w": qj}, device="cpu")["w"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# (300, 1024, 640): two M tiles, two K steps, two N tiles; (1, 3072, 640):
# one row at the modulation linears' K, the shape the card's GEMV takes
@pytest.mark.parametrize("m,k,n", [(300, 1024, 640), (1, 3072, 640)])
def test_w8a16_matches_pallas_kernel(tpu_branch_interpret, monkeypatch, m, k, n):
    monkeypatch.setenv("SDTPU_QUANT_MODE", "w8a16")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qj = jq.quantize_per_channel(rng.standard_normal((n, k)).astype(np.float32) * 0.02)
    want = np.asarray(jq.quant_matmul(jnp.asarray(x), qj))
    got = tq.quant_matmul(torch.from_numpy(x), from_jax_params({"w": qj}, device="cpu")["w"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# byte spans holding f16 floats inside one block, per type (the rest is
# integer payload, so random bytes are valid blocks)
F16_SPANS = {
    GGML_Q4_0: [(0, 2)], GGML_Q4_1: [(0, 2), (2, 4)], GGML_Q5_0: [(0, 2)],
    GGML_Q5_1: [(0, 2), (2, 4)], GGML_Q8_0: [(0, 2)], GGML_Q2_K: [(80, 82), (82, 84)],
    GGML_Q3_K: [(108, 110)], GGML_Q4_K: [(0, 2), (2, 4)], GGML_Q5_K: [(0, 2), (2, 4)],
    GGML_Q6_K: [(208, 210)],
}


def _host_quant(ggml_type, n, k, seed):
    block_elems, block_bytes = BLOCK_INFO[ggml_type]
    nb = n * k // block_elems
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(nb, block_bytes), dtype=np.uint8)
    for lo, hi in F16_SPANS[ggml_type]:
        raw[:, lo:hi] = (rng.standard_normal(nb) * 0.05).astype(np.float16).view(np.uint8).reshape(nb, 2)
    return extract_blocks(raw.reshape(-1), ggml_type, n * k, (n, k))


def _dense(t):
    """Either package's quantized tensor → float32 numpy [N, K]."""
    if isinstance(t, tq.Q4Tensor):
        return tq.dequantize_q4(t, torch.float32).numpy()
    if isinstance(t, tq.GroupQuantTensor):
        return tq.dequantize_group(t, torch.float32).numpy()
    if isinstance(t, tq.QuantTensor):
        return tq.dequantize(t, torch.float32).numpy()
    dq = {"Q4Tensor": jq.dequantize_q4, "GroupQuantTensor": jq.dequantize_group,
          "QuantTensor": jq.dequantize}[type(t).__name__]
    return np.asarray(dq(t, jnp.float32))


def test_every_ggml_type_has_an_extractor_case():
    assert set(F16_SPANS) == set(EXTRACT_FNS)


@pytest.mark.parametrize("ggml_type", sorted(EXTRACT_FNS))
@pytest.mark.parametrize("k", [256, 512])
def test_from_host_quant_matches_jax_by_value(ggml_type, k):
    """K = 512 packs the symmetric 4-bit-range types (q4_0: group 32, q3_k:
    group 16) to Q4Tensor; K = 256 keeps them int8."""
    h = _host_quant(ggml_type, 6, k, seed=ggml_type)
    want = jq.from_host_quant(h)
    got = tq.from_host_quant(h, device="cpu")
    assert type(got).__name__ == type(want).__name__
    assert (got.k, got.group) == (want.k, want.group) == (k, h.group)
    assert (getattr(got, "zero", None) is None) == (h.zero is None)
    np.testing.assert_array_equal(_dense(got), _dense(want))
    np.testing.assert_array_equal(_dense(got), h.dequantize())


def test_from_host_quant_refuses_a_ragged_group():
    h = extract_blocks(np.zeros(34 * 3, np.uint8), GGML_Q8_0, 96, (2, 48))  # K = 48, group 32
    with pytest.raises(ValueError):
        tq.from_host_quant(h, device="cpu")


def test_rowwise_requant_bit_equal():
    h = _host_quant(GGML_Q8_0, 12, 512, seed=1)
    h.q[:512] = 0  # an all-zero row: scale 1
    want = jq.rowwise_requant_from_host_quant(h)
    got = tq.rowwise_requant_from_host_quant(h, device="cpu")
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("affine", [False, True])
def test_from_jax_params_group_quant_by_value(affine):
    rng = np.random.default_rng(4)
    if affine:
        qj = _jax_group_tensor(rng, 24, 96, 16, affine=True)
    else:
        qj = jq.quantize_group(rng.standard_normal((24, 100)).astype(np.float32))  # K padded
    got = from_jax_params({"w": qj}, device="cpu")["w"]
    assert isinstance(got, tq.GroupQuantTensor) and got.shape == qj.shape
    assert got.q.is_contiguous() and got.q.shape == (24, np.asarray(qj.q).shape[0])
    np.testing.assert_array_equal(_dense(got), _dense(qj))


def test_quantize_group_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((16, 72)).astype(np.float32)
    w[3] = 0.0
    want = jq.quantize_group(w)
    got = tq.quantize_group(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q).T)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale).T)


# ------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def small_flux():
    jp = jax_create_pipeline(jconfig.SDVersion.FLUX, small=True, seed=0)
    dense = {k: np.asarray(v) for k, v in jp.diffusion_params.items()}
    return jp, dense


@pytest.fixture(scope="module")
def gguf_files(small_flux, tmp_path_factory):
    _, dense = small_flux
    d = tmp_path_factory.mktemp("gguf")
    paths = {}
    for qtype in ("q8_0", "q4_1"):
        paths[qtype] = str(d / f"flux_small_{qtype}.gguf")
        save_gguf(paths[qtype], dense, out_type=qtype)
    return paths


def _classes(params):
    return {k: type(v).__name__ for k, v in params.items()}


@pytest.mark.parametrize("qtype,want_class", [("q8_0", "GroupQuantTensor"),
                                              ("q4_1", "GroupQuantTensor")])
def test_gguf_flux_pipeline_matches_jax(small_flux, gguf_files, qtype, want_class):
    jp, _ = small_flux
    dj = jax_load_model_bundle(diffusion_model_path=gguf_files[qtype], keep_quant=True).diffusion
    d = load_model_bundle(diffusion_model_path=gguf_files[qtype], keep_quant=True).diffusion
    staged_j = jq.host_params_to_device(dj, min_size=1, rowwise=False)
    staged_t = diffusion_to_device(d, torch.float32, "cpu", promote_q8=False, min_size=1)
    assert _classes(staged_t) == {k: ("Tensor" if type(v).__name__ == "ndarray" else
                                      type(v).__name__) for k, v in staged_j.items()}
    quantized = [k for k, v in staged_t.items() if type(v).__name__ == want_class]
    assert len(quantized) > 30
    assert all((staged_t[k].zero is None) == (qtype == "q8_0") for k in quantized)

    jparams = {k: v if type(v).__name__ == "GroupQuantTensor" else jnp.asarray(v, jnp.float32)
               for k, v in staged_j.items()}
    gp = GenerationParams(prompt="a red fox", width=64, height=64, sample_steps=2,
                          cfg_scale=1.0, guidance=3.5, seed=13, sample_method="euler")
    original = jp.diffusion_params
    jp.diffusion_params = jparams
    try:
        want = jp.generate(jconfig.GenerationParams(**dataclasses.asdict(gp)))
    finally:
        jp.diffusion_params = original
    tp = create_pipeline(SDVersion.FLUX, small=True, device="cpu", params={
        "diffusion": staged_t, "clip_l": from_jax_params(jp.conditioner.pl, device="cpu"),
        "t5": from_jax_params(jp.conditioner.pt, device="cpu"),
        "vae": from_jax_params(jp.vae_params, device="cpu")})
    got = tp.generate(gp)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)


def test_q8_promotion_matches_jax_rowwise(gguf_files):
    dj = jax_load_model_bundle(diffusion_model_path=gguf_files["q8_0"], keep_quant=True).diffusion
    d = load_model_bundle(diffusion_model_path=gguf_files["q8_0"], keep_quant=True).diffusion
    staged_j = jq.host_params_to_device(dj, min_size=1, rowwise=True)
    staged_t = diffusion_to_device(d, torch.float32, "cpu", promote_q8=True, min_size=1)
    rows = [k for k, v in staged_t.items() if isinstance(v, tq.QuantTensor)]
    assert len(rows) > 30
    for k in rows:
        np.testing.assert_array_equal(staged_t[k].q.numpy(), np.asarray(staged_j[k].q))
        np.testing.assert_array_equal(staged_t[k].scale.numpy(), np.asarray(staged_j[k].scale))


def test_load_flux_diffusion_defaults(gguf_files):
    """The loader's full-size eligibility (2**16 elements) leaves the small
    DiT dense, in the requested dtype; q8_0 is promoted by default."""
    p = load_flux_diffusion(gguf_files["q4_1"], dtype=torch.bfloat16, device="cpu")
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 for v in p.values())
    d = load_model_bundle(diffusion_model_path=gguf_files["q8_0"], keep_quant=True).diffusion
    staged = diffusion_to_device(d, device="cpu", min_size=1)
    assert isinstance(staged["double_blocks.0.img_mlp.0.weight"], tq.QuantTensor)
    assert staged["double_blocks.0.img_mlp.0.bias"].dtype == torch.bfloat16


def test_cut_depth_file_through_load_flux_diffusion(small_flux, tmp_path):
    """``create_pipeline`` runs a given DiT at the depth its params hold."""
    jp, dense = small_flux
    cut = {k: v for k, v in dense.items()
           if not k.startswith(("double_blocks.1.", "single_blocks.1."))}
    path = str(tmp_path / "flux_small_1+1.gguf")
    save_gguf(path, cut, out_type="q8_0")
    jparams = {k: jnp.asarray(np.asarray(v), jnp.float32) for k, v in
               jax_load_model_bundle(diffusion_model_path=path, keep_quant=True).diffusion.items()}
    cfg = jflux.FluxConfig(in_channels=16, hidden_size=64, num_heads=2, depth=1, depth_single=1,
                           axes_dim=(8, 12, 12), context_in_dim=96, vec_in_dim=48,
                           guidance_embed=True)
    jp1 = jax_create_pipeline(jconfig.SDVersion.FLUX, small=True, seed=0, params={
        "diffusion": jparams, "clip_l": jp.conditioner.pl, "t5": jp.conditioner.pt,
        "vae": jp.vae_params})
    jp1.diffusion_fn = lambda p, x, t, ctx, y, guidance=None, **_: jflux.flux_forward(
        p, x, t, ctx, y, guidance=guidance, cfg=cfg)
    gp = GenerationParams(prompt="a red fox", width=64, height=64, sample_steps=2,
                          cfg_scale=1.0, guidance=3.5, seed=13, sample_method="euler")
    want = jp1.generate(jconfig.GenerationParams(**dataclasses.asdict(gp)))
    tp = create_pipeline(SDVersion.FLUX, small=True, device="cpu", params={
        "diffusion": load_flux_diffusion(path, dtype=torch.float32, device="cpu"),
        "clip_l": from_jax_params(jp.conditioner.pl, device="cpu"),
        "t5": from_jax_params(jp.conditioner.pt, device="cpu"),
        "vae": from_jax_params(jp.vae_params, device="cpu")})
    got = tp.generate(gp)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
