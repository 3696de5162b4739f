"""The port's quantized matmuls against ``sdtpu.ops.quant``.

* W8A8: the plain version accumulates exactly (float64 products of int8
  values) and applies the float32 epilogue in the JAX order (acc·s_x, then
  ·s_w), so it is held BIT-EQUAL to ``quant_matmul_w8a8`` in its XLA form and
  through the Pallas kernel forced on and interpreted.
* 4-bit: the JAX split-half layout is repacked into the port's layout by
  value (nibbles are integers: exact), and the plain matmul is held to
  ``q4_matmul`` (XLA form and forced-interpreted kernel) at float32 sum-order
  tolerance (rtol 1e-5 / atol 1e-5); groups 16 and 32 (a q3_k or q4_0 GGUF's
  own blocks) stage from ``HostQuant`` as the JAX package stages them.
  The bf16 split-K form's K split and ordered combine
  (``split_k_partials`` / ``combine_splits``) are held to both forms of
  ``q4_matmul`` at the same tolerance, at 1 to 4 splits.
* The float32 forms' arithmetic on the card (x split into two tf32 terms,
  integer weights, scales folded outside the products), emulated in plain
  PyTorch by ``chip_smoke.split_x_matmul``, holds the float32 limit against
  the plain versions at every weight mode, where one TF32 pass does not.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
import sdtpu.ops.attention  # noqa: F401 — registers the module
import sdtpu.ops.quant as jq
from sdtpu.io.gguf import BLOCK_INFO, GGML_Q3_K, GGML_Q4_0, extract_blocks, quantize_q4_0
from sdtpu.ops.basic import linear as jlinear
from sdtpu_torch.ops import quant as tq
from sdtpu_torch.ops.basic import linear
from sdtpu_torch.weights import from_jax_params, repack_q4

# sdtpu.ops re-exports a function named `attention`; fetch the module itself
att = sys.modules["sdtpu.ops.attention"]


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


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0, :] = 0.0  # one all-zero row: scale 1
    return x if dtype == "f32" else np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _port_x(x, dtype):
    t = torch.from_numpy(np.array(x))
    return t if dtype == "f32" else t.to(torch.bfloat16)


def _jax_x(x, dtype):
    a = jnp.asarray(x)
    return a if dtype == "f32" else a.astype(jnp.bfloat16)


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_bit_equal(dtype):
    rng = np.random.default_rng(0)
    x = _x(rng, (3, 7, 96), dtype) * 5
    q_j, s_j = jq.quantize_activations(_jax_x(x, dtype))
    q_t, s_t = tq.quantize_activations(_port_x(x, dtype))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_quantize_per_channel_bit_equal():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((40, 64)).astype(np.float32) * 0.05
    w[3] = 0.0
    want = jq.quantize_per_channel(w)
    got = tq.quantize_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tq.dequantize(got, torch.float32).numpy(),
                                  np.asarray(jq.dequantize(want, jnp.float32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (37, 96, 80), (5, 256, 24)])
def test_w8a8_plain_bit_equal_to_xla_form(dtype, m, k, n):
    rng = np.random.default_rng(2)
    x = _x(rng, (m, k), dtype)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.02
    qj = jq.quantize_per_channel(w)
    qt = from_jax_params({"w": qj}, device="cpu")["w"]
    want = jq.quant_matmul_w8a8(_jax_x(x, dtype), qj)
    got = tq.quant_matmul_w8a8(_port_x(x, dtype), qt)
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    np.testing.assert_array_equal(_as_np(got), _as_np(want))


def _ties_row(rng, k):
    """amax exactly 127 (s_x = 1), the other values at j + 0.5: x / s_x
    rounds half to even both ways (exact in bf16)."""
    row = rng.integers(-127, 127, size=k).astype(np.float32) + np.float32(0.5)
    row[0] = 127.0
    return row


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("k", [256, 272, 768])
def test_w8a8_plain_bit_equal_to_xla_form_at_gemv_shapes(dtype, m, k):
    """The rows the card's GEMV takes (M <= 8; K 256 and 768 are the DiT's
    embedder widths, 272 ends in a partial 64-byte segment): an all-zero row
    and a row of half-integer ties, each its own call at M = 1."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((48, k)).astype(np.float32) * 0.02
    qj = jq.quantize_per_channel(w)
    qt = from_jax_params({"w": qj}, device="cpu")["w"]
    zero_row = _x(rng, (m, k), dtype)  # row 0 all zero
    ties = np.array(_x(rng, (m, k), dtype))
    ties[-1] = _ties_row(rng, k)
    for x in (zero_row, ties):
        want = jq.quant_matmul_w8a8(_jax_x(x, dtype), qj)
        got = tq.quant_matmul_w8a8(_port_x(x, dtype), qt)
        np.testing.assert_array_equal(_as_np(got), _as_np(want))


@pytest.mark.parametrize("m,n,k", [
    (640, 384, 256),    # ragged M/N (the kernel pads both)
    (1280, 256, 2048),  # two K steps: int32 accumulation across the grid
])
def test_w8a8_plain_bit_equal_to_pallas_kernel(tpu_branch_interpret, monkeypatch, m, n, k):
    monkeypatch.setenv("SDTPU_W8A8_KERNEL", "1")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.02
    qj = jq.quantize_per_channel(w)
    want = np.asarray(jq.quant_matmul_w8a8(jnp.asarray(x), qj))
    got = tq.quant_matmul_w8a8(torch.from_numpy(x), from_jax_params({"w": qj}, device="cpu")["w"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_linear_dispatches_quant_tensor_to_w8a8():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((32, 64)).astype(np.float32) * 0.05
    b = rng.standard_normal((32,)).astype(np.float32)
    qj = jq.quantize_per_channel(w)
    want = jq.quant_matmul_w8a8(jnp.asarray(x), qj) + jnp.asarray(b)
    got = linear(torch.from_numpy(x), from_jax_params({"w": qj}, device="cpu")["w"], torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k,block_k", [(48, 1024, 512), (40, 700, 512), (24, 96, 512)])
def test_q4_repack_by_value(n, k, block_k):
    """Repacked 4-bit weights dequantize to exactly the JAX values."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    qj = jq.quantize_q4(w, block_k=block_k)
    qt = from_jax_params({"w": qj}, device="cpu")["w"]
    assert qt.shape == (n, k) and qt.packed.dtype == torch.uint8
    want = np.asarray(jq.dequantize_q4(qj, jnp.float32))
    np.testing.assert_array_equal(tq.dequantize_q4(qt, torch.float32).numpy(), want)


def test_q4_quantize_matches_jax_values():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((16, 200)).astype(np.float32) * 0.05
    want = np.asarray(jq.dequantize_q4(jq.quantize_q4(w), jnp.float32))
    got = tq.dequantize_q4(tq.quantize_q4(torch.from_numpy(w)), torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_repack_q4_reads_fields_directly():
    rng = np.random.default_rng(7)
    qj = jq.quantize_q4(rng.standard_normal((8, 512)).astype(np.float32))
    a = repack_q4(np.asarray(qj.packed), np.asarray(qj.scale), qj.k, qj.block_k, qj.group, device="cpu")
    b = from_jax_params({"w": qj}, device="cpu")["w"]
    assert torch.equal(a.packed, b.packed) and torch.equal(a.scale, b.scale)


@pytest.mark.parametrize("m,k,n,group", [
    pytest.param(3, 512, 40, 64, id="3-512-40"), pytest.param(70, 1024, 96, 64, id="70-1024-96"),
    # one modulation row at the DiT's K on a q4_0 GGUF's group-32 grid (the GEMV's case)
    pytest.param(1, 3072, 48, 32, id="1-3072-48-g32"),
    # float32 x at a q3_k-class group 16, K off the 64-wide tile (the float32 form's case)
    pytest.param(9, 600, 40, 16, id="9-600-40-g16")])
def test_q4_plain_matches_xla_form(m, k, n, group):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qj = jq.quantize_q4(rng.standard_normal((n, k)).astype(np.float32) * 0.05, group=group)
    want = np.asarray(jq.q4_matmul(jnp.asarray(x), qj))
    got = tq.q4_matmul(torch.from_numpy(x), from_jax_params({"w": qj}, device="cpu")["w"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_q4_plain_matches_pallas_kernel(tpu_branch_interpret):
    rng = np.random.default_rng(9)
    m, k, n = 100, 1024, 384
    x = rng.standard_normal((m, k)).astype(np.float32)
    qj = jq.quantize_q4(rng.standard_normal((n, k)).astype(np.float32) * 0.05)
    want = np.asarray(jq.q4_matmul(jnp.asarray(x), qj))
    got = tq.q4_matmul(torch.from_numpy(x), from_jax_params({"w": qj}, device="cpu")["w"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _split_combine(x, qj, splits):
    """The port's plain split-K partials of x · W over the bridged weight,
    combined in split order; checks the split count on the way."""
    qt = from_jax_params({"w": qj}, device="cpu")["w"]
    parts = tq.split_k_partials(torch.from_numpy(x), qt, splits)
    stages = -(-x.shape[1] // tq.Q4_K_MULTIPLE)
    assert len(parts) == -(-stages // -(-stages // splits))
    return tq.combine_splits(parts).numpy()


# the split-K form's rows (its first, T5 over SD3's 77 tokens, its last),
# every group, K off the 64-wide stage, N off the 128-row band
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("m", [9, 77, 127])
def test_q4_split_k_combine_matches_xla_form(m, group, splits):
    rng = np.random.default_rng(m + group + splits)
    k, n = 600, 37
    x = rng.standard_normal((m, k)).astype(np.float32)
    qj = jq.quantize_q4(rng.standard_normal((n, k)).astype(np.float32) * 0.05, group=group)
    want = np.asarray(jq.q4_matmul(jnp.asarray(x), qj))
    np.testing.assert_allclose(_split_combine(x, qj, splits), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("m", [9, 77, 127])
def test_q4_split_k_combine_matches_pallas_kernel(tpu_branch_interpret, m, group):
    rng = np.random.default_rng(m * group)
    k, n = 1040, 200
    x = rng.standard_normal((m, k)).astype(np.float32)
    qj = jq.quantize_q4(rng.standard_normal((n, k)).astype(np.float32) * 0.05, group=group)
    want = np.asarray(jq.q4_matmul(jnp.asarray(x), qj))
    np.testing.assert_allclose(_split_combine(x, qj, 3), want, rtol=1e-5, atol=1e-5)


def test_linear_dispatches_q4_tensor():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 4, 512)).astype(np.float32)
    qj = jq.quantize_q4(rng.standard_normal((24, 512)).astype(np.float32) * 0.05)
    want = np.asarray(jlinear(jnp.asarray(x), qj))
    got = linear(torch.from_numpy(x), from_jax_params({"w": qj}, device="cpu")["w"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)



def _q4_class_blocks(ggml_type, n, k, seed):
    """A q4_0 HostQuant quantized from random weights, or a q3_k one from
    random blocks (ggml has no q3_k quantizer here)."""
    rng = np.random.default_rng(seed)
    if ggml_type == GGML_Q4_0:
        raw = quantize_q4_0(rng.standard_normal((n, k)).astype(np.float32) * 0.05)
    else:
        _, block_bytes = BLOCK_INFO[ggml_type]
        nb = n * k // 256
        raw = rng.integers(0, 256, size=(nb, block_bytes), dtype=np.uint8)
        raw[:, 108:110] = (rng.standard_normal(nb) * 0.01).astype(np.float16).view(np.uint8).reshape(nb, 2)
        raw = raw.reshape(-1)
    return extract_blocks(raw, ggml_type, n * k, (n, k))


@pytest.mark.parametrize("ggml_type,group", [(GGML_Q4_0, 32), (GGML_Q3_K, 16)])
@pytest.mark.parametrize("k", [512, 1536])
def test_q4_from_host_quant_keeps_the_checkpoint_group(ggml_type, group, k):
    """A q4_0 GGUF tensor with K >= 512 stages to a group-32 Q4Tensor (q3_k:
    group 16), and linear matches the JAX package's on the same blocks."""
    h = _q4_class_blocks(ggml_type, 40, k, seed=k)
    got = tq.from_host_quant(h, device="cpu")
    want = jq.from_host_quant(h)
    assert isinstance(got, tq.Q4Tensor) and type(want).__name__ == "Q4Tensor"
    assert got.group == want.group == group and got.shape == (40, k)
    assert got.packed.shape == (40, k // 2) and got.scale.shape == (40, k // group)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, k)).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    np.testing.assert_allclose(
        linear(torch.from_numpy(x), got, torch.from_numpy(b)).numpy(),
        np.asarray(jlinear(jnp.asarray(x), want, jnp.asarray(b))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("group", [16, 32])
def test_q4_small_groups_quantize_and_repack_like_jax(group):
    rng = np.random.default_rng(group)
    w = rng.standard_normal((24, 600)).astype(np.float32) * 0.05  # K padded to 640
    qj = jq.quantize_q4(w, group=group)
    want = np.asarray(jq.dequantize_q4(qj, jnp.float32))
    bridged = from_jax_params({"w": qj}, device="cpu")["w"]
    assert bridged.group == group and bridged.packed.shape == (24, 320)
    np.testing.assert_array_equal(tq.dequantize_q4(bridged, torch.float32).numpy(), want)
    ours = tq.quantize_q4(torch.from_numpy(w), group=group)
    np.testing.assert_array_equal(tq.dequantize_q4(ours, torch.float32).numpy(), want)


# (mode, group at K = 4096, group at K = 15360): the 4-bit form at T5's
# group 64 and a q4_0 GGUF's 32, the group-dequant form at q8_0's 32 and
# q6_k's 16, the affine form at q4_1's 32, W8A16's row scale
SPLIT_X_MODES = [("q4", 64, 32), ("gq", 32, 16), ("affine", 32, 32), ("w8a16", None, None)]


@pytest.mark.parametrize("mode,g4096,g15360", SPLIT_X_MODES, ids=[m[0] for m in SPLIT_X_MODES])
@pytest.mark.parametrize("k", [4096, 15360])
def test_split_x_arithmetic_holds_the_float32_limit(mode, g4096, g15360, k):
    """At the T5 width and the DiT's longest K, small M and N: the split-x
    emulation lies within GQ_REL_TOL["f32"] of the largest output of the
    plain version (float32 weights q·s (− z), one float32 matmul), and the
    one-pass TF32 fault (x rounded to tf32) does not."""
    group = g4096 if k == 4096 else g15360
    rng = np.random.default_rng(k + len(mode))
    m, n = 4, 24
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    if mode == "q4":
        q = torch.from_numpy(rng.integers(-8, 8, (n, k)).astype(np.int16))
        scale = torch.from_numpy((rng.random((n, k // group)) * 0.02 + 0.01).astype(np.float32))
        qt = tq.Q4Tensor(packed=tq._pack_nibbles(q), scale=scale, k=k, group=group)
        want, w = tq.q4_matmul(x, qt), tq.dequantize_q4(qt, torch.float32)
        got = chip_smoke.split_x_matmul(x, q.float(), scale, group=group)
    elif mode == "w8a16":
        q = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
        scale = torch.from_numpy((rng.random(n) * 4e-4 + 1e-5).astype(np.float32))
        qt = tq.QuantTensor(q=q, scale=scale)
        want, w = tq.w8a16_matmul(x, qt), tq.dequantize(qt, torch.float32)
        got = chip_smoke.split_x_matmul(x, q.float(), scale)
    else:
        q = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
        scale = torch.from_numpy((rng.random((n, k // group)) * 4e-4 + 1e-5).astype(np.float32))
        zero = (torch.from_numpy((rng.random((n, k // group)) * 1e-2).astype(np.float32))
                if mode == "affine" else None)
        qt = tq.GroupQuantTensor(q=q, scale=scale, zero=zero, k=k, group=group)
        fn = tq.gq_zero_matmul if zero is not None else tq.gq_matmul
        want, w = fn(x, qt), tq.dequantize_group(qt, torch.float32)
        got = chip_smoke.split_x_matmul(x, q.float(), scale, zero, group=group)
    tol = chip_smoke.GQ_REL_TOL["f32"] * want.abs().max().item()
    err = (got - want).abs().max().item()
    fault = chip_smoke._one_pass_tf32_matmul_fault(x, w, want)["one_pass_tf32"]
    assert got.shape == want.shape == (m, n)
    assert err <= tol < fault, (err, tol, fault)
