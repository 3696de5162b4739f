"""The int8 split-K forms' plain split-and-sum, and ``quantize_params``,
against ``sdtpu.ops.quant``.

On the card, W8A8, the group-dequant matmul and W8A16 run their calls of 9
to 127 rows (an int8 SDXL UNet's context projections at CFG 1: 77 rows) in
split-K forms: K cut into stages (W8A8: 128 int8 columns; the others: 64),
whole stages a split, each split's partial product summed in split order.
Their plain versions (``split_k_partials`` / ``combine_splits`` /
``split_k_matmul``) are what the card checks hold the kernels to, so they are
held here to the JAX package:

* W8A8: int partials are exact, so the split-and-sum (the int sum · s_x,
  then · s_w) is BIT-EQUAL to ``quant_matmul_w8a8_plain``, to the JAX XLA
  form and to ``_w8a8_matmul_kernel`` run interpreted, at 1 to 4 splits;
* group-dequant (groups 16, 32) and W8A16 (the row scale after the sum):
  within rtol = atol = 1e-5 of the XLA forms and of ``_gq_matmul_kernel`` /
  ``_q_matmul_kernel`` run interpreted (float32 sums in another order, far
  inside it), as the 4-bit split is held in ``tests/test_torch_quant.py``.

``quantize_params`` (the port's copy, which ``--type`` runs) is held
value-equal to the JAX one at bits 8 and 4 on an SDXL-shaped param dict,
K = 320 and 640 among its widths.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sdtpu.ops.attention  # noqa: F401 — registers the module
import sdtpu.ops.quant as jq
from sdtpu_torch.ops import quant as tq
from sdtpu_torch.weights import from_jax_params

att = sys.modules["sdtpu.ops.attention"]
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = [9, 77, 127]  # the split-K forms' first row, SDXL's context, their last
SPLITS = [1, 2, 3, 4]


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


def _x(rng, m, k, dtype):
    """x [m, k] with an all-zero row (s_x = 1), bf16-exact for "bf16"."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[m // 2] = 0.0
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _port_x(x, dtype):
    t = torch.from_numpy(np.array(x))
    return t if dtype == "f32" else t.to(torch.bfloat16)


def _jax_x(x, dtype):
    a = jnp.asarray(x)
    return a if dtype == "f32" else a.astype(jnp.bfloat16)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _w8a8(rng, n, k):
    qj = jq.quantize_per_channel(rng.standard_normal((n, k)).astype(np.float32) * 0.02)
    return qj, from_jax_params({"w": qj}, device="cpu")["w"]


def _jax_group_tensor(rng, n, k, group):
    """A JAX GroupQuantTensor ([Kp, N] layout), random blocks and scales."""
    q = rng.integers(-127, 128, size=(k, n), dtype=np.int8)
    scale = rng.uniform(1e-4, 1e-3, size=(k // group, n)).astype(np.float32)
    return jq.GroupQuantTensor(q=jnp.asarray(q), scale=jnp.asarray(scale), zero=None, k=k,
                               group=group)


# ------------------------------------------------------------------ W8A8

@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("m", ROWS)
def test_w8a8_split_k_bit_equal_to_plain_and_xla_form(m, splits, dtype):
    """K = 640: five 128-column stages, so 2-4 splits leave ragged runs; N
    off the 128-row band."""
    rng = np.random.default_rng(m + splits)
    k, n = 640, 37
    x = _x(rng, m, k, dtype)
    qj, qt = _w8a8(rng, n, k)
    xt = _port_x(x, dtype)
    parts = tq.split_k_partials(xt, qt, splits, w8a8=True)
    stages = -(-k // tq.W8A8_SPLITK_STAGE)
    assert len(parts) == -(-stages // -(-stages // splits))
    assert all(p.dtype == torch.int64 for p in parts)
    got = tq.split_k_matmul(xt, qt, splits, w8a8=True)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(tq.quant_matmul_w8a8_plain(xt, qt)))
    np.testing.assert_array_equal(_np(got), _np(jq.quant_matmul_w8a8(_jax_x(x, dtype), qj)))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m", ROWS)
def test_w8a8_split_k_bit_equal_to_pallas_kernel(tpu_branch_interpret, m, dtype):
    """``_w8a8_matmul_kernel`` interpreted at the split-K form's rows (the
    JAX wrapper sends only M >= 512 there, so its kernel call is made
    directly): K = 1280 spans two of its 1024-wide K steps, and three
    splits of the port's ten stages."""
    rng = np.random.default_rng(3 * m)
    k, n = 1280, 200
    x = _x(rng, m, k, dtype)
    qj, qt = _w8a8(rng, n, k)
    xq, sx = jq.quantize_activations(_jax_x(x, dtype))
    want = jq._w8a8_kernel_call(xq, sx, qj, _jax_x(x, dtype).dtype)[:m, :n]
    got = tq.split_k_matmul(_port_x(x, dtype), qt, 3, w8a8=True)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_w8a8_split_k_without_a_split_differs():
    """The fault the card check reads: the sum without its last split."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_x(rng, 77, 640, "f32"))
    _, qt = _w8a8(rng, 64, 640)
    want = tq.quant_matmul_w8a8_plain(x, qt)
    dropped = tq.split_k_matmul(x, qt, 3, w8a8=True, keep=2)
    assert (dropped - want).abs().max() > 0.05 * want.abs().max()


# ------------------------------------------------------ group-dequant, W8A16

@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m", ROWS)
def test_gq_split_k_matches_xla_form(m, group, splits):
    """K = 608: nine 64-column stages and a ragged tenth (Kp = 608 is off
    the stage's scale groups at both groups); N off the 128-row band."""
    rng = np.random.default_rng(m + group + splits)
    k, n = 608, 37
    qj = _jax_group_tensor(rng, n, k, group)
    qt = from_jax_params({"w": qj}, device="cpu")["w"]
    x = rng.standard_normal((m, k)).astype(np.float32)
    parts = tq.split_k_partials(torch.from_numpy(x), qt, splits)
    stages = -(-k // tq.SPLITK_STAGE)
    assert len(parts) == -(-stages // -(-stages // splits))
    got = tq.split_k_matmul(torch.from_numpy(x), qt, splits)
    want = np.asarray(jq.group_quant_matmul(jnp.asarray(x), qj))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m", ROWS)
def test_gq_split_k_matches_pallas_kernel(tpu_branch_interpret, m, group):
    """``_gq_matmul_kernel`` interpreted (one M tile of 128 rows, two 512-wide
    K steps) against three splits."""
    rng = np.random.default_rng(m * group)
    k, n = 1024, 136
    qj = _jax_group_tensor(rng, n, k, group)
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jq.group_quant_matmul(jnp.asarray(x), qj, block_m=128))
    got = tq.split_k_matmul(torch.from_numpy(x), from_jax_params({"w": qj}, device="cpu")["w"], 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("m", ROWS)
def test_w8a16_split_k_matches_xla_form(monkeypatch, m, splits):
    """The row scale multiplies the summed splits, as the kernel's epilogue."""
    monkeypatch.setenv("SDTPU_QUANT_MODE", "w8a16")
    rng = np.random.default_rng(7 * m + splits)
    k, n = 640, 37
    x = rng.standard_normal((m, k)).astype(np.float32)
    qj, qt = _w8a8(rng, n, k)
    got = tq.split_k_matmul(torch.from_numpy(x), qt, splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(jq.quant_matmul(jnp.asarray(x), qj)), **TOL)
    np.testing.assert_allclose(got.numpy(), tq.w8a16_matmul_plain(torch.from_numpy(x), qt).numpy(),
                               **TOL)


@pytest.mark.parametrize("m", ROWS)
def test_w8a16_split_k_matches_pallas_kernel(tpu_branch_interpret, monkeypatch, m):
    """``_q_matmul_kernel`` interpreted (two 512-wide K steps, two N tiles)
    against three splits."""
    monkeypatch.setenv("SDTPU_QUANT_MODE", "w8a16")
    rng = np.random.default_rng(11 * m)
    k, n = 1024, 640
    x = rng.standard_normal((m, k)).astype(np.float32)
    qj, qt = _w8a8(rng, n, k)
    want = np.asarray(jq.quant_matmul(jnp.asarray(x), qj))
    got = tq.split_k_matmul(torch.from_numpy(x), qt, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kind", ["gq", "w8a16"])
def test_split_k_without_a_split_differs(kind):
    """The fault the card check reads (``drop_k_split``) lies far beyond the
    bf16 limit: the sum without its last split."""
    rng = np.random.default_rng(13)
    k, n = 640, 64
    x = torch.from_numpy(rng.standard_normal((77, k)).astype(np.float32)).to(torch.bfloat16)
    if kind == "gq":
        qt = from_jax_params({"w": _jax_group_tensor(rng, n, k, 32)}, device="cpu")["w"]
        want = tq.group_quant_matmul_plain(x, qt)
    else:
        qt = _w8a8(rng, n, k)[1]
        want = tq.w8a16_matmul_plain(x, qt)
    dropped = tq.split_k_matmul(x, qt, 3, keep=2)
    assert (dropped.float() - want.float()).abs().max() > 2 ** -6 * want.float().abs().max()


# --------------------------------------------------------- quantize_params

def _sdxl_shaped_params(rng):
    """A small param dict with SDXL's linear widths (K = 320 and 640 among
    them), convolutions, norms, a small weight and an embedding."""
    shapes = {
        "time_embed.0.weight": (1280, 320),
        "input_blocks.4.1.transformer_blocks.0.attn2.to_k.weight": (640, 2048),
        "input_blocks.4.1.transformer_blocks.0.ff.net.2.weight": (640, 2560),
        "input_blocks.4.1.proj_in.weight": (640, 640),
        "input_blocks.1.0.emb_layers.1.weight": (320, 1280),
        "input_blocks.1.0.in_layers.2.weight": (320, 320, 3, 3),
        "input_blocks.1.0.in_layers.0.weight": (320,),
        "input_blocks.1.0.in_layers.0.bias": (320,),
        "out.2.weight": (4, 320),
        "label_emb.0.0.weight": (1280, 2816),
    }
    return {k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in shapes.items()}


def test_quantize_params_bits8_matches_jax():
    rng = np.random.default_rng(17)
    params = _sdxl_shaped_params(rng)
    want = jq.quantize_params(params, bits=8)
    got = tq.quantize_params({k: torch.from_numpy(v) for k, v in params.items()}, bits=8)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert isinstance(g, tq.QuantTensor) == isinstance(w, jq.QuantTensor), name
        if isinstance(g, tq.QuantTensor):
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sum(isinstance(v, tq.QuantTensor) for v in got.values()) == 6


def test_quantize_params_bits4_matches_jax():
    """Group 64, the JAX nibbles and scales: equal by bytes and scales to the
    JAX tensors as ``from_jax_params`` repacks them (K padded to the port's
    64-wide tile, not the JAX 512-wide one: K = 320 and 640 need none), and
    dequantized equal to the JAX values."""
    rng = np.random.default_rng(19)
    params = _sdxl_shaped_params(rng)
    want = jq.quantize_params(params, bits=4)
    got = tq.quantize_params({k: torch.from_numpy(v) for k, v in params.items()}, bits=4)
    bridged = from_jax_params(want, device="cpu")
    n4 = 0
    for name, w in want.items():
        g = got[name]
        assert isinstance(g, tq.Q4Tensor) == isinstance(w, jq.Q4Tensor), name
        if isinstance(g, tq.Q4Tensor):
            b = bridged[name]
            assert (g.k, g.group) == (b.k, b.group) == (w.k, 64)
            assert torch.equal(g.packed, b.packed) and torch.equal(g.scale, b.scale)
            np.testing.assert_array_equal(tq.dequantize_q4(g, torch.float32).numpy(),
                                          np.asarray(jq.dequantize_q4(w, jnp.float32)))
            n4 += 1
    assert n4 == 6
    assert got["time_embed.0.weight"].packed.shape == (1280, 160)  # K = 320
    assert got["input_blocks.4.1.proj_in.weight"].packed.shape == (640, 320)  # K = 640


def test_quantize_params_rule(monkeypatch):
    """2-D ``.weight`` of at least ``QUANTIZE_MIN_SIZE`` elements, whatever
    its name (no skip: not ``weights.synthesize``'s rule); everything else
    comes back as the same object."""
    monkeypatch.setattr(tq, "QUANTIZE_MIN_SIZE", 64 * 64)
    w = torch.randn(64, 64)
    params = {"a.weight": w, "a.bias": torch.randn(64 * 64), "emb.weight": w,
              "b.weight": torch.randn(8, 8)}
    got = tq.quantize_params(params)
    assert isinstance(got["a.weight"], tq.QuantTensor)
    assert isinstance(got["emb.weight"], tq.QuantTensor)
    assert all(got[k] is params[k] for k in ("a.bias", "b.weight"))
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_params(params, bits=2)
