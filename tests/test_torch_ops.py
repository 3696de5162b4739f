"""The port's ops against ``sdtpu.ops`` on the same numpy-seeded inputs.

On the CPU every wrapper runs its kernel's plain PyTorch version; the JAX
side runs its CPU path, and the flash kernel runs as Pallas in interpret mode
(``SDTPU_INTERPRET_PALLAS``, set by conftest).  Tolerances:
  * float32 elementwise ops and norms: rtol 1e-5 / atol 1e-6 — the same
    float32 formulas, only libm and reduction order differ;
  * float32 matmuls and convolutions: rtol 1e-5 / atol 1e-5 — XLA's
    HIGHEST-precision dot against MKL's float32 sums of up to a few hundred
    terms;
  * flash attention: the shapes and tolerance of ``tests/test_ops.py``'s
    interpret-mode check (rtol 2e-4 / atol 2e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.ops import basic as jb
from sdtpu.ops.attention import attention as jattention
from sdtpu.ops.flash_attention import flash_attention as jflash
from sdtpu.ops.flash_attention import flash_supported as jflash_supported
from sdtpu_torch.ops import basic as tb
from sdtpu_torch.ops.attention import attention as tattention
from sdtpu_torch.ops.flash_attention import flash_attention as tflash
from sdtpu_torch.ops.flash_attention import flash_supported as tflash_supported
from sdtpu_torch.ops.flash_attention import combine_key_splits, key_split_partials, plain_attention


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.mark.parametrize("bias", [False, True])
def test_linear_dense(bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32)
    w = rng.standard_normal((40, 48), dtype=np.float32) * 0.1
    b = rng.standard_normal((40,), dtype=np.float32) if bias else None
    want = jb.linear(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    got = tb.linear(_t(x), _t(w), None if b is None else _t(b))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(),                                   # 3x3, pad 1
    dict(padding=0, k=1),                     # 1x1 projection
    dict(stride=2, padding=((0, 1), (0, 1))),  # CompVis asymmetric downsample
    dict(groups=2),
])
def test_conv2d_nhwc(kw):
    rng = np.random.default_rng(1)
    kw = dict(kw)
    k = kw.pop("k", 3)
    groups = kw.get("groups", 1)
    x = rng.standard_normal((2, 9, 11, 8), dtype=np.float32)
    w = rng.standard_normal((6, 8 // groups, k, k), dtype=np.float32) * 0.2
    b = rng.standard_normal((6,), dtype=np.float32)
    want = jb.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    got = tb.conv2d(_t(x), _t(w), _t(b), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_norms():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 5, 64), dtype=np.float32) * 3 + 1
    w = rng.standard_normal((64,), dtype=np.float32)
    b = rng.standard_normal((64,), dtype=np.float32)
    cases = [
        (jb.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), num_groups=32),
         tb.group_norm(_t(x), _t(w), _t(b), num_groups=32)),
        (jb.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=1e-6),
         tb.layer_norm(_t(x), _t(w), _t(b), eps=1e-6)),
        (jb.layer_norm(jnp.asarray(x)), tb.layer_norm(_t(x))),
        (jb.rms_norm(jnp.asarray(x), jnp.asarray(w)), tb.rms_norm(_t(x), _t(w))),
    ]
    for want, got in cases:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_norms_keep_bf16_inputs_in_bf16():
    x = torch.randn(2, 3, 4, 64, dtype=torch.bfloat16)
    assert tb.group_norm(x, None, None).dtype == torch.bfloat16
    assert tb.layer_norm(x).dtype == torch.bfloat16
    assert tb.rms_norm(x).dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "quick_gelu", "silu"])
def test_activations(name):
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    want = getattr(jb, name)(jnp.asarray(x))
    got = getattr(tb, name)(_t(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dim", [256, 16, 33])
def test_timestep_embedding(dim):
    t = np.asarray([0.0, 1.0, 17.5, 999.0, 1000.0, 3500.0], dtype=np.float32)
    want = jb.timestep_embedding(jnp.asarray(t), dim)
    got = tb.timestep_embedding(_t(t), dim)
    assert got.dtype == torch.float32 and got.shape == (6, dim)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-6)


def _qkv(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, lq, d), dtype=np.float32),
            rng.standard_normal((b, h, lk, d), dtype=np.float32),
            rng.standard_normal((b, h, lk, d), dtype=np.float32))


@pytest.mark.parametrize("lq,lk,d,mask", [
    (77, 77, 64, None), (300, 200, 40, None), (513, 513, 80, None),  # tests/test_ops.py shapes
    (77, 77, 64, "causal"),  # CLIP's causal bias
    (40, 56, 32, "random"),  # a dense additive bias
    (64, 64, 512, None),     # the VAE mid-block head dim
])
def test_plain_flash_matches_pallas_interpret(lq, lk, d, mask):
    q, k, v = _qkv(7, 1, 2, lq, lk, d)
    bias = None
    if mask == "causal":
        bias = np.where(np.tril(np.ones((lq, lk), dtype=bool)), 0.0, -1e30).astype(np.float32)
    elif mask == "random":
        bias = np.random.default_rng(3).standard_normal((lq, lk), dtype=np.float32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  mask=None if bias is None else jnp.asarray(bias))
    got = tflash(_t(q), _t(k), _t(v), mask=None if bias is None else _t(bias))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("lq,lk,d,splits,mask", [
    (24, 77, 40, 1, None),       # one split: the kernel's own online softmax
    (24, 77, 40, 3, "random"),   # 5 tiles in 3 splits: the last one tile, ragged
    (40, 200, 80, 2, None),
    (64, 256, 160, 4, None),     # the UNet's [256, 256] split: four 4-tile splits
    (33, 200, 160, 4, "random"),  # 13 tiles: the last split one ragged tile
    (17, 64, 160, 8, None),      # more splits than tiles: one tile each
    (32, 100, 512, 5, "causal"),
    (16, 130, 512, 8, "random"),
])
def test_key_split_combine_matches_pallas_interpret(lq, lk, d, splits, mask):
    """The float32 kernel's key split (16-key tiles, each split's running
    max, sum and unnormalised output) merged by the combine's 2^(m_s - M)
    rescale, against the reference's flash in interpret mode."""
    q, k, v = _qkv(13 + d, 1, 2, lq, lk, d)
    bias = None
    if mask == "causal":
        bias = np.where(np.tril(np.ones((lq, lk), dtype=bool)), 0.0, -1e30).astype(np.float32)
    elif mask == "random":
        bias = np.random.default_rng(splits).standard_normal((lq, lk), dtype=np.float32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  mask=None if bias is None else jnp.asarray(bias))
    parts = key_split_partials(_t(q), _t(k), _t(v), None if bias is None else _t(bias), splits=splits)
    ntiles = -(-lk // 16)
    per = -(-ntiles // splits)  # whole tiles a split
    assert len(parts) == -(-ntiles // per)
    got = combine_key_splits(parts)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)


def test_flash_unifies_kv_dtype_on_q():
    """f32 q against bf16 k/v: both sides cast k/v to q's dtype first."""
    q, k, v = _qkv(11, 1, 2, 64, 64, 32)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    want = jflash(jnp.asarray(q), kb, vb)
    got = tflash(_t(q), _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("flash", [None, False])
def test_attention_dispatch_matches_xla_attention(flash):
    """On the CPU the dispatch takes the plain math whatever ``flash`` says;
    T5's biased attention ([1, H, L, L] bias) goes through it too."""
    q, k, v = _qkv(5, 2, 3, 24, 24, 16)
    bias = np.random.default_rng(4).standard_normal((1, 3, 24, 24), dtype=np.float32)
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(bias),
                      scale=1.0, flash=False)
    got = tattention(_t(q), _t(k), _t(v), mask=_t(bias), scale=1.0, flash=flash)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_plain_attention_casts_probabilities_to_q_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(6, 1, 2, 16, 16, 8))
    want = jattention(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
                      flash=False)
    got = plain_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


# (q shape, mask shape): no mask, [Lq, Lk], [1, 1, Lq, Lk] (the kernel's),
# then leading dims that are not 1 and a 3-D q (the reference's XLA route)
ROUTES = [((2, 3, 24, 16), None), ((2, 3, 24, 16), (24, 28)), ((2, 3, 24, 16), (1, 1, 24, 28)),
          ((2, 3, 24, 16), (2, 1, 24, 28)), ((2, 3, 24, 16), (2, 3, 24, 28)),
          ((2, 3, 24, 16), (1, 3, 24, 28)), ((6, 24, 16), None), ((6, 24, 16), (24, 28))]


def _route_inputs(q_shape, mask_shape):
    rng = np.random.default_rng(len(q_shape) + (0 if mask_shape is None else sum(mask_shape)))
    kv_shape = (*q_shape[:-2], 28, q_shape[-1])
    q = rng.standard_normal(q_shape, dtype=np.float32)
    k, v = (rng.standard_normal(kv_shape, dtype=np.float32) for _ in range(2))
    mask = None if mask_shape is None else rng.standard_normal(mask_shape, dtype=np.float32)
    return q, k, v, mask


@pytest.mark.parametrize("q_shape,mask_shape", ROUTES)
def test_flash_supported_matches_reference(q_shape, mask_shape):
    q, k, v, mask = _route_inputs(q_shape, mask_shape)
    want = jflash_supported(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            None if mask is None else jnp.asarray(mask))
    got = tflash_supported(_t(q), _t(k), _t(v), None if mask is None else _t(mask))
    assert got is want
    assert got == (len(q_shape) == 4 and (mask_shape is None or all(d == 1 for d in mask_shape[:-2])))


@pytest.mark.parametrize("q_shape,mask_shape", [r for r in ROUTES if len(r[0]) == 4])
def test_attention_route_equals_plain_attention(q_shape, mask_shape):
    """Whatever route a mask takes, ``attention`` computes the plain softmax
    attention (on the card the kernel's shapes go to flash, the rest to the
    plain version, as the reference sends them to XLA); the reference
    agrees."""
    q, k, v, mask = _route_inputs(q_shape, mask_shape)
    tm = None if mask is None else _t(mask)
    got = tattention(_t(q), _t(k), _t(v), mask=tm)
    assert torch.equal(got, plain_attention(_t(q), _t(k), _t(v), mask=tm))
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
