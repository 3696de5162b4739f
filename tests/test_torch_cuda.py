"""The port's hand-written CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a); elsewhere they skip.
Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
``chip_smoke.py`` covers the full-size shapes; these cover ragged edges and
the wrappers' refusals.  Tolerances are those stated in ``chip_smoke.py``.

The CPU-only tests at the end hold the dispatch rule: a CPU tensor runs the
plain version and never counts a launch or builds the library.
"""
import pytest
import torch

import chip_smoke
from sdtpu_torch.ops import _build
from sdtpu_torch.ops import flash_attention as fa
from sdtpu_torch.ops import quant
from sdtpu_torch.ops.attention import attention


# flash float32: its limit, a share of the largest |output|
FLASH_F32_TOL = chip_smoke.FLASH_TOL["f32"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _gemv_counts(fn):
    return [fn.launches, fn.launches_gemv, fn.launches_splitk]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (3, 48, 130), (9, 48, 130), (9, 3072, 18432),
                                   (129, 272, 257), (300, 1040, 64)])
def test_w8a8_kernel_bit_equal(cuda, m, k, n):
    """Each form, bf16 and float32 x: the GEMV (M <= 8), split-K (M = 9,
    its first row) and wgmma; the wrapper counts the form the library ran."""
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = quant.quantize_per_channel(torch.randn((n, k), generator=g, device=cuda) * 0.02)
    form = _build.query("sdtpu_w8a8_form", m, k)
    for xd in (x, x.float()):
        before = _gemv_counts(quant.quant_matmul_w8a8)
        got = quant.quant_matmul_w8a8(xd, qt)
        assert _gemv_counts(quant.quant_matmul_w8a8) == [before[0] + 1, before[1] + (form == 0),
                                                         before[2] + (form == 1)]
        assert torch.equal(got, quant.quant_matmul_w8a8_plain(xd, qt))


def _w8a8_gemv_inputs(g, m, k, dtype, device):
    """x [m, k] for the W8A8 GEMV: all random; then with an all-zero row
    (amax 0, so s_x = 1 and every q is 0) and a row of amax exactly 127 (s_x
    = 1) whose other values lie at j + 0.5, so x / s_x rounds half to even
    both ways (exact in bf16).  At M = 1 each special row is a call of its own."""
    def ties():
        row = torch.randint(-127, 127, (k,), generator=g, device=device).to(dtype) + 0.5
        row[0] = 127.0
        return row

    x = torch.randn((m, k), generator=g, device=device, dtype=dtype)
    if m == 1:
        return [x, torch.zeros_like(x), ties()[None]]
    special = torch.randn((m, k), generator=g, device=device, dtype=dtype)
    special[0] = 0
    special[-1] = ties()
    return [x, special]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 5, 8])
@pytest.mark.parametrize("k", [16, 272, 1040, 3072])
@pytest.mark.parametrize("n", [2, 77, 130, 18432])
def test_w8a8_gemv_kernel_bit_equal(cuda, dtype, m, k, n):
    """M <= 8 runs the weight-streaming GEMV, which quantizes x itself:
    bit-equal to the plain version.  K = 16 is a quarter segment, 272 and
    1040 end in a partial 64-byte segment; N off the 16-row block (2, 77,
    130) and the DiT's widest modulation (18432)."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    qt = quant.QuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
        scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
    for x in _w8a8_gemv_inputs(g, m, k, dtype, cuda):
        before = _gemv_counts(quant.quant_matmul_w8a8)
        got = quant.quant_matmul_w8a8(x, qt)
        assert _gemv_counts(quant.quant_matmul_w8a8) == [before[0] + 1, before[1] + 1, before[2]]
        assert got.dtype == dtype and got.shape == (m, n)
        assert torch.equal(got, quant.quant_matmul_w8a8_plain(x, qt))


@pytest.mark.cuda
def test_w8a8_gemv_is_one_kernel(cuda):
    """The GEMV quantizes x in its own launch: a torch.profiler trace of one
    M = 1 call holds one device kernel, no row quantize in front."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1, 3072), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = quant.quantize_per_channel(torch.randn((3072, 3072), generator=g, device=cuda) * 0.02)
    quant.quant_matmul_w8a8(x, qt)  # builds the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        quant.quant_matmul_w8a8(x, qt)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "w8a8_gemv_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_w8a8_form_by_shape(cuda):
    """The library picks the W8A8 form by M and K alone (0 the GEMV, 1
    split-K, 2 wgmma): the GEMV up to W8A8_GEMV_MAX_M rows and
    W8A8_GEMV_MAX_K columns, where its x rows still fit shared memory."""
    edges = (1, quant.W8A8_GEMV_MAX_M, quant.W8A8_GEMV_MAX_M + 1, quant.W8A8_WGMMA_MIN_M - 1,
             quant.W8A8_WGMMA_MIN_M)
    assert [_build.query("sdtpu_w8a8_form", m, 3072) for m in edges] == [0, 0, 1, 1, 2]
    kmax = quant.W8A8_GEMV_MAX_K
    assert [_build.query("sdtpu_w8a8_form", 8, k) for k in (kmax, kmax + 16)] == [0, 1]
    g = torch.Generator(device=cuda).manual_seed(0)
    for m, k in [(1, 256), (8, 256), (9, 256), (127, 256), (128, 256), (8, kmax), (8, kmax + 16)]:
        x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
        qt = quant.quantize_per_channel(torch.randn((32, k), generator=g, device=cuda) * 0.02)
        form = _build.query("sdtpu_w8a8_form", m, k)
        before = _gemv_counts(quant.quant_matmul_w8a8)
        got = quant.quant_matmul_w8a8(x, qt)
        assert _gemv_counts(quant.quant_matmul_w8a8) == [before[0] + 1, before[1] + (form == 0),
                                                         before[2] + (form == 1)]
        assert torch.equal(got, quant.quant_matmul_w8a8_plain(x, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, FLASH_F32_TOL)])
@pytest.mark.parametrize("lq,lk,d,bias", [(1, 1, 64, False), (65, 63, 64, True),
                                          (130, 257, 128, False), (70, 33, 512, True)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, lq, lk, d, bias):
    g = torch.Generator(device=cuda).manual_seed(lq)
    q = torch.randn((2, 3, lq, d), generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn((2, 3, lk, d), generator=g, device=cuda, dtype=dtype) for _ in range(2))
    mask = torch.randn((lq, lk), generator=g, device=cuda) if bias else None
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mask=mask)
    assert fa.flash_attention.launches == before + 1
    want = fa.plain_attention(q, k, v, mask=mask)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


# (dtype, tol, d, (B, H), Lq, Lk, bias, key splits on 132 SMs or None).
# Every UNet head dim in both dtypes at ragged shapes; then float32 D 160
# split 1, 2, 3, 4, 5, 8 and 16 ways, and the bf16 D 40 kernel's edges:
# one key tile, Lk off the 128-key tile, one and several tiles, Lq under
# one warpgroup's 64 rows and between 128 and 192, and grids large enough
# for its three-warpgroup form (a ragged last Q tile among them).
UNET_FLASH_TESTS = [
    (dtype, tol, d, bh, lq, lk, bias, None)
    for dtype, tol in [(torch.bfloat16, 2e-2), (torch.float32, FLASH_F32_TOL)]
    for d in (40, 80, 160)
    for bh, lq, lk, bias in [((2, 8), 1000, 77, False), ((1, 3), 257, 300, True), ((2, 8), 64, 64, False),
                             ((3, 2), 130, 1, True), ((1, 2), 1, 129, False), ((1, 8), 513, 1030, True)]
] + [
    (torch.float32, FLASH_F32_TOL, 160, bh, lq, lk, bias, splits)
    for bh, lq, lk, bias, splits in [
        ((2, 8), 256, 16, False, 1), ((2, 8), 256, 1, True, 1), ((1, 2), 64, 32, True, 2),
        ((2, 8), 256, 77, True, 3), ((2, 8), 256, 256, False, 4), ((2, 8), 64, 64, False, 4),
        ((2, 8), 256, 200, True, 4), ((2, 8), 64, 77, False, 5), ((1, 8), 64, 120, False, 8),
        ((1, 1), 256, 256, False, 16)]
] + [
    (torch.bfloat16, 2e-2, 40, bh, lq, lk, bias, None)
    for bh, lq, lk, bias in [
        ((1, 2), 100, 128, False), ((1, 2), 10, 50, True), ((1, 1), 1, 1, False),
        ((1, 2), 64, 129, False), ((2, 3), 150, 300, False), ((1, 4), 190, 256, True),
        ((2, 2), 300, 640, True), ((1, 2), 1024, 1024, False),
        # grids of 192-row Q tiles that fill 132 SMs: three consumer warpgroups
        ((2, 8), 2000, 300, False), ((2, 8), 4096, 77, False)]
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,d,bh,lq,lk,bias,splits", UNET_FLASH_TESTS)
def test_flash_unet_head_dims_match_plain(cuda, dtype, tol, d, bh, lq, lk, bias, splits):
    """The SD1.5 UNet's head dims, both dtypes: bf16 D 80 / 160 pad D to
    whole 64-column blocks in shared memory only (TMA's zero fill), bf16 D
    40 runs its own kernel, float32 contracts D 40 over 48 columns and
    splits D 160's keys where the grid is small; ragged Lq and Lk (a
    cross-attention's 77 keys, one key, one query), with and without the
    dense bias.  Each call counts one launch in ``launches`` and in its head
    dim's counter; a float32 D 160 case runs the key splits it names."""
    if splits is not None and torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert _build.query("sdtpu_flash_splits", 1, bh[0] * bh[1], lq, lk, d) == splits
    g = torch.Generator(device=cuda).manual_seed(lq * d + lk)
    q = torch.randn((*bh, lq, d), generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn((*bh, lk, d), generator=g, device=cuda, dtype=dtype) for _ in range(2))
    mask = torch.randn((lq, lk), generator=g, device=cuda) if bias else None
    counter = f"launches_d{d}"
    before = (fa.flash_attention.launches, getattr(fa.flash_attention, counter))
    got = fa.flash_attention(q, k, v, mask=mask)
    assert (fa.flash_attention.launches, getattr(fa.flash_attention, counter)) == (
        before[0] + 1, before[1] + 1)
    want = fa.plain_attention(q, k, v, mask=mask)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, FLASH_F32_TOL)])
@pytest.mark.parametrize("b,h,lq,lk,d,bias", chip_smoke.SDXL_FLASH_SHAPES
                         + chip_smoke.SD3_FLASH_SHAPES + chip_smoke.SD2_FLASH_SHAPES)
def test_flash_sdxl_shapes_match_plain(cuda, dtype, tol, b, h, lq, lk, d, bias):
    """The D 64 calls at 1024² under CFG of the SDXL UNet (10 heads over
    4096 tokens, 20 over 1024, their 77-key cross-attention), CLIP-G's causal
    call, SD3.5-Medium (the joint attention over 154 + 4096 tokens,
    ragged on every 128-row and 128-key tile, its scores drawn negative by
    ``chip_smoke.flash_inputs``; MMDiT-X's second self-attention over 4096)
    and SD2.1-768-v at 768² (5 heads over 9216 tokens, q around +1 and k
    around -1, with its cross-attention over 77; 10 over 2304, 20 over 576;
    OpenCLIP-H's causal call), both dtypes, at the limits of ``chip_smoke.py``; a bf16 call counts in
    ``launches_d64``, a float32 one in ``launches_f32``.  The bf16 faults
    (the last 128-key tile dropped; unmasked pad keys, where Lk is off the
    tile) exceed the limit."""
    g = torch.Generator(device=cuda).manual_seed(lq + lk + h)
    q, k, v, mask = chip_smoke.flash_inputs(g, b, h, lq, lk, d, dtype, bias)
    counter = "launches_d64" if dtype == torch.bfloat16 else "launches_f32"
    before = (fa.flash_attention.launches, getattr(fa.flash_attention, counter))
    got = fa.flash_attention(q, k, v, mask=mask)
    assert (fa.flash_attention.launches, getattr(fa.flash_attention, counter)) == (
        before[0] + 1, before[1] + 1)
    want = fa.plain_attention(q, k, v, mask=mask)
    limit = tol * want.float().abs().max().item()
    assert torch.isfinite(got).all() and (got.float() - want.float()).abs().max().item() <= limit
    if dtype == torch.bfloat16:
        faults = chip_smoke._d64_faults(q, k, v, mask, want)
        assert ("unmasked_pad_keys" in faults) is (lk % 128 != 0)
        assert faults and all(f > limit for f in faults.values()), faults


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,bias", chip_smoke.WAN_FLASH_SHAPES)
def test_flash_wan_shapes_match_plain(cuda, b, h, lq, lk, d, bias):
    """Wan2.1-1.3B's D 128 calls at 832x480 over 9 latent frames under CFG:
    the self-attention over 14040 tokens (the last 128-row Q tile and the
    last 128-key tile ragged) and the cross-attention over UMT5's 512, bf16,
    q drawn around +1 and k around -1 (``chip_smoke.flash_inputs``), at
    ``chip_smoke.py``'s limit: one launch in ``launches`` and none in the
    D 64, D 512 or float32 counts; the zero keys past Lk left unmasked
    (``unmasked_pad_keys``, where Lk is off the 128-key tile) exceed the
    limit."""
    g = torch.Generator(device=cuda).manual_seed(lq + lk)
    q, k, v, mask = chip_smoke.flash_inputs(g, b, h, lq, lk, d, torch.bfloat16, bias)
    counters = ("launches", "launches_d64", "launches_d512", "launches_f32")
    before = [getattr(fa.flash_attention, c) for c in counters]
    got = fa.flash_attention(q, k, v, mask=mask)
    assert [getattr(fa.flash_attention, c) for c in counters] == [before[0] + 1] + before[1:]
    want = fa.plain_attention(q, k, v, mask=mask)
    limit = chip_smoke.FLASH_TOL["bf16"] * want.float().abs().max().item()
    assert torch.isfinite(got).all() and (got.float() - want.float()).abs().max().item() <= limit
    faults = chip_smoke._ragged_faults(q, k, v, mask, want)
    assert ("unmasked_pad_keys" in faults) is (lk % 128 != 0)
    assert all(f > limit for f in faults.values()), faults


@pytest.mark.cuda
def test_flash_d512_at_sd3_decode_matches_plain(cuda):
    """The SD3 VAE's mid-block attention over the untiled 1024² decode's
    16384 tokens, bf16 D 512 (``chip_smoke.SD3_VAE_FLASH_SHAPE``): one launch
    in ``launches_d512``, within ``chip_smoke.py``'s limit of the plain
    version, and the faults of the key split the launcher picks (the last
    32-key tile of a split dropped; split partials merged without their
    rescale) exceed the limit."""
    b, h, lq, lk, d = chip_smoke.SD3_VAE_FLASH_SHAPE
    g = torch.Generator(device=cuda).manual_seed(lq)
    q, k, v, mask = chip_smoke.flash_inputs(g, b, h, lq, lk, d, torch.bfloat16, None)
    before = (fa.flash_attention.launches, fa.flash_attention.launches_d512)
    got = fa.flash_attention(q, k, v, mask=mask)
    assert (fa.flash_attention.launches, fa.flash_attention.launches_d512) == (
        before[0] + 1, before[1] + 1)
    want = fa.plain_attention(q, k, v, mask=mask)
    limit = chip_smoke.FLASH_TOL["bf16"] * want.float().abs().max().item()
    assert torch.isfinite(got).all() and (got.float() - want.float()).abs().max().item() <= limit
    faults = chip_smoke._d512_faults(q, k, v, mask, want)
    assert faults.pop("splits") == _build.query("sdtpu_flash_splits", 0, b * h, lq, lk, d)
    assert faults and all(f > limit for f in faults.values()), faults


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_d512_at_sd2_decode_matches_plain(cuda, dtype):
    """The SD VAE's mid-block attention over the untiled 768² decode's 9216
    tokens (``chip_smoke.SD2_VAE_FLASH_SHAPE``), q around +1 and k around
    -1: the launcher splits the keys; one launch in ``launches_d512`` (bf16)
    or ``launches_f32``, within ``chip_smoke.py``'s limit of the plain
    version, and the faults of that split (bf16: the last 32-key tile of a
    split dropped, split partials merged without their rescale; float32:
    the same merge, and one TF32 pass) exceed the limit."""
    b, h, lq, lk, d = chip_smoke.SD2_VAE_FLASH_SHAPE
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    g = torch.Generator(device=cuda).manual_seed(lq)
    q, k, v, mask = chip_smoke.flash_inputs(g, b, h, lq, lk, d, dtype, "neg_scores")
    counter = "launches_d512" if dt == "bf16" else "launches_f32"
    before = (fa.flash_attention.launches, getattr(fa.flash_attention, counter))
    got = fa.flash_attention(q, k, v, mask=mask)
    assert (fa.flash_attention.launches, getattr(fa.flash_attention, counter)) == (
        before[0] + 1, before[1] + 1)
    want = fa.plain_attention(q, k, v, mask=mask)
    limit = chip_smoke.FLASH_TOL[dt] * want.float().abs().max().item()
    assert torch.isfinite(got).all() and (got.float() - want.float()).abs().max().item() <= limit
    splits = _build.query("sdtpu_flash_splits", _build.DTYPE_CODES[dtype], b * h, lq, lk, d)
    assert splits > 1
    if dt == "bf16":
        faults = chip_smoke._d512_faults(q, k, v, mask, want)
        assert faults.pop("splits") == splits
    else:
        faults = {**chip_smoke._one_pass_tf32_fault(q, k, v, mask, want),
                  **chip_smoke._split_fault(q, k, v, mask, want, splits)}
    assert len(faults) == 2 and all(f > limit for f in faults.values()), faults


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("m,k,n", chip_smoke.Q4_SD3_T5_SHAPES)
def test_q4_at_sd3_t5_rows_matches_plain(cuda, dtype, group, m, k, n):
    """T5-XXL's linears over SD3's 77 tokens: the bf16 split-K form
    (counted in ``launches_splitk``) and the float32 form, each within its
    limit of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n + group)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=dtype)
    qt = _q4_weight(g, n, k, group, cuda)
    counter = "launches_splitk" if dtype == torch.bfloat16 else "launches_f32"
    before = (quant.q4_matmul.launches, getattr(quant.q4_matmul, counter))
    got = quant.q4_matmul(x, qt)
    assert (quant.q4_matmul.launches, getattr(quant.q4_matmul, counter)) == (
        before[0] + 1, before[1] + 1)
    want = quant.q4_matmul_plain(x, qt)
    tol = chip_smoke.Q4_REL_TOL if dtype == torch.bfloat16 else chip_smoke.GQ_REL_TOL["f32"]
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol * want.float().abs().max().item()


@pytest.mark.cuda
def test_flash_split_workspace_allocated_by_wrapper(cuda):
    """A float32 D 160 call that splits its keys: the library asks for f32
    scratch (each split's [B·H, Lq, D] output, max and sum), the wrapper
    allocates it beside the output, and the call (the kernel and its
    combine) counts one launch in ``launches``, ``launches_f32`` and
    ``launches_d160``."""
    b, h, lq, lk, d = 2, 8, 256, 256, 160
    splits = _build.query("sdtpu_flash_splits", 1, b * h, lq, lk, d)
    ws = _build.query("sdtpu_flash_workspace_bytes", 1, b * h, lq, lk, d)
    assert splits > 1 and ws == splits * b * h * lq * (d + 2) * 4
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, h, l, d), generator=g, device=cuda) for l in (lq, lk, lk))
    counters = ("launches", "launches_f32", "launches_d160")
    before = [getattr(fa.flash_attention, c) for c in counters]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base >= ws + got.numel() * 4
    assert [getattr(fa.flash_attention, c) for c in counters] == [n + 1 for n in before]
    want = fa.plain_attention(q, k, v)
    assert (got - want).abs().max().item() <= FLASH_F32_TOL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(128, 256, 256), (129, 272, 257), (4352, 3072, 384),
                                   (4352, 64, 3072), (256, 64, 1040)])
def test_w8a8_wgmma_kernel_bit_equal(cuda, m, k, n):
    """M >= 128 takes the TMA + wgmma kernel: edge tiles in M, N and K come
    from TMA's zero fill, K = 64 is half a 128-byte stage."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    x[0] = 0  # the amax = 0 row
    qt = quant.QuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
        scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
    before = quant.quant_matmul_w8a8.launches
    got = quant.quant_matmul_w8a8(x, qt)
    assert quant.quant_matmul_w8a8.launches == before + 1
    assert torch.equal(got, quant.quant_matmul_w8a8_plain(x, qt))
    x32 = x.float()
    assert torch.equal(quant.quant_matmul_w8a8(x32, qt), quant.quant_matmul_w8a8_plain(x32, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk,d,bias", [
    ((1, 24), 200, 300, 128, False), ((2, 3), 129, 127, 128, True), ((1, 24), 1280, 1000, 128, False),
    ((2, 12), 77, 77, 64, True), ((1, 4), 150, 129, 64, False), ((3, 2), 257, 385, 64, True),
    # D 512: the VAE tile (keys split in two, then combined); Lk under one
    # 32-key tile; one Q tile with four one-tile splits, the last of 4 keys
    ((1, 1), 4096, 4096, 512, False), ((1, 1), 130, 20, 512, False), ((1, 1), 64, 100, 512, True),
    ((1, 2), 300, 200, 512, True), ((3, 2), 257, 1000, 512, True), ((2, 3), 1030, 77, 512, False),
    # D 320 (SDXS-0.9's wide head): the self-attention (two key splits), the
    # cross-attention over 77 keys at B 2, ragged and biased
    ((1, 1), 4096, 4096, 320, False), ((2, 1), 4096, 77, 320, False), ((1, 1), 130, 20, 320, False),
    ((1, 2), 300, 200, 320, True), ((3, 2), 257, 1000, 320, True)])
def test_flash_wgmma_kernel_ragged_edges(cuda, bh, lq, lk, d, bias):
    """bf16 takes the TMA + wgmma kernels: Lq and Lk off the tiles (TMA's
    zero fill, the last key tile masked), with and without the dense bias;
    at D 512 the keys split across blocks where the grid is small and the
    combine kernel merges them.  One wrapper call counts one launch."""
    g = torch.Generator(device=cuda).manual_seed(lq + lk)
    q = torch.randn((*bh, lq, d), generator=g, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn((*bh, lk, d), generator=g, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    mask = torch.randn((lq, lk), generator=g, device=cuda) if bias else None
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mask=mask)
    assert fa.flash_attention.launches == before + 1
    want = fa.plain_attention(q, k, v, mask=mask)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 64, 2), (5, 200, 77), (65, 1024, 129)])
def test_q4_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = quant.quantize_q4(torch.randn((n, k), generator=g, device=cuda) * 0.02)
    got = quant.q4_matmul(x, qt)
    want = quant.q4_matmul_plain(x, qt)
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("m,k,n", [(1, 64, 2), (5, 200, 77), (65, 1024, 129)])
def test_q4_kernel_groups_match_plain(cuda, group, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(n + group)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = quant.quantize_q4(torch.randn((n, k), generator=g, device=cuda) * 0.02, group=group)
    before = quant.q4_matmul.launches
    got = quant.q4_matmul(x, qt)
    assert quant.q4_matmul.launches == before + 1
    want = quant.q4_matmul_plain(x, qt)
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6 * want.float().abs().max().item()


# M >= 128 takes the TMA + wgmma 4-bit kernel: M at the threshold and one
# past it, T5's 256 tokens, FLUX's 4352; N off the 128-row weight tile; K off
# the 64-wide K tile (Kp > K, the padded nibbles random) and K = 64 (one
# stage); between them the launcher picks each x-row tile (64, 128, 256)
Q4_WGMMA_SHAPES = [(128, 256, 200), (129, 272, 257), (128, 3072, 12288), (256, 4096, 4096),
                   (256, 1040, 10240), (4352, 3072, 384), (4352, 64, 3072), (4352, 1040, 130)]


def _q4_weight(g, n, k, group, device):
    """Random packed bytes (padding included) with random scales: every
    nibble and group differs."""
    kp = -(-k // quant.Q4_K_MULTIPLE) * quant.Q4_K_MULTIPLE
    return quant.Q4Tensor(
        packed=torch.randint(0, 256, (n, kp // 2), generator=g, device=device, dtype=torch.uint8),
        scale=torch.rand((n, kp // group), generator=g, device=device) * 4e-3 + 1e-3, k=k,
        group=group)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("m,k,n", Q4_WGMMA_SHAPES)
def test_q4_wgmma_kernel_matches_plain(cuda, group, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + group)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = _q4_weight(g, n, k, group, cuda)
    before = (quant.q4_matmul.launches, quant.q4_matmul.launches_wgmma)
    got = quant.q4_matmul(x, qt)
    assert (quant.q4_matmul.launches, quant.q4_matmul.launches_wgmma) == (before[0] + 1, before[1] + 1)
    want = quant.q4_matmul_plain(x, qt)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6 * want.float().abs().max().item()


# 8 < M < 128 takes the split-K kernel: M at each x tile's edges (9 and 16
# in the 32-row tile, 33 and 64 in the 64-row, 77 in the 80-row, 100 and 127
# in the 128-row); N off the 128-row band (200, 1001: 1001 also off the
# four-wide store); K = 64 (one stage, one split) and K off the 64-wide
# stage (1040, the padded nibbles random); T5-XXL's three widths
Q4_SPLITK_ROWS = [9, 16, 33, 64, 77, 100, 127]
Q4_SPLITK_SHAPES = [(64, 200), (64, 1001), (1040, 200), (1040, 1001), (4096, 4096), (4096, 10240),
                    (10240, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("m", Q4_SPLITK_ROWS)
@pytest.mark.parametrize("k,n", Q4_SPLITK_SHAPES)
def test_q4_splitk_kernel_matches_plain(cuda, group, m, k, n):
    """One counted launch of the split-K form within ``Q4_REL_TOL`` of the
    plain version; its K splits (1 to 8, at most one a 64-k stage) as the
    library reports them; a second call bit-identical (the reduction sums
    the splits in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n + group)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = _q4_weight(g, n, k, group, cuda)
    counts = ("launches", "launches_splitk", "launches_wgmma", "launches_gemv")
    before = [getattr(quant.q4_matmul, c) for c in counts]
    got = quant.q4_matmul(x, qt)
    assert [getattr(quant.q4_matmul, c) for c in counts] == [before[0] + 1, before[1] + 1, *before[2:]]
    splits = _build.query("sdtpu_q4_splits", m, n, k)
    assert 1 <= splits <= min(8, -(-k // quant.Q4_K_MULTIPLE))
    want = quant.q4_matmul_plain(x, qt)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    limit = chip_smoke.Q4_REL_TOL * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= limit
    assert torch.equal(quant.q4_matmul(x, qt), got)


# The int8 split-K forms (8 < M < 128; W8A8 also at M <= 8 past
# W8A8_GEMV_MAX_K): every x tile (32, 64, 80, 128 rows), N off the 128-row
# band and the four-wide store (200, 1001), K of one stage and K off the
# stage (W8A8's 128 columns: 48, 1040; the group form's 64: 272, whose Kp =
# 288 at group 32 is off the stage's scale groups), SDXL's context
# projections (2048 -> 640, 1280) and a DiT-wide linear
INT8_SPLITK_ROWS = [9, 16, 33, 64, 77, 100, 127]
W8A8_SPLITK_SHAPES = [(48, 200), (1040, 1001), (2048, 640), (2048, 1280), (3072, 12288)]
GQ_SPLITK_SHAPES = [(64, 200), (272, 1001), (2048, 640), (2048, 1280), (3072, 12288)]


def _int8_splitk_counts(fn):
    return [fn.launches, fn.launches_splitk, fn.launches_gemv, fn.launches_wgmma]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", INT8_SPLITK_ROWS)
@pytest.mark.parametrize("k,n", W8A8_SPLITK_SHAPES)
def test_w8a8_splitk_kernel_bit_equal(cuda, dtype, m, k, n):
    """One counted launch of the W8A8 split-K form, bit-equal to the plain
    version and to the plain split-and-sum at the splits the library reports
    (int32 partials: exact in any order), with an all-zero x row; a second
    call bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=dtype)
    x[m // 2] = 0
    qt = quant.QuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
        scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
    before = _int8_splitk_counts(quant.quant_matmul_w8a8)
    got = quant.quant_matmul_w8a8(x, qt)
    assert _int8_splitk_counts(quant.quant_matmul_w8a8) == [before[0] + 1, before[1] + 1, *before[2:]]
    splits = _build.query("sdtpu_w8a8_splits", m, n, k)
    assert 1 <= splits <= min(8, -(-k // quant.W8A8_SPLITK_STAGE))
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, quant.quant_matmul_w8a8_plain(x, qt))
    assert torch.equal(got, quant.split_k_matmul(x, qt, splits, w8a8=True))
    assert torch.equal(quant.quant_matmul_w8a8(x, qt), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 8])
def test_w8a8_splitk_takes_long_k_at_few_rows(cuda, m):
    """At M <= 8 with K past W8A8_GEMV_MAX_K (x would not fit the GEMV's
    shared memory) the split-K form runs: bit-equal, counted apart."""
    k, n = 20480, 3072
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = quant.QuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
        scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
    assert _build.query("sdtpu_w8a8_form", m, k) == 1
    before = _int8_splitk_counts(quant.quant_matmul_w8a8)
    got = quant.quant_matmul_w8a8(x, qt)
    assert _int8_splitk_counts(quant.quant_matmul_w8a8) == [before[0] + 1, before[1] + 1, *before[2:]]
    assert torch.equal(got, quant.quant_matmul_w8a8_plain(x, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["g16", "g32", "w8a16"])
@pytest.mark.parametrize("m", INT8_SPLITK_ROWS)
@pytest.mark.parametrize("k,n", GQ_SPLITK_SHAPES)
def test_gq_splitk_kernel_matches_plain(cuda, mode, m, k, n):
    """One counted launch of the group-dequant / W8A16 split-K form within
    ``GQ_REL_TOL`` of the plain version and of the plain split-and-sum at
    the splits the library reports; the split-and-sum without its last split
    beyond the limit where K is split; a second call bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    if mode == "w8a16":
        fn, plain = quant.w8a16_matmul, quant.w8a16_matmul_plain
        qt = quant.QuantTensor(
            q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
            scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
    else:
        fn, plain = quant.gq_matmul, quant.group_quant_matmul_plain
        qt = _group_weight(g, n, k, int(mode[1:]), False, cuda)
    before = _int8_splitk_counts(fn)
    got = fn(x, qt)
    assert _int8_splitk_counts(fn) == [before[0] + 1, before[1] + 1, *before[2:]]
    splits = _build.query("sdtpu_gq_splits", m, n, k)
    assert 1 <= splits <= min(8, -(-k // quant.SPLITK_STAGE))
    want = plain(x, qt)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    limit = chip_smoke.GQ_REL_TOL["bf16"] * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= limit
    split = quant.split_k_matmul(x, qt, splits)
    assert (got.float() - split.float()).abs().max().item() <= limit
    if splits > 1:
        dropped = quant.split_k_matmul(x, qt, splits, keep=splits - 1)
        assert (dropped.float() - want.float()).abs().max().item() > limit
    assert torch.equal(fn(x, qt), got)


@pytest.mark.cuda
def test_int8_splitk_forms_by_rows(cuda):
    """W8A8 and the group / W8A16 modes name their split-K form at 9, 77
    and 127 rows and the wgmma kernel at 128, by shape alone; the affine mode
    keeps mma.sync below 128."""
    rows = (9, 77, 127, 128)
    assert [_build.query("sdtpu_w8a8_form", m, 2048) for m in rows] == [1, 1, 1, 2]
    for mode in (quant.GQ_MODE_GROUP, quant.GQ_MODE_ROW_SCALE):
        assert [_build.query("sdtpu_gq_form", 0, mode, m) for m in rows] == [4, 4, 4, 2]
    assert [_build.query("sdtpu_gq_form", 0, quant.GQ_MODE_AFFINE, m) for m in rows] == [1, 1, 1, 2]
    assert [_build.query("sdtpu_w8a8_splits", m, 1280, 2048) > 0 for m in rows] == [True] * 3 + [False]
    assert [_build.query("sdtpu_gq_splits", m, 1280, 2048) > 0 for m in rows] == [True] * 3 + [False]


# M <= 8 takes the weight-streaming GEMV: N off the 16-row block (2, 77,
# 130), K off the 64-wide K tile (200, the padded nibbles random), a row of
# Kp / 2 = 544 bytes whose last 64-byte segment is half past the row (1040;
# at K = 64 the only segment is), the DiT's modulation widths, and a K whose
# x rows would not fit shared memory whole (15360)
Q4_GEMV_SHAPES = [(64, 2), (200, 77), (1040, 130), (3072, 3072), (3072, 18432), (15360, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("m", [1, 2, 5, 8])
@pytest.mark.parametrize("k,n", Q4_GEMV_SHAPES)
def test_q4_gemv_kernel_matches_plain(cuda, group, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n + group)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = _q4_weight(g, n, k, group, cuda)
    counts = ("launches", "launches_gemv", "launches_wgmma")
    before = [getattr(quant.q4_matmul, c) for c in counts]
    got = quant.q4_matmul(x, qt)
    assert [getattr(quant.q4_matmul, c) for c in counts] == [before[0] + 1, before[1] + 1, before[2]]
    want = quant.q4_matmul_plain(x, qt)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6 * want.float().abs().max().item()


@pytest.mark.cuda
def test_q4_form_by_rows(cuda):
    """The library picks the form by dtype and M alone (bf16: 0 the GEMV, 1
    split-K, 2 wgmma; float32: 3 at every M), and the wrapper counts the
    form the library ran."""
    edges = (1, quant.Q4_GEMV_MAX_M, quant.Q4_GEMV_MAX_M + 1, quant.Q4_WGMMA_MIN_M - 1,
             quant.Q4_WGMMA_MIN_M)
    assert [_build.query("sdtpu_q4_form", 0, m) for m in edges] == [0, 0, 1, 1, 2]
    assert [_build.query("sdtpu_q4_form", 1, m) for m in edges] == [3] * len(edges)
    g = torch.Generator(device=cuda).manual_seed(0)
    qt = _q4_weight(g, 256, 512, 32, cuda)
    counts = ("launches_gemv", "launches_splitk", "launches_wgmma", "launches_f32")
    for dtype in (torch.bfloat16, torch.float32):
        for m in edges:
            x = torch.randn((m, 512), generator=g, device=cuda, dtype=dtype)
            before = [getattr(quant.q4_matmul, c) for c in counts]
            quant.q4_matmul(x, qt)
            form = _build.query("sdtpu_q4_form", _build.DTYPE_CODES[dtype], m)
            assert [getattr(quant.q4_matmul, c) for c in counts] == [
                b + (form == f) for f, b in enumerate(before)]


@pytest.mark.cuda
def test_q4_tile_choice_by_shape(cuda):
    """The launcher's x-row tile is a function of the shape alone; the card
    tests' shapes reach every tile, and M < 128 takes the split-K form."""
    tiles = {_build.query("sdtpu_q4_tile_rows", m, n) for m, _, n in Q4_WGMMA_SHAPES}
    assert tiles == {64, 128, 256}
    assert _build.query("sdtpu_q4_tile_rows", quant.Q4_WGMMA_MIN_M - 1, 4096) == 0
    g = torch.Generator(device=cuda).manual_seed(0)
    qt = _q4_weight(g, 256, 512, 32, cuda)
    before = (quant.q4_matmul.launches, quant.q4_matmul.launches_wgmma)
    quant.q4_matmul(torch.randn((quant.Q4_WGMMA_MIN_M - 1, 512), device=cuda, dtype=torch.bfloat16), qt)
    assert (quant.q4_matmul.launches, quant.q4_matmul.launches_wgmma) == (before[0] + 1, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mask_shape,flash", [((2, 3, 40, 56), False), ((2, 1, 40, 56), False),
                                              ((1, 3, 40, 56), False), ((1, 1, 40, 56), True),
                                              ((40, 56), True)])
def test_attention_routes_masks_as_the_reference(cuda, mask_shape, flash):
    """A mask whose leading dims are not all 1 goes to the plain attention,
    as the reference sends it to XLA; one that broadcasts as [Lq, Lk]
    launches the kernel.  flash_attention itself still refuses the former."""
    g = torch.Generator(device=cuda).manual_seed(len(mask_shape))
    q = torch.randn((2, 3, 40, 64), generator=g, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn((2, 3, 56, 64), generator=g, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    mask = torch.randn(mask_shape, generator=g, device=cuda)
    before = fa.flash_attention.launches
    got = attention(q, k, v, mask=mask)
    assert fa.flash_attention.launches == before + flash
    want = fa.plain_attention(q, k, v, mask=mask)
    if flash:
        assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()
    else:
        assert torch.equal(got, want)
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v, mask=mask)


def _group_weight(g, n, k, group, affine, device):
    """Random int8 blocks with random scales (and zeros): every group differs."""
    kp = -(-k // group) * group
    q = torch.randint(-127, 128, (n, kp), generator=g, device=device, dtype=torch.int8)
    scale = torch.rand((n, kp // group), generator=g, device=device) * 4e-4 + 1e-5
    zero = torch.rand((n, kp // group), generator=g, device=device) * 1e-2 if affine else None
    return quant.GroupQuantTensor(q=q, scale=scale, zero=zero, k=k, group=group)


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err <= (2 ** -6 if dtype == torch.bfloat16 else 1e-5) * scale


# bf16 calls with M >= 128 take the TMA + wgmma kernel: M at the threshold
# and one past it, FLUX's 4352 tokens, N off the 128-row weight tile, K = Kp
# and K = 272 (group 32 pads it to Kp = 288)
GQ_WGMMA_SHAPES = [(128, 256, 200), (129, 272, 257), (4352, 3072, 384), (4352, 1040, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("form,dtype", [  # the weight-stationary kernel takes bf16 only
    ("gq_matmul", torch.bfloat16), ("gq_matmul", torch.float32), ("gq_matmul_ws", torch.bfloat16),
    ("gq_zero_matmul", torch.bfloat16), ("gq_zero_matmul", torch.float32)])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m,k,n", sorted({(1, 32, 8), (3, 48, 130), (600, 1040, 64), *GQ_WGMMA_SHAPES}))
def test_group_quant_kernels_match_plain(cuda, form, dtype, group, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * group)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=dtype)
    qt = _group_weight(g, n, k, group, form == "gq_zero_matmul", cuda)
    fn = getattr(quant, form)
    before = (fn.launches, getattr(fn, "launches_f32", 0))
    got = fn(x, qt)
    assert (fn.launches, getattr(fn, "launches_f32", 0)) == (before[0] + 1,
                                                            before[1] + (dtype == torch.float32))
    assert got.dtype == dtype and got.shape == (m, n)
    assert _close(got, quant.group_quant_matmul_plain(x, qt), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", sorted({(1, 16, 8), (3, 48, 130), (300, 1040, 64), *GQ_WGMMA_SHAPES}))
def test_w8a16_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = quant.QuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
        scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
    before = quant.w8a16_matmul.launches
    got = quant.w8a16_matmul(x, qt)
    assert quant.w8a16_matmul.launches == before + 1
    assert _close(got, quant.w8a16_matmul_plain(x, qt), torch.bfloat16)


# M <= 8 takes the weight-streaming GEMV (symmetric groups and W8A16): N off
# the 16-row block (2, 77, 130); K = 64, one segment; K = 272, whose Kp = 288
# at group 32 leaves x short of the weight row; K = 1040, whose last 64-byte
# segment lies partly past Kp; the DiT's modulation widths; and K = 15360
GQ_GEMV_SHAPES = [(64, 2), (272, 77), (1040, 130), (3072, 3072), (3072, 18432), (15360, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m", [1, 2, 5, 8])
@pytest.mark.parametrize("k,n", GQ_GEMV_SHAPES)
def test_gq_gemv_kernel_matches_plain(cuda, group, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n + group)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = _group_weight(g, n, k, group, False, cuda)
    before = _gemv_counts(quant.gq_matmul)
    got = quant.gq_matmul(x, qt)
    assert _gemv_counts(quant.gq_matmul) == [before[0] + 1, before[1] + 1, before[2]]
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert _close(got, quant.group_quant_matmul_plain(x, qt), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 5, 8])
@pytest.mark.parametrize("k,n", GQ_GEMV_SHAPES)
def test_w8a16_gemv_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = quant.QuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
        scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
    before = _gemv_counts(quant.w8a16_matmul)
    got = quant.w8a16_matmul(x, qt)
    assert _gemv_counts(quant.w8a16_matmul) == [before[0] + 1, before[1] + 1, before[2]]
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert _close(got, quant.w8a16_matmul_plain(x, qt), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(3072, 18432), (3072, 9216)])
def test_gq_gemv_rounds_as_often_to_nearest_as_the_plain_version(cuda, k, n):
    """The GEMV sums K in another order than the plain version's single
    matmul (split among warps, regrouped 16-k steps), so at M = 1 an output
    may round to the other neighbouring bf16.  It must round to the bf16
    nearest the exact sum at least as often as the plain version does: a
    less accurate sum would do so less often."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn((1, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = _group_weight(g, n, k, 32, False, cuda)
    w = quant.dequantize_group(qt, torch.bfloat16)
    nearest = (x.double() @ w.double().T).float().to(torch.bfloat16)
    got, want = quant.gq_matmul(x, qt), quant.group_quant_matmul_plain(x, qt)
    hit_got = (got == nearest).double().mean().item()
    hit_want = (want == nearest).double().mean().item()
    print(f"gq GEMV 1x{k}->{n}: nearest bf16 {hit_got:.4f} (plain {hit_want:.4f}), "
          f"outputs that differ from the plain version {(got != want).double().mean().item():.4f}")
    assert hit_got >= hit_want


@pytest.mark.cuda
def test_gq_form_by_rows(cuda):
    """The library picks the group-dequant form by dtype, mode and M alone
    (0 the GEMV, 1 mma.sync, 2 wgmma, 3 float32, 4 split-K); the affine mode
    keeps mma.sync at small M.  gq_matmul and w8a16_matmul count the form the
    library ran."""
    edges = (1, quant.GQ_GEMV_MAX_M, quant.GQ_GEMV_MAX_M + 1, quant.GQ_WGMMA_MIN_M - 1,
             quant.GQ_WGMMA_MIN_M)
    for mode in (quant.GQ_MODE_GROUP, quant.GQ_MODE_ROW_SCALE):
        assert [_build.query("sdtpu_gq_form", 0, mode, m) for m in edges] == [0, 0, 4, 4, 2]
    assert _build.query("sdtpu_gq_form", 0, quant.GQ_MODE_AFFINE, 1) == 1
    assert _build.query("sdtpu_gq_form", 1, quant.GQ_MODE_GROUP, 1) == 3
    g = torch.Generator(device=cuda).manual_seed(0)
    gq = _group_weight(g, 256, 512, 32, False, cuda)
    w8 = quant.quantize_per_channel(torch.randn((256, 512), generator=g, device=cuda) * 0.02)
    for m in edges:
        x = torch.randn((m, 512), generator=g, device=cuda, dtype=torch.bfloat16)
        for fn, qt, mode in ((quant.gq_matmul, gq, quant.GQ_MODE_GROUP),
                             (quant.w8a16_matmul, w8, quant.GQ_MODE_ROW_SCALE)):
            before = _gemv_counts(fn)
            fn(x, qt)
            form = _build.query("sdtpu_gq_form", 0, mode, m)
            assert _gemv_counts(fn) == [before[0] + 1, before[1] + (form == 0),
                                        before[2] + (form == 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,dtype,affine,form", [
    (1, torch.bfloat16, False, "gq_matmul"),        # modulation linears
    (256, torch.bfloat16, False, "gq_matmul"),      # text tokens
    (1024, torch.bfloat16, False, "gq_matmul_ws"),  # image tokens
    (1024, torch.float32, False, "gq_matmul"),
    (1024, torch.bfloat16, True, "gq_zero_matmul"),
])
def test_group_quant_matmul_chooses_the_kernel_by_shape(cuda, m, dtype, affine, form):
    g = torch.Generator(device=cuda).manual_seed(0)
    qt = _group_weight(g, 96, 128, 32, affine, cuda)
    x = torch.randn((m, 128), generator=g, device=cuda, dtype=dtype)
    counts = {f: getattr(quant, f).launches for f in ("gq_matmul", "gq_matmul_ws", "gq_zero_matmul")}
    quant.group_quant_matmul(x, qt)
    for f, c in counts.items():
        assert getattr(quant, f).launches == c + (f == form)


@pytest.mark.cuda
def test_quant_matmul_reads_the_mode_at_each_call(cuda, monkeypatch):
    qt = quant.quantize_per_channel(torch.randn((64, 128), device=cuda))
    x = torch.randn((4, 128), device=cuda, dtype=torch.bfloat16)
    w8a8, w8a16 = quant.quant_matmul_w8a8.launches, quant.w8a16_matmul.launches
    quant.quant_matmul(x, qt)
    monkeypatch.setenv("SDTPU_QUANT_MODE", "w8a16")
    quant.quant_matmul(x, qt)
    assert (quant.quant_matmul_w8a8.launches, quant.w8a16_matmul.launches) == (w8a8 + 1, w8a16 + 1)


# float32 x takes the split-x TF32 form at every M: the GEMV's (1, 8), the
# split-K form's (9, 127) and the wgmma kernel's (128, 4352) rows in bf16,
# across its 16-, 64- and 128-row tiles (16 up to M = 16); N off the 128-row
# tile, K off the 64-wide K stage (200: Kp = 256, the padded nibbles random),
# and K = 1040 (Kp = 1088)
F32_ROWS = [1, 8, 9, 127, 128, 4352]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("m", F32_ROWS)
@pytest.mark.parametrize("k,n", [(64, 2), (200, 77), (1040, 130)])
def test_q4_f32_kernel_matches_plain(cuda, group, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n + group)
    x = torch.randn((m, k), generator=g, device=cuda)
    qt = _q4_weight(g, n, k, group, cuda)
    counts = ("launches", "launches_f32", "launches_gemv", "launches_wgmma")
    before = [getattr(quant.q4_matmul, c) for c in counts]
    got = quant.q4_matmul(x, qt)
    assert [getattr(quant.q4_matmul, c) for c in counts] == [before[0] + 1, before[1] + 1, *before[2:]]
    assert got.dtype == torch.float32 and got.shape == (m, n) and torch.isfinite(got).all()
    assert _close(got, quant.q4_matmul_plain(x, qt), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m", F32_ROWS)
@pytest.mark.parametrize("k,n", [(16, 8), (48, 130), (272, 257), (1040, 64)])
def test_w8a16_f32_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    qt = quant.QuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
        scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
    before = _gemv_counts(quant.w8a16_matmul) + [quant.w8a16_matmul.launches_f32]
    got = quant.w8a16_matmul(x, qt)
    assert _gemv_counts(quant.w8a16_matmul) + [quant.w8a16_matmul.launches_f32] == [
        before[0] + 1, before[1], before[2], before[3] + 1]
    assert got.dtype == torch.float32 and got.shape == (m, n) and torch.isfinite(got).all()
    assert _close(got, quant.w8a16_matmul_plain(x, qt), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m", F32_ROWS)
@pytest.mark.parametrize("k,n", [(32, 8), (272, 257), (1040, 130)])
def test_gq_f32_kernel_matches_plain(cuda, affine, group, m, k, n):
    """The group-dequant and affine float32 forms at ragged M, N and K
    (K = 272: Kp = 288 at group 32, x short of the weight row); each counts
    its float32 launch."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n + group)
    x = torch.randn((m, k), generator=g, device=cuda)
    qt = _group_weight(g, n, k, group, affine, cuda)
    fn = quant.gq_zero_matmul if affine else quant.gq_matmul
    before = (fn.launches, fn.launches_f32)
    got = fn(x, qt)
    assert (fn.launches, fn.launches_f32) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (m, n) and torch.isfinite(got).all()
    assert _close(got, quant.group_quant_matmul_plain(x, qt), torch.float32)


# chip_smoke.py's float32 cases: (kind, M, K, N, group)
F32_SMOKE_CASES = ([("q4", *c) for c in chip_smoke.Q4_F32_CASES]
                   + [(kind, *c) for c in chip_smoke.GQ_F32_CASES for kind in ("gq", "affine")]
                   + [("w8a16", *c, None) for c in chip_smoke.W8A16_F32_CASES])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,k,n,group", F32_SMOKE_CASES)
def test_f32_smoke_cases_hold_the_limit_the_one_pass_fault_misses(cuda, kind, m, k, n, group):
    """At chip_smoke.py's float32 shapes (the DiT's long K included) each form
    lies within GQ_REL_TOL["f32"] of the largest output of its plain version,
    and the one-pass TF32 fault does not."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    if kind == "q4":
        qt = _q4_weight(g, n, k, group, cuda)
        got, want, w = quant.q4_matmul(x, qt), quant.q4_matmul_plain(x, qt), quant.dequantize_q4(
            qt, torch.float32)
    elif kind == "w8a16":
        qt = quant.QuantTensor(
            q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
            scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
        got, want, w = quant.w8a16_matmul(x, qt), quant.w8a16_matmul_plain(x, qt), quant.dequantize(
            qt, torch.float32)
    else:
        qt = _group_weight(g, n, k, group, kind == "affine", cuda)
        fn = quant.gq_zero_matmul if kind == "affine" else quant.gq_matmul
        got, want = fn(x, qt), quant.group_quant_matmul_plain(x, qt)
        w = quant.dequantize_group(qt, torch.float32)
    tol = chip_smoke.GQ_REL_TOL["f32"] * want.abs().max().item()
    err = (got - want).abs().max().item()
    fault = chip_smoke._one_pass_tf32_matmul_fault(x, w, want)["one_pass_tf32"]
    print(f"{kind} {m}x{k}->{n} g{group}: err {err:.3g}, one-pass TF32 {fault:.3g}, limit {tol:.3g}")
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert err <= tol < fault


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,k,n", [
    ("q4", 256, 4096, 10240),     # T5-XXL's wi_0 / wi_1 at 256 tokens, group 64
    ("q4", 256, 10240, 4096),     # T5-XXL's wo
    ("w8a16", 4352, 3072, 12288),  # a DiT MLP linear at 1024²
    ("w8a16", 1, 3072, 18432)])    # a DiT modulation linear
def test_f32_full_width_linears_match_plain(cuda, kind, m, k, n):
    """The default float32 pipeline's T5 4-bit linears and a W8A16 DiT
    linear, at full width, against their plain versions."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    if kind == "q4":
        qt = _q4_weight(g, n, k, 64, cuda)
        got, want = quant.q4_matmul(x, qt), quant.q4_matmul_plain(x, qt)
    else:
        qt = quant.QuantTensor(
            q=torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
            scale=torch.rand((n,), generator=g, device=cuda) * 4e-4 + 1e-5)
        got, want = quant.w8a16_matmul(x, qt), quant.w8a16_matmul_plain(x, qt)
    assert got.dtype == torch.float32 and _close(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("bh,lq,lk,d", [
    ((1, 24), 200, 300, 128), ((2, 3), 129, 127, 128), ((1, 24), 1280, 1000, 128),
    ((2, 12), 77, 77, 64), ((1, 4), 150, 129, 64), ((3, 2), 257, 385, 64),
    ((1, 1), 4096, 4096, 512), ((1, 1), 130, 20, 512), ((1, 1), 64, 100, 512),
    ((1, 2), 300, 200, 512), ((3, 2), 257, 1000, 512), ((2, 3), 1030, 77, 512),
    ((1, 1), 4096, 4096, 320), ((2, 1), 4096, 77, 320), ((1, 2), 300, 200, 320), ((3, 2), 257, 1000, 320)])
def test_flash_f32_kernel_ragged_edges(cuda, bias, bh, lq, lk, d):
    """float32 takes the 3xTF32 kernel: the bf16 ragged-edge shapes with and
    without the dense bias (at D 512 the keys split where the grid is small),
    within the f32 limit, which the one-pass TF32 fault must exceed."""
    g = torch.Generator(device=cuda).manual_seed(lq + lk + d)
    q = torch.randn((*bh, lq, d), generator=g, device=cuda)
    k, v = (torch.randn((*bh, lk, d), generator=g, device=cuda) for _ in range(2))
    mask = torch.randn((lq, lk), generator=g, device=cuda) if bias else None
    before = (fa.flash_attention.launches, fa.flash_attention.launches_f32,
              fa.flash_attention.launches_d512)
    got = fa.flash_attention(q, k, v, mask=mask)
    assert (fa.flash_attention.launches, fa.flash_attention.launches_f32,
            fa.flash_attention.launches_d512) == (before[0] + 1, before[1] + 1, before[2])
    want = fa.plain_attention(q, k, v, mask=mask)
    tol = FLASH_F32_TOL * want.abs().max().item()
    err = (got - want).abs().max().item()
    fault = chip_smoke._one_pass_tf32_fault(q, k, v, mask, want)["one_pass_tf32"]
    print(f"flash f32 {bh} {lq}x{lk} D {d} bias {bias}: err {err:.3g}, one-pass TF32 {fault:.3g}, "
          f"limit {tol:.3g}")
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert err <= tol < fault


def _all_launch_counts():
    """Every wrapper's launch counts, the forms counted apart included."""
    wrappers = (fa.flash_attention, quant.quant_matmul_w8a8, quant.q4_matmul, quant.gq_matmul,
                quant.gq_matmul_ws, quant.gq_zero_matmul, quant.w8a16_matmul)
    return {(f.__name__, a): getattr(f, a) for f in wrappers for a in dir(f)
            if a.startswith("launches")}


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    counts = _all_launch_counts()
    assert all((f, "launches_gemv") in counts
               for f in ("quant_matmul_w8a8", "gq_matmul", "w8a16_matmul"))
    assert all((f, "launches_f32") in counts
               for f in ("flash_attention", "q4_matmul", "w8a16_matmul", "gq_matmul",
                         "gq_zero_matmul"))
    q = torch.randn((1, 1, 8, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)  # head dim 32 has no kernel
    for d in (48, 96, 120):  # nor does any other head dim outside SUPPORTED_HEAD_DIMS
        qd = torch.randn((1, 1, 8, d), device=cuda)
        with pytest.raises(ValueError, match=f"head dim {d}"):
            fa.flash_attention(qd, qd, qd)
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), q.half(), q.half())
    qt = quant.quantize_per_channel(torch.randn((8, 24), device=cuda))
    with pytest.raises(ValueError):
        quant.quant_matmul_w8a8(torch.randn((2, 24), device=cuda), qt)  # K % 16
    q4 = quant.quantize_q4(torch.randn((8, 64), device=cuda))
    with pytest.raises(ValueError):
        quant.q4_matmul(torch.randn((2, 64), device=cuda).half(), q4)  # float16 activations
    gq = quant.quantize_group(torch.randn((8, 64), device=cuda))
    with pytest.raises(ValueError):
        quant.gq_matmul_ws(torch.randn((600, 64), device=cuda), gq)  # float32 activations
    with pytest.raises(ValueError):
        quant.gq_zero_matmul(torch.randn((2, 64), device=cuda), gq)  # no zero point
    with pytest.raises(ValueError):  # group 64 is no GGUF block size
        quant.gq_matmul(torch.randn((2, 64), device=cuda), quant.quantize_group(
            torch.randn((8, 64), device=cuda), group=64))
    with pytest.raises(ValueError):
        quant.w8a16_matmul(torch.randn((2, 32), device=cuda).half(), quant.quantize_per_channel(
            torch.randn((8, 32), device=cuda)))  # float16 activations
    with pytest.raises(ValueError):
        quant.w8a16_matmul(torch.randn((2, 24), device=cuda), quant.quantize_per_channel(
            torch.randn((8, 24), device=cuda)))  # K % 16, float32 too
    assert _all_launch_counts() == counts  # nothing refused was counted


def test_cpu_tensors_run_the_plain_versions_without_launching():
    counts = (fa.flash_attention.launches, quant.quant_matmul_w8a8.launches,
              quant.q4_matmul.launches, quant.q4_matmul.launches_wgmma,
              quant.q4_matmul.launches_gemv, quant.q4_matmul.launches_splitk)
    q = torch.randn((1, 2, 8, 64))
    assert torch.equal(fa.flash_attention(q, q, q), fa.plain_attention(q, q, q))
    x = torch.randn((3, 32))
    qt = quant.quantize_per_channel(torch.randn((8, 32)))
    assert torch.equal(quant.quant_matmul_w8a8(x, qt), quant.quant_matmul_w8a8_plain(x, qt))
    q4 = quant.quantize_q4(torch.randn((8, 64)))
    x4 = torch.randn((3, 64))
    assert torch.equal(quant.q4_matmul(x4, q4), quant.q4_matmul_plain(x4, q4))
    x4 = torch.randn((quant.Q4_WGMMA_MIN_M, 64))  # the wgmma form's M, on the CPU
    assert torch.equal(quant.q4_matmul(x4, q4), quant.q4_matmul_plain(x4, q4))
    x4 = torch.randn((1, 64))  # the GEMV's M, on the CPU
    assert torch.equal(quant.q4_matmul(x4, q4), quant.q4_matmul_plain(x4, q4))
    x4 = torch.randn((77, 64))  # the split-K form's M, on the CPU
    assert torch.equal(quant.q4_matmul(x4, q4), quant.q4_matmul_plain(x4, q4))
    assert counts == (fa.flash_attention.launches, quant.quant_matmul_w8a8.launches,
                      quant.q4_matmul.launches, quant.q4_matmul.launches_wgmma,
                      quant.q4_matmul.launches_gemv, quant.q4_matmul.launches_splitk)
    assert _build.library.cache_info().currsize == 0


def test_cpu_tensors_run_the_group_and_w8a16_plain_versions_without_launching():
    counts = _all_launch_counts()
    x1 = torch.randn((1, 64))  # the GEMV's M, on the CPU
    gq1 = quant.quantize_group(torch.randn((8, 64)))
    assert torch.equal(quant.gq_matmul(x1, gq1), quant.group_quant_matmul_plain(x1, gq1))
    qt1 = quant.quantize_per_channel(torch.randn((8, 64)))
    assert torch.equal(quant.w8a16_matmul(x1, qt1), quant.w8a16_matmul_plain(x1, qt1))
    x = torch.randn((600, 64))
    gq = quant.quantize_group(torch.randn((8, 64)))
    gz = quant.GroupQuantTensor(q=gq.q, scale=gq.scale, zero=gq.scale * 3, k=64, group=32)
    want, want_z = quant.group_quant_matmul_plain(x, gq), quant.group_quant_matmul_plain(x, gz)
    assert not torch.equal(want, want_z)
    for f in (quant.gq_matmul, quant.gq_matmul_ws, quant.group_quant_matmul):
        assert torch.equal(f(x, gq), want)
    assert torch.equal(quant.gq_zero_matmul(x, gz), want_z)
    qt = quant.quantize_per_channel(torch.randn((8, 64)))
    assert torch.equal(quant.w8a16_matmul(x, qt), quant.w8a16_matmul_plain(x, qt))
    assert _all_launch_counts() == counts
    assert _build.library.cache_info().currsize == 0
