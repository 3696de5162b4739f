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

from sdtpu_torch.ops import _build
from sdtpu_torch.ops import flash_attention as fa
from sdtpu_torch.ops import quant


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (3, 48, 130), (129, 272, 257), (300, 1040, 64)])
def test_w8a8_kernel_bit_equal(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    qt = quant.quantize_per_channel(torch.randn((n, k), generator=g, device=cuda) * 0.02)
    before = quant.quant_matmul_w8a8.launches
    got = quant.quant_matmul_w8a8(x, qt)
    assert quant.quant_matmul_w8a8.launches == before + 1
    assert torch.equal(got, quant.quant_matmul_w8a8_plain(x, qt))
    x32 = x.float()
    assert torch.equal(quant.quant_matmul_w8a8(x32, qt), quant.quant_matmul_w8a8_plain(x32, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
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
    scale = max(1.0, want.float().abs().max().item()) if dtype == torch.bfloat16 else 1.0
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


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
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn((1, 1, 8, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)  # head dim 32 has no kernel
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), q.half(), q.half())
    qt = quant.quantize_per_channel(torch.randn((8, 24), device=cuda))
    with pytest.raises(ValueError):
        quant.quant_matmul_w8a8(torch.randn((2, 24), device=cuda), qt)  # K % 16
    q4 = quant.quantize_q4(torch.randn((8, 64), device=cuda))
    with pytest.raises(ValueError):
        quant.q4_matmul(torch.randn((2, 64), device=cuda), q4)  # float32 activations


def test_cpu_tensors_run_the_plain_versions_without_launching():
    counts = (fa.flash_attention.launches, quant.quant_matmul_w8a8.launches,
              quant.q4_matmul.launches)
    q = torch.randn((1, 2, 8, 64))
    assert torch.equal(fa.flash_attention(q, q, q), fa.plain_attention(q, q, q))
    x = torch.randn((3, 32))
    qt = quant.quantize_per_channel(torch.randn((8, 32)))
    assert torch.equal(quant.quant_matmul_w8a8(x, qt), quant.quant_matmul_w8a8_plain(x, qt))
    q4 = quant.quantize_q4(torch.randn((8, 64)))
    x4 = torch.randn((3, 64))
    assert torch.equal(quant.q4_matmul(x4, q4), quant.q4_matmul_plain(x4, q4))
    assert counts == (fa.flash_attention.launches, quant.quant_matmul_w8a8.launches,
                      quant.q4_matmul.launches)
    assert _build.library.cache_info().currsize == 0
