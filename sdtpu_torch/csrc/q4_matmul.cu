// Packed 4-bit weight matmul for Hopper: out[m, n] = sum_k x[m, k] * w[n, k]
// with w[n, k] = (nibble(n, k) - 8) * scale[n, k / G], dequantized to bf16,
// for scale groups G = 64 (the q4_0 class the bench synthesizes), 32 (a q4_0
// GGUF's own blocks) and 16 (q3_k-class blocks).
//
// Replaces the TPU kernel `_q4_matmul_kernel` (sdtpu/ops/quant.py:845).  The
// port stores 4-bit weights in its own layout, chosen for this kernel (the
// TPU's split-half layout served Mosaic's sublane tiling): packed uint8
// [N, Kp/2] row-major, byte j of a row holding k = 2j in the low nibble and
// k = 2j + 1 in the high nibble, and f32 scales [N, Kp/G], Kp a multiple of
// 64.  Each thread unpacks 32 k of one weight row, which lie in one group for
// G = 64 or 32 and in two for G = 16, so it reads one or two scales.
//
// What bounds it on the card: at T5-XXL's shapes (M = 256 per prompt,
// K x N = 4096 x 4096, 4096 x 10240, 10240 x 4096) the weight read is 0.5
// byte per element and the tile work is small, so the kernel is bound by
// the dequantize step and by latency more than by the tensor cores.  The
// weight never exists in device memory at 16 bits: each block unpacks its
// 128 x 64 tile into shared memory as bf16 (f32 multiply, then one rounding,
// as the TPU does) and runs mma.sync m16n8k16 with f32 accumulation.  Simple
// synchronous tile loads; pipelining is later work.  x is bf16 with K a
// multiple of 8; rows, columns and K past the edge are zero-filled.
#include "common.cuh"

namespace sdtpu {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kRow = kBK + 8;                 // bf16 row padding: 144-byte rows
constexpr int kThreads = 256;  // 8 warps: 2 along M (32 rows) x 4 along N (32 cols)

template <int G>
__global__ void __launch_bounds__(kThreads)
q4_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
               int m, int n, int k, int kp) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBM * kRow];
  __shared__ __align__(16) __nv_bfloat16 ws[kBN * kRow];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int groups = kp / G;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < kp; k0 += kBK) {
    // x tile: 64 rows x 64 bf16 = 512 chunks of 8 elements.
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < m && k0 + col < k)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * k + k0 + col);
      *reinterpret_cast<uint4*>(xs + r * kRow + col) = val;
    }
    // weight tile: 128 rows x 32 packed bytes = 256 chunks of 16 bytes.
    {
      const int r = tid >> 1, half = tid & 1;
      __nv_bfloat16* dst = ws + r * kRow + half * 32;
      if (n0 + r < n) {
        const uint4 pk = *reinterpret_cast<const uint4*>(
            packed + (size_t)(n0 + r) * (kp / 2) + k0 / 2 + half * 16);
        // byte i holds k = kb + 2i and kb + 2i + 1
        const int kb = k0 + half * 32;
        const float* srow = scale + (size_t)(n0 + r) * groups + kb / G;
        const float s0 = srow[0];
        const float s1 = G == 16 ? srow[1] : s0;
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&pk);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float sc = i < 8 ? s0 : s1;
          const float lo = static_cast<float>(static_cast<int>(bytes[i] & 0xF) - 8);
          const float hi = static_cast<float>(static_cast<int>(bytes[i] >> 4) - 8);
          *reinterpret_cast<uint32_t*>(dst + 2 * i) = pack_bf16x2(lo * sc, hi * sc);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p = xs + (wm * 32 + i * 16 + g) * kRow + kk + tq * 2;
        a[i][0] = ld_u32(p);
        a[i][1] = ld_u32(p + 8 * kRow);
        a[i][2] = ld_u32(p + 8);
        a[i][3] = ld_u32(p + 8 * kRow + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = ws + (wn * 32 + j * 8 + g) * kRow + kk + tq * 2;
        b[j][0] = ld_u32(p);
        b[j][1] = ld_u32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + h * 8;
        const int col = n0 + wn * 32 + j * 8 + tq * 2;
        if (row >= m) continue;
        if (col + 1 < n && (n & 1) == 0) {  // paired store needs 4-byte alignment
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (col < n) out[(size_t)row * n + col] = __float2bfloat16_rn(acc[i][j][2 * h]);
          if (col + 1 < n)
            out[(size_t)row * n + col + 1] = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
        }
      }
}

}  // namespace
}  // namespace sdtpu

// x bf16 [m, k]; packed uint8 [n, kp/2]; scale f32 [n, kp/group] -> out
// bf16 [m, n].  Needs k <= kp, k % 8 == 0, kp % 64 == 0 and group 16, 32 or 64.
extern "C" int sdtpu_q4_matmul(const void* x, const void* packed, const void* scale,
                               void* out, int m, int n, int k, int kp, int group,
                               void* stream) {
  using namespace sdtpu;
  if (m <= 0 || n <= 0 || k <= 0 || k > kp || k % 8 || kp % kBK ||
      (group != 16 && group != 32 && group != 64))
    return cudaErrorInvalidValue;
  dim3 grid(ceil_div(n, kBN), ceil_div(m, kBM));
  auto kernel = group == 16 ? q4_gemm_kernel<16>
                : group == 32 ? q4_gemm_kernel<32> : q4_gemm_kernel<64>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), m, n, k, kp);
  return cudaGetLastError();
}
