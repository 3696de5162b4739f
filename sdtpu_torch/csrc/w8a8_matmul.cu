// W8A8 int8 matmul for Hopper:
//   out[m, n] = cast((float(sum_k xq[m, k] * wq[n, k]) * sx[m]) * sw[n])
//
// Replaces the TPU kernel `_w8a8_matmul_kernel` (sdtpu/ops/quant.py:416) and
// the XLA int8 dot the TPU path takes by default (quant.py:518-521).  Two
// kernels: `quantize_rows` computes the dynamic per-token activation scale
// (amax / 127, 1 where amax is 0) and rounds x / s half-to-even into int8,
// exactly as `quantize_activations` (quant.py:406) does; the GEMM then
// accumulates int8 x int8 in int32 on the tensor cores (mma.sync m16n8k32)
// and applies the f32 epilogue in the TPU order, acc * s_x first and then
// * s_w, so the result is bit-equal to an exact reference.
//
// What bounds it on the card: at FLUX's large-M calls (M = 1280 or 4352,
// K and N in the thousands) the product is compute bound, at 2 ops per
// weight byte per row; at M = 1 (the modulation linears) it is bound by
// reading the int8 weight once.  This first form loads 128x64 int8 tiles of
// both operands synchronously into padded shared memory (no cp.async/TMA
// pipelining, no wgmma): simple and right first.  Every M is taken, M = 1
// included; rows and columns past the edge are zero-filled, and K must be a
// multiple of 16 (16-byte loads).
#include "common.cuh"

#include <math.h>

namespace sdtpu {
namespace {

constexpr int kQuantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int k) {
  __shared__ float warp_max[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * k;
  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += kQuantThreads) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  if (threadIdx.x == 0) sx[row] = s;
  int8_t* qr = xq + row * k;
  for (int i = threadIdx.x; i < k; i += kQuantThreads) {
    const float v = rintf(__fdiv_rn(to_f32(xr[i]), s));  // half to even
    qr[i] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
}

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kRow = kBK + 16;  // 80-byte rows: conflict-free fragment loads
constexpr int kThreads = 256;   // 8 warps: 4 along M (32 rows) x 2 along N (64 cols)

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
w8a8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 TOut* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) int8_t xs[kBM * kRow];
  __shared__ __align__(16) int8_t ws[kBN * kRow];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // 128 rows x 64 bytes per operand = 512 chunks of 16 bytes.
    for (int c = tid; c < kBM * kBK / 16; c += kThreads) {
      const int r = c >> 2, col = (c & 3) * 16;
      uint4 a = make_uint4(0, 0, 0, 0), b = make_uint4(0, 0, 0, 0);
      if (k0 + col < k) {
        if (m0 + r < m) a = *reinterpret_cast<const uint4*>(xq + (size_t)(m0 + r) * k + k0 + col);
        if (n0 + r < n) b = *reinterpret_cast<const uint4*>(wq + (size_t)(n0 + r) * k + k0 + col);
      }
      *reinterpret_cast<uint4*>(xs + r * kRow + col) = a;
      *reinterpret_cast<uint4*>(ws + r * kRow + col) = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = xs + (wm * 32 + i * 16 + g) * kRow + kk + tq * 4;
        a[i][0] = ld_u32(p);
        a[i][1] = ld_u32(p + 8 * kRow);
        a[i][2] = ld_u32(p + 16);
        a[i][3] = ld_u32(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* p = ws + (wn * 64 + j * 8 + g) * kRow + kk + tq * 4;
        b[j][0] = ld_u32(p);
        b[j][1] = ld_u32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8_16832(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + i * 16 + g + ((e & 2) ? 8 : 0);
        const int col = n0 + wn * 64 + j * 8 + tq * 2 + (e & 1);
        if (row < m && col < n) {
          float r = __fmul_rn(__int2float_rn(acc[i][j][e]), sx[row]);
          r = __fmul_rn(r, sw[col]);
          out[(size_t)row * n + col] = from_f32<TOut>(r);
        }
      }
}

}  // namespace
}  // namespace sdtpu

// x: contiguous [m, k] in `dtype` -> xq int8 [m, k], sx f32 [m].
extern "C" int sdtpu_w8a8_quantize_rows(int dtype, const void* x, void* xq, void* sx,
                                        int m, int k, void* stream) {
  using namespace sdtpu;
  if (m <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    quantize_rows_kernel<<<m, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(sx), k);
  } else if (dtype == kF32) {
    quantize_rows_kernel<<<m, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), k);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// xq int8 [m, k], wq int8 [n, k], sx f32 [m], sw f32 [n] -> out [m, n] in
// `out_dtype`.  k must be a multiple of 16 and the pointers 16-byte aligned.
extern "C" int sdtpu_w8a8_matmul(int out_dtype, const void* xq, const void* wq,
                                 const void* sx, const void* sw, void* out, int m,
                                 int n, int k, void* stream) {
  using namespace sdtpu;
  if (m <= 0 || n <= 0 || k <= 0 || k % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(ceil_div(n, kBN), ceil_div(m, kBM));
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* fx = static_cast<const float*>(sx);
  const float* fw = static_cast<const float*>(sw);
  if (out_dtype == kBF16) {
    w8a8_gemm_kernel<<<grid, kThreads, 0, s>>>(a, b, fx, fw,
                                               static_cast<__nv_bfloat16*>(out), m, n, k);
  } else if (out_dtype == kF32) {
    w8a8_gemm_kernel<<<grid, kThreads, 0, s>>>(a, b, fx, fw, static_cast<float*>(out), m, n, k);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
