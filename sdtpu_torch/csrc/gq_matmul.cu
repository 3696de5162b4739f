// Dequantize-in-the-tile int8 matmuls for Hopper: out[m, n] = sum_k x[m, k] * w[n, k]
// with the weight kept int8 in device memory and widened tile by tile.
//
// Replaces the TPU kernels
//   `_gq_matmul_kernel`      (sdtpu/ops/quant.py:616) -> gq_gemm_kernel<kGroup, G, 1>
//   `_gq_matmul_ws_kernel`   (sdtpu/ops/quant.py:652) -> gq_gemm_kernel<kGroup, G, kWsTiles>
//   `_gq_zero_matmul_kernel` (sdtpu/ops/quant.py:687) -> gq_gemm_kernel<kGroupZero, G, 1>
//   `_q_matmul_kernel`       (sdtpu/ops/quant.py:525) -> gq_gemm_kernel<kRowScale, 1, 1>
// and, for float32 activations, the parity kernel gq_gemm_f32_kernel.
//
// Weights are int8 [N, Kp] rows (the port's layout; the TPU stored the
// transpose for Mosaic).  The group forms carry f32 scales [N, Kp/G] on a
// GGUF checkpoint's block grid, G = 16 or 32, and the affine form f32 zeros
// of the same shape: w[n, k] = q * scale[n, k/G] - zero[n, k/G], computed in
// f32 (no contraction into an fma, so it is bit-equal to the plain version's
// multiply-then-subtract) and rounded once to bf16.  The W8A16 form widens q
// exactly to bf16 and applies its per-row scale to the f32 sum in the
// epilogue (acc * s[n], as the TPU kernel does).  The TPU's affine kernel
// factored the zero term as (group sums of x) . zero to keep the MXU busy;
// here the zero is subtracted per element while the tile is dequantized.
//
// What bounds it on the card: at FLUX's large M (1024-4352 tokens) the
// product is compute bound on paper, but this simple form loads each tile
// synchronously (global -> registers -> shared, then a barrier) before the
// mma.sync m16n8k16 work on it, so it is bound by load latency, not by the
// tensor cores and not by the dequant: the tile-per-block form widens each
// weight tile once per 64-row M tile, and the weight-stationary form
// (Tiles = kWsTiles) widens it once per kWsTiles M tiles into shared memory
// and runs those M tiles through it, their accumulators held in registers.  No
// scratch grows with M (the TPU kernel's full-M VMEM accumulator is not
// copied).  On the H100 the two forms measure the same at FLUX's shapes
// (PERF.md); cp.async/TMA pipelining and wgmma are the later work.  At M = 1
// (modulation linears) the product is bound by reading the int8 weight.  x
// is row-major [M, K] with K a multiple of 8; rows, columns and K past the
// edge are zero-filled.
#include "common.cuh"

namespace sdtpu {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kRow = kBK + 8;  // bf16 row padding: 144-byte rows
constexpr int kThreads = 256;  // 8 warps: 2 along M (32 rows) x 4 along N (32 cols)
constexpr int kWsTiles = 2;    // M tiles a weight-stationary block runs per weight tile

// How a weight tile is widened.
enum WMode : int { kGroup = 0, kGroupZero = 1, kRowScale = 2 };

// The block's [kBN x kBK] weight tile, widened to bf16 into shared memory.
// 512 chunks of 16 int8 values; a chunk starts at a multiple of 16 and so
// lies inside one scale group (G >= 16).
template <int Mode, int G>
__device__ __forceinline__ void load_w_tile(__nv_bfloat16* ws, const int8_t* __restrict__ q,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ zero, int n, int kp,
                                            int n0, int k0, int tid) {
#pragma unroll
  for (int it = 0; it < kBN * kBK / 16 / kThreads; ++it) {
    const int c = tid + it * kThreads;
    const int r = c >> 2, col = (c & 3) * 16;
    uint4* dst = reinterpret_cast<uint4*>(ws + r * kRow + col);
    const int row = n0 + r, kk = k0 + col;
    if (row >= n || kk >= kp) {
      dst[0] = make_uint4(0, 0, 0, 0);
      dst[1] = make_uint4(0, 0, 0, 0);
      continue;
    }
    const int4 raw = *reinterpret_cast<const int4*>(q + (size_t)row * kp + kk);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    float s = 1.f, z = 0.f;
    if (Mode != kRowScale) {
      const size_t gi = (size_t)row * (kp / G) + kk / G;
      s = scale[gi];
      if (Mode == kGroupZero) z = zero[gi];
    }
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float a = static_cast<float>(v[2 * i]), b = static_cast<float>(v[2 * i + 1]);
      if (Mode != kRowScale) {
        a = __fmul_rn(a, s);
        b = __fmul_rn(b, s);
      }
      if (Mode == kGroupZero) {
        a = __fsub_rn(a, z);
        b = __fsub_rn(b, z);
      }
      p[i] = pack_bf16x2(a, b);
    }
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// The [kBM x kBK] x tile (bf16) into shared memory: 512 chunks of 8.
__device__ __forceinline__ void load_x_tile(__nv_bfloat16* xs, const __nv_bfloat16* __restrict__ x,
                                            int m, int k, int m0, int k0, int tid) {
#pragma unroll
  for (int it = 0; it < kBM * kBK / 8 / kThreads; ++it) {
    const int c = tid + it * kThreads;
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m0 + r < m && k0 + col < k)
      val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * k + k0 + col);
    *reinterpret_cast<uint4*>(xs + r * kRow + col) = val;
  }
}

// One warp's 32 x 32 patch of the tile product, K = kBK.
__device__ __forceinline__ void mma_tile(float (&acc)[2][4][4], const __nv_bfloat16* xs,
                                         const __nv_bfloat16* ws, int wm, int wn, int g, int tq) {
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
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The warp's patch to bf16 out; kRowScale multiplies by scale[col] first.
template <int Mode>
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], __nv_bfloat16* out,
                                           const float* __restrict__ scale, int m, int n,
                                           int m0, int n0, int wm, int wn, int g, int tq) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + h * 8;
        const int col = n0 + wn * 32 + j * 8 + tq * 2;
        if (row >= m) continue;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (Mode == kRowScale) {
          if (col < n) v0 = __fmul_rn(v0, scale[col]);
          if (col + 1 < n) v1 = __fmul_rn(v1, scale[col + 1]);
        }
        if (col + 1 < n && (n & 1) == 0) {  // paired store needs 4-byte alignment
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < n) out[(size_t)row * n + col] = __float2bfloat16_rn(v0);
          if (col + 1 < n) out[(size_t)row * n + col + 1] = __float2bfloat16_rn(v1);
        }
      }
}

// A block owns kBN columns and Tiles consecutive 64-row M tiles.  Per K step
// it widens the weight tile once, loads the M tiles' x tiles beside it, and
// runs each through it.  Tiles = 1 is the tile-per-block form; Tiles =
// kWsTiles is the weight-stationary one, its accumulators in registers (118
// a thread, two blocks an SM).
template <int Mode, int G, int Tiles>
__global__ void __launch_bounds__(kThreads)
gq_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, const float* __restrict__ zero,
               __nv_bfloat16* __restrict__ out, int m, int n, int k, int kp) {
  __shared__ __align__(16) __nv_bfloat16 xs[Tiles * kBM * kRow];
  __shared__ __align__(16) __nv_bfloat16 ws[kBN * kRow];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * (kBM * Tiles), n0 = blockIdx.x * kBN;

  float acc[Tiles][2][4][4];
#pragma unroll
  for (int t = 0; t < Tiles; ++t) zero_acc(acc[t]);
  for (int k0 = 0; k0 < kp; k0 += kBK) {
    load_w_tile<Mode, G>(ws, q, scale, zero, n, kp, n0, k0, tid);
#pragma unroll
    for (int t = 0; t < Tiles; ++t) load_x_tile(xs + t * kBM * kRow, x, m, k, m0 + t * kBM, k0, tid);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < Tiles; ++t) mma_tile(acc[t], xs + t * kBM * kRow, ws, wm, wn, g, tq);
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < Tiles; ++t)
    if (m0 + t * kBM < m)
      store_tile<Mode>(acc[t], out, scale, m, n, m0 + t * kBM, n0, wm, wn, g, tq);
}

// float32 activations (the parity form): plain FMA, one 64 x 64 tile per
// block, each thread a 4 x 4 patch; the weight tile widened to f32.
constexpr int kFBM = 64, kFBN = 64, kFBK = 32;

template <int Mode, int G>
__global__ void __launch_bounds__(kThreads)
gq_gemm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, const float* __restrict__ zero,
                   float* __restrict__ out, int m, int n, int k, int kp) {
  __shared__ float xs[kFBK][kFBM + 4];  // transposed: [k][row]
  __shared__ float ws[kFBK][kFBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kp; k0 += kFBK) {
    for (int c = tid; c < kFBM * kFBK / 4; c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < m && k0 + col < k)
        v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * k + k0 + col);
      xs[col][r] = v.x;
      xs[col + 1][r] = v.y;
      xs[col + 2][r] = v.z;
      xs[col + 3][r] = v.w;
    }
    if (tid < kFBN * kFBK / 16) {
      const int r = tid >> 1, col = (tid & 1) * 16;
      const int row = n0 + r, kk = k0 + col;
      if (row < n && kk < kp) {
        const int4 raw = *reinterpret_cast<const int4*>(q + (size_t)row * kp + kk);
        const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
        const size_t gi = (size_t)row * (kp / G) + kk / G;
        const float s = scale[gi];
        const float z = Mode == kGroupZero ? zero[gi] : 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float w = __fmul_rn(static_cast<float>(v[i]), s);
          if (Mode == kGroupZero) w = __fsub_rn(w, z);
          ws[col + i][r] = w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) ws[col + i][r] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < m && col < n) out[(size_t)row * n + col] = acc[i][j];
    }
}

bool group_shape_ok(int m, int n, int k, int kp, int group) {
  return m > 0 && n > 0 && k > 0 && k % 8 == 0 && k <= kp && (group == 16 || group == 32) &&
         kp % group == 0;
}

template <int Mode, int Tiles = 1>
cudaError_t launch_group(int dtype, const void* x, const void* q, const void* scale,
                         const void* zero, void* out, int m, int n, int k, int kp, int group,
                         void* stream) {
  if (!group_shape_ok(m, n, k, kp, group)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  const float* zr = static_cast<const float*>(zero);
  if (dtype == kBF16) {
    auto kernel = group == 16 ? gq_gemm_kernel<Mode, 16, Tiles> : gq_gemm_kernel<Mode, 32, Tiles>;
    kernel<<<dim3(ceil_div(n, kBN), ceil_div(m, kBM * Tiles)), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), qi, sc, zr, static_cast<__nv_bfloat16*>(out), m,
        n, k, kp);
  } else if (dtype == kF32 && Tiles == 1) {
    auto kernel = group == 16 ? gq_gemm_f32_kernel<Mode, 16> : gq_gemm_f32_kernel<Mode, 32>;
    kernel<<<dim3(ceil_div(n, kFBN), ceil_div(m, kFBM)), kThreads, 0, s>>>(
        static_cast<const float*>(x), qi, sc, zr, static_cast<float*>(out), m, n, k, kp);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdtpu

// x [m, k] in `dtype` (bf16 or f32); q int8 [n, kp]; scale f32 [n, kp/group]
// -> out [m, n] in `dtype`.  Needs k % 8 == 0, k <= kp, group 16 or 32.
extern "C" int sdtpu_gq_matmul(int dtype, const void* x, const void* q, const void* scale,
                               void* out, int m, int n, int k, int kp, int group, void* stream) {
  using namespace sdtpu;
  return launch_group<kGroup>(dtype, x, q, scale, nullptr, out, m, n, k, kp, group, stream);
}

// As sdtpu_gq_matmul, with zero f32 [n, kp/group]: w = q * scale - zero.
extern "C" int sdtpu_gq_zero_matmul(int dtype, const void* x, const void* q, const void* scale,
                                    const void* zero, void* out, int m, int n, int k, int kp,
                                    int group, void* stream) {
  using namespace sdtpu;
  if (zero == nullptr) return cudaErrorInvalidValue;
  return launch_group<kGroupZero>(dtype, x, q, scale, zero, out, m, n, k, kp, group, stream);
}

// Weight-stationary form of sdtpu_gq_matmul; bf16 only.
extern "C" int sdtpu_gq_matmul_ws(int dtype, const void* x, const void* q, const void* scale,
                                  void* out, int m, int n, int k, int kp, int group,
                                  void* stream) {
  using namespace sdtpu;
  return launch_group<kGroup, kWsTiles>(dtype, x, q, scale, nullptr, out, m, n, k, kp, group,
                                        stream);
}

// W8A16: x bf16 [m, k]; q int8 [n, k]; scale f32 [n] -> out bf16 [m, n],
// out = (sum_k x * q) * scale[n].  Needs k % 16 == 0.
extern "C" int sdtpu_w8a16_matmul(const void* x, const void* q, const void* scale, void* out,
                                  int m, int n, int k, void* stream) {
  using namespace sdtpu;
  if (m <= 0 || n <= 0 || k <= 0 || k % 16) return cudaErrorInvalidValue;
  gq_gemm_kernel<kRowScale, 1, 1><<<dim3(ceil_div(n, kBN), ceil_div(m, kBM)), kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), nullptr, static_cast<__nv_bfloat16*>(out), m, n, k, k);
  return cudaGetLastError();
}
