// W8A8 int8 matmul for Hopper:
//   out[m, n] = cast((float(sum_k xq[m, k] * wq[n, k]) * sx[m]) * sw[n])
//
// Replaces the TPU kernel `_w8a8_matmul_kernel` (sdtpu/ops/quant.py:416) and
// the XLA int8 dot the TPU path takes by default (quant.py:518-521).
// `quantize_rows` computes the dynamic per-token activation scale (amax /
// 127, 1 where amax is 0) and rounds x / s half-to-even into int8, exactly as
// `quantize_activations` (quant.py:406) does; the GEMM accumulates int8 x
// int8 in int32 on the tensor cores and applies the f32 epilogue in the TPU
// order, acc * s_x first and then * s_w.  Int32 sums are exact in any order,
// so the result is bit-equal to an exact reference.
//
// What bounds it on the card: at FLUX's large-M calls (M = 1280 or 4352,
// K and N in the thousands) the product is compute bound (2 ops per weight
// byte per row; 329 GOP against 1,979 TOP/s at 4352x3072->12288); at M = 1
// (the modulation linears) it is bound by reading the int8 weight once.
//
// Large M (M >= kWgmmaMinM): `w8a8_wgmma_kernel`.  A block owns a 128x256
// output tile: one producer warp TMA-loads 128-byte K slices of xq [M, K]
// and wq [N, K] (both K-major, as int8 wgmma requires) into a ring of four
// 48 KB shared-memory stages under full/empty mbarriers, 128-byte swizzle;
// two consumer warpgroups each run wgmma.m64n256k32.s32.s8.s8 on their 64
// rows, int32 accumulators in registers (128 a thread, registers handed
// over from the producer with setmaxnreg), one k-slice of wgmma left in
// flight while the next stage is awaited.  Edge tiles come from TMA's zero
// fill: no padding copies.
//
// Small M (M < kWgmmaMinM: modulation at M = 1, a few text tokens):
// `w8a8_gemm_kernel`, the first form: 128x64-byte tiles loaded
// synchronously into padded shared memory, mma.sync m16n8k32.  A skinny-M
// kernel (split K, weight streaming) is later work.  Either way K must be a
// multiple of 16 (16-byte loads; TMA's 16-byte global strides).
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

// ------------------------------------------------------- large M: wgmma

constexpr int kWgmmaMinM = 128;
constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 128;  // output tile; K bytes per stage
constexpr int kWgStages = 4;
constexpr int kWgThreads = 384;  // warpgroups 0-1: consumers (64 rows each); 2: producer
constexpr int kATile = kWgBM * kWgBK;  // 16 KB
constexpr int kBTile = kWgBN * kWgBK;  // 32 KB
constexpr int kConsumerWarps = 8;
constexpr int kWgSmem = 1024 + kWgStages * (kATile + kBTile) + 2 * kWgStages * 8;
// Blocks run in groups of kGroupM M tiles, N tile by N tile, so the blocks
// in flight share a few A row tiles and a narrow band of weight columns in
// the 50 MB L2 (FLUX's 3072->21504 weight alone is 66 MB).
constexpr int kGroupM = 8;

// Two neighbouring outputs in one store (p aligned to the pair).
template <typename TOut>
__device__ __forceinline__ void store_pair(TOut* p, float a, float b) {
  if constexpr (sizeof(TOut) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

template <typename TOut>
__global__ void __launch_bounds__(kWgThreads, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  TOut* __restrict__ out, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t a_base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t b_base = a_base + kWgStages * kATile;
  const uint32_t bars = b_base + kWgStages * kBTile;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWgStages + s); };

  const int wg = threadIdx.x >> 7;
  const int num_n = (n + kWgBN - 1) / kWgBN, num_m = (m + kWgBM - 1) / kWgBM;
  const int per_group = kGroupM * num_n;
  const int first_m = (blockIdx.x / per_group) * kGroupM;
  const int rows = min(num_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % rows) * kWgBM, n0 = (in_group / rows) * kWgBN;
  const int ktiles = (k + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kWgStages;
        mbar_wait(empty(s), ((kt / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kATile + kBTile);
        tma_load_2d(a_base + s * kATile, &xmap, full(s), kt * kWgBK, m0);
        tma_load_2d(b_base + s * kBTile, &wmap, full(s), kt * kWgBK, n0);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    const uint32_t a_rows = wg * 64 * kWgBK;  // this warpgroup's 64 rows of the A tile
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kWgStages;
      mbar_wait(full(s), (kt / kWgStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 32; ++kk) {
        const uint64_t da = smem_desc_sw128(a_base + s * kATile + a_rows + kk * 32, 16, 1024);
        const uint64_t db = smem_desc_sw128(b_base + s * kBTile + kk * 32, 16, 1024);
        wgmma_m64n256k32_s8(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-slice's products are done: free its stage
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: acc[4j + e] is row g (+8 for e >= 2), column 8j + 2t (+1 for odd e)
    const int g = lane >> 2, t = lane & 3;
    const int row0 = m0 + wg * 64 + warp * 16 + g;
    const bool pairs = (n % 2) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      const float sxr = sx[row];
      TOut* orow = out + static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < kWgBN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        if (col >= n) continue;
        const bool both = col + 1 < n;
        const float r0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sxr), sw[col]);
        const float r1 = both ? __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sxr),
                                          sw[col + 1])
                              : 0.f;
        if (pairs) {  // n even: col + 1 < n and the pair is aligned
          store_pair(orow + col, r0, r1);
        } else {
          orow[col] = from_f32<TOut>(r0);
          if (both) orow[col + 1] = from_f32<TOut>(r1);
        }
      }
    }
  }
}

template <typename TOut>
cudaError_t launch_w8a8_wgmma(const int8_t* xq, const int8_t* wq, const float* sx, const float* sw,
                              TOut* out, int m, int n, int k, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t xbox[2] = {kWgBK, kWgBM}, wbox[2] = {kWgBK, kWgBN};
  cudaError_t err = make_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, xdims, strides, xbox);
  if (err != cudaSuccess) return err;
  err = make_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, wdims, strides, wbox);
  if (err != cudaSuccess) return err;
  auto kernel = w8a8_wgmma_kernel<TOut>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return err;
  const int blocks = ceil_div(n, kWgBN) * ceil_div(m, kWgBM);
  kernel<<<blocks, kWgThreads, kWgSmem, stream>>>(xmap, wmap, sx, sw, out, m, n, k);
  return cudaGetLastError();
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
// M >= kWgmmaMinM takes the wgmma kernel, smaller M the mma.sync one.
extern "C" int sdtpu_w8a8_matmul(int out_dtype, const void* xq, const void* wq,
                                 const void* sx, const void* sw, void* out, int m,
                                 int n, int k, void* stream) {
  using namespace sdtpu;
  if (m <= 0 || n <= 0 || k <= 0 || k % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* fx = static_cast<const float*>(sx);
  const float* fw = static_cast<const float*>(sw);
  if (out_dtype != kBF16 && out_dtype != kF32) return cudaErrorInvalidValue;
  if (m >= kWgmmaMinM) {
    if (out_dtype == kBF16)
      return launch_w8a8_wgmma(a, b, fx, fw, static_cast<__nv_bfloat16*>(out), m, n, k, s);
    return launch_w8a8_wgmma(a, b, fx, fw, static_cast<float*>(out), m, n, k, s);
  }
  dim3 grid(ceil_div(n, kBN), ceil_div(m, kBM));
  if (out_dtype == kBF16) {
    w8a8_gemm_kernel<<<grid, kThreads, 0, s>>>(a, b, fx, fw,
                                               static_cast<__nv_bfloat16*>(out), m, n, k);
  } else {
    w8a8_gemm_kernel<<<grid, kThreads, 0, s>>>(a, b, fx, fw, static_cast<float*>(out), m, n, k);
  }
  return cudaGetLastError();
}
