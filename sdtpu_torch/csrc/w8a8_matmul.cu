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
// Few rows (M <= kW8a8GemvMaxM = 8: the DiT's modulation and embedder
// linears, M = 1, or 4 under CFG with a batch of two): `w8a8_gemv_kernel`,
// one launch that quantizes x itself.  Its bound is the int8 weight read
// once (0.0169 ms at 3072->18432).  A block owns 16 weight rows (the
// mma.sync M) and all of K, its warps contiguous runs of 64-byte segments;
// each lane streams 16 bytes of its rows g and g + 8 a segment into
// registers (`ld_stream`, a batch of segments ahead), and K is relabelled
// so that those bytes are its own s8 A fragment as they lie: per k32 step
// two 4-byte words of row g and two of row g + 8, no widening at all.  The
// B fragment is x row g, int8, at the same k: one 16-byte shared-memory read
// a segment.  The block's first batch of weight loads is issued before its
// prologue, which quantizes the M x rows into shared memory with
// `quantize_rows_kernel`'s arithmetic (amax, __fdiv_rn, rintf, clamp), so
// every block computes the same bytes and s_x and no int8 copy of x exists
// in device memory.  The int32 warp partials are summed in shared memory
// (exact in any order) and the epilogue is the GEMMs' (acc * s_x, then *
// s_w, each __fmul_rn): bit-equal to the plain version whatever the split.
// It is a kernel of its own beside common.cuh's `weight_gemv` (the 4-bit and
// group-dequant GEMVs), sharing its constants and helpers: W8A8 differs in
// every phase that template has (x from shared memory after an in-block
// prologue, int32 accumulators, a per-row s_x and the output type in the
// epilogue), and folding those in as policies would change the code the
// other two GEMVs were tuned with.
//
// M 9-127 (no request path sends such M; T5 and the DiT's text run 256
// rows), and M <= 8 with K > kW8a8GemvMaxK (x would not fit shared memory):
// `w8a8_gemm_kernel`, the first form: 128x64-byte tiles loaded
// synchronously into padded shared memory, mma.sync m16n8k32.  `w8a8_form`
// (exported as sdtpu_w8a8_form) names the form by shape alone.  Every form
// needs K a multiple of 16 (16-byte loads; TMA's 16-byte global strides).
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

// ------------------------------------------------------- M <= 8: GEMV

constexpr int kW8a8GemvMaxM = kGemvMaxM;  // calls with at most this many rows take the GEMV ...
constexpr int kW8a8GemvMaxK = 16384;      // ... if K is at most this: 8 x rows in 131 KB of shared
constexpr int kW8a8GemvWarps = 8;         // warps per block, splitting K
constexpr int kW8a8GemvUnroll = 2;        // segments a batch: a warp's loads run a batch ahead
// Eight warps of two-segment batches won on the card over the DiT's mix a
// step, 38 launches each at 1x3072->18432 and 1x3072->9216, on the device
// clock (sdtpu_torch/tools/time_dequant.py on trees differing in these two
// constants, in turns; NVIDIA H100 80GB HBM3, 700.00 W): 1.335 ms, against
// 1.425 for four warps of two (the group-dequant GEMV's choice), 1.442 for four of four
// and 1.460 for eight of four.  With no widening left the mainloop only
// streams, and eight warps also halve each thread's share of the prologue.

// Bytes between two quantized x rows in shared memory: K padded so that
// rows lie 64 bytes apart modulo 128.  A quarter-warp's 16-byte reads cover
// 64 bytes of each of two rows (g, g + 1), which then fall in disjoint banks.
__host__ __device__ __forceinline__ int gemv_x_stride(int k) { return k + (192 - k % 128) % 128; }

// A 16-byte load of x -> its 16 / sizeof(T) values in f32 (exact).
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}

// x [m, k] (bf16 or f32), wq int8 [n, k], sw f32 [n] -> out [m, n] in T;
// m <= 8, k % 16 == 0, m * gemv_x_stride(k) bytes of dynamic shared memory.
template <typename T, int Warps, int Unroll>
__global__ void __launch_bounds__(Warps * 32)
w8a8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ sw, T* __restrict__ out, int m, int n, int k) {
  constexpr int kThreads = Warps * 32;
  constexpr int kVec = 16 / sizeof(T);  // x values a 16-byte load
  static_assert(kThreads >= kGemvMaxM * kGemvRows, "w8a8 gemv: one thread per output");
  extern __shared__ __align__(16) int8_t xs[];  // [m][gemv_x_stride(k)], x quantized
  __shared__ int part[Warps][kGemvMaxM][kGemvRows];
  __shared__ float red[Warps][kGemvMaxM];
  __shared__ float sx[kGemvMaxM];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kGemvRows;
  const int stride = gemv_x_stride(k);
  const int segs = (k + kGemvSeg - 1) / kGemvSeg;
  // warp w owns segments [seg0, seg1): a contiguous run of each row
  const int per = (segs + Warps - 1) / Warps;
  const int seg0 = min(segs, warp * per), seg1 = min(segs, seg0 + per);
  // This lane's weight rows n0 + g and n0 + g + 8 (a row past N reads
  // nothing) and quantized x row g (a row past M gives zero B fragments):
  // 16 bytes at 16 tq of each segment.
  const bool live0 = n0 + g < n, live1 = n0 + g + 8 < n, xlive = g < m;
  const size_t row0 = live0 ? n0 + g : 0, row1 = live1 ? n0 + g + 8 : 0;
  const int8_t* wp0 = wq + row0 * k + 16 * tq;
  const int8_t* wp1 = wq + row1 * k + 16 * tq;
  const int8_t* xp = xs + (xlive ? g : 0) * stride + 16 * tq;
  const bool rows_full = n0 + kGemvRows <= n;

  // One batch: segments s .. s + Unroll - 1 of the warp's run, every load
  // issued before any is used.  `full`: every row lies inside N and every
  // segment inside K, so nothing is checked.  Otherwise a lane's 16 bytes
  // past K (K % 64 != 0: the last segment is partial; K % 16 == 0, so a
  // lane's bytes are all in or all out) or past N read as zero words.
  using Batch = uint4[Unroll][2];  // [segment][row g, g + 8]
  auto batch_full = [&](int s) {
    return rows_full && (s + Unroll) * kGemvSeg <= k && s + Unroll <= seg1;
  };
  auto load = [&](int s, Batch& wb, bool full) {
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      const int seg = s + u;
      const bool in = full || (seg < seg1 && seg * kGemvSeg + 16 * tq < k);
      wb[u][0] = full || (in && live0) ? ld_stream(wp0 + seg * kGemvSeg) : make_uint4(0, 0, 0, 0);
      wb[u][1] = full || (in && live1) ? ld_stream(wp1 + seg * kGemvSeg) : make_uint4(0, 0, 0, 0);
    }
  };
  Batch wv;
  bool full = batch_full(seg0);
  if (seg0 < seg1) {
    if (full) load(seg0, wv, true); else load(seg0, wv, false);
  }

  // Prologue, while those loads are in flight: s_x[r] = amax_k |x[r, k]| /
  // 127 (1 where amax is 0) and x / s_x rounded half to even, clamped to
  // +-127, into shared memory.  m is the same for the whole block, so the
  // shuffles below run in whole warps.
  const int chunks = k / kVec;
  float amax[kGemvMaxM];
#pragma unroll
  for (int r = 0; r < kGemvMaxM; ++r) amax[r] = 0.f;
  for (int c = tid; c < chunks; c += kThreads) {
#pragma unroll
    for (int r = 0; r < kGemvMaxM; ++r) {
      if (r >= m) break;
      float f[kVec];
      unpack16(__ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * k) + c), f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) amax[r] = fmaxf(amax[r], fabsf(f[i]));
    }
  }
#pragma unroll
  for (int r = 0; r < kGemvMaxM; ++r) {
    if (r >= m) break;
    float a = amax[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (lane == 0) red[warp][r] = a;
  }
  __syncthreads();
  if (tid < m) {
    float a = red[0][tid];
#pragma unroll
    for (int w = 1; w < Warps; ++w) a = fmaxf(a, red[w][tid]);
    sx[tid] = a == 0.f ? 1.f : __fdiv_rn(a, 127.f);
  }
  __syncthreads();
  for (int c = tid; c < chunks; c += kThreads) {
#pragma unroll
    for (int r = 0; r < kGemvMaxM; ++r) {
      if (r >= m) break;
      float f[kVec];
      unpack16(__ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * k) + c), f);
      const float s = sx[r];
      uint32_t q[kVec / 4];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float v = fminf(fmaxf(rintf(__fdiv_rn(f[i], s)), -127.f), 127.f);  // half to even
        const uint32_t b = static_cast<uint32_t>(static_cast<int>(v)) & 0xffu;
        q[i / 4] = i % 4 ? q[i / 4] | (b << (8 * (i % 4))) : b;
      }
      int8_t* dst = xs + r * stride + c * kVec;
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = q[0];
      }
    }
  }
  __syncthreads();

  // acc[c]: rows (g, g + 8) x x rows (2tq, 2tq + 1), the mma's C fragment;
  // two chains (the two k32 steps of a segment)
  int acc[2][4] = {};
  auto compute = [&](int s, const Batch& wb, bool full) {
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      const int seg = s + u;
      if (seg >= seg1) break;  // the same for the whole warp
      // the lane's 16 bytes hold k = 64 seg + 16 tq .. + 15; word j feeds
      // k32 step j / 2, in the fragment's slots 4tq.. (even j) or 4tq + 16..
      const uint4 xv = xlive && (full || seg * kGemvSeg + 16 * tq < k)
                           ? *reinterpret_cast<const uint4*>(xp + seg * kGemvSeg)
                           : make_uint4(0, 0, 0, 0);
      const uint32_t a0[4] = {wb[u][0].x, wb[u][1].x, wb[u][0].y, wb[u][1].y};
      const uint32_t b0[2] = {xv.x, xv.y};
      mma_s8_16832(acc[0], a0, b0);
      const uint32_t a1[4] = {wb[u][0].z, wb[u][1].z, wb[u][0].w, wb[u][1].w};
      const uint32_t b1[2] = {xv.z, xv.w};
      mma_s8_16832(acc[1], a1, b1);
    }
  };

  // Software pipeline: the next batch's loads are in flight while this one
  // is multiplied.
  for (int s = seg0; s < seg1; s += Unroll) {
    Batch cw;
#pragma unroll
    for (int u = 0; u < Unroll; ++u) cw[u][0] = wv[u][0], cw[u][1] = wv[u][1];
    const bool cfull = full;
    const int next = s + Unroll;
    if (next < seg1) {
      full = batch_full(next);
      if (full) load(next, wv, true); else load(next, wv, false);
    }
    if (cfull) compute(s, cw, true); else compute(s, cw, false);
  }

  part[warp][2 * tq][g] = acc[0][0] + acc[1][0];
  part[warp][2 * tq + 1][g] = acc[0][1] + acc[1][1];
  part[warp][2 * tq][g + 8] = acc[0][2] + acc[1][2];
  part[warp][2 * tq + 1][g + 8] = acc[0][3] + acc[1][3];
  __syncthreads();
  if (tid < kGemvMaxM * kGemvRows) {
    const int mm = tid / kGemvRows, r = tid % kGemvRows;
    if (mm < m && n0 + r < n) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < Warps; ++w) sum += part[w][mm][r];
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(sum), sx[mm]), sw[n0 + r]);
      out[static_cast<size_t>(mm) * n + n0 + r] = from_f32<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch_w8a8_gemv(const void* x, const int8_t* wq, const float* sw, void* out, int m,
                             int n, int k, cudaStream_t stream) {
  auto kernel = w8a8_gemv_kernel<T, kW8a8GemvWarps, kW8a8GemvUnroll>;
  const int smem = m * gemv_x_stride(k);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<ceil_div(n, kGemvRows), kW8a8GemvWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), wq, sw, static_cast<T*>(out), m, n, k);
  return cudaGetLastError();
}

// The form a call of m rows and K = k takes, by shape alone: 0 the GEMV, 1
// the mma.sync form, 2 the wgmma kernel.
int w8a8_form(int m, int k) {
  if (m <= kW8a8GemvMaxM && k <= kW8a8GemvMaxK) return 0;
  return m >= kWgmmaMinM ? 2 : 1;
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

// x [m, k] in `dtype` (bf16 or f32), wq int8 [n, k], sw f32 [n] -> out
// [m, n] in `dtype`.  k must be a multiple of 16 and the pointers 16-byte
// aligned.  The form is w8a8_form's: the GEMV quantizes x itself (xq and sx
// are not read and may be null); the other forms read xq int8 [m, k] and sx
// f32 [m], which sdtpu_w8a8_quantize_rows wrote from x.  A refused launch
// is returned, never retried in another form.
extern "C" int sdtpu_w8a8_matmul(int dtype, const void* x, const void* xq, const void* wq,
                                 const void* sx, const void* sw, void* out, int m, int n, int k,
                                 void* stream) {
  using namespace sdtpu;
  if (m <= 0 || n <= 0 || k <= 0 || k % 16) return cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* fx = static_cast<const float*>(sx);
  const float* fw = static_cast<const float*>(sw);
  const int form = w8a8_form(m, k);
  if (form == 0) {
    if (dtype == kBF16) return launch_w8a8_gemv<__nv_bfloat16>(x, b, fw, out, m, n, k, s);
    return launch_w8a8_gemv<float>(x, b, fw, out, m, n, k, s);
  }
  if (a == nullptr || fx == nullptr) return cudaErrorInvalidValue;
  if (form == 2) {
    if (dtype == kBF16)
      return launch_w8a8_wgmma(a, b, fx, fw, static_cast<__nv_bfloat16*>(out), m, n, k, s);
    return launch_w8a8_wgmma(a, b, fx, fw, static_cast<float*>(out), m, n, k, s);
  }
  dim3 grid(ceil_div(n, kBN), ceil_div(m, kBM));
  if (dtype == kBF16) {
    w8a8_gemm_kernel<<<grid, kThreads, 0, s>>>(a, b, fx, fw,
                                               static_cast<__nv_bfloat16*>(out), m, n, k);
  } else {
    w8a8_gemm_kernel<<<grid, kThreads, 0, s>>>(a, b, fx, fw, static_cast<float*>(out), m, n, k);
  }
  return cudaGetLastError();
}

// The form a call of m rows and K = k takes: 0 the GEMV, 1 the mma.sync
// form, 2 the wgmma kernel.
extern "C" long long sdtpu_w8a8_form(int m, int k) { return sdtpu::w8a8_form(m, k); }
