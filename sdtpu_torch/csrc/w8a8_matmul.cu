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
// M 9-127 (an int8 SDXL UNet at CFG 1: its 140 context projections a
// forward, attn2.to_k / to_v over CLIP's 77 tokens, at 77x2048->640 and
// ->1280), and M <= 8 with K > kW8a8GemvMaxK (x would not fit the GEMV's
// shared memory): `w8a8_splitk_kernel<TOut, XN>`, a split-K
// weight-streaming wgmma GEMM on common.cuh's split-K launch shape,
// split count and cluster reduction (`splitk_store`).  Its bound is the
// int8 weight's bytes (0.0009 ms at 77x2048->1280 at 3.35 TB/s; 0.0112 ms
// at 127x3072->12288), well under the ~6 us a split-K launch costs in
// fixed time (common.cuh), so its design is about launches and filling the
// card, not arithmetic.  Operands are swapped as in the 4-bit split-K form:
// a block owns 128 weight rows (the wgmma M, 64 per consumer warpgroup) and
// every x row in one tile of XN = 32, 64, 80 or 128 rows (the wgmma N, the
// first that holds M); a producer thread TMA-loads 128-byte K slices of the
// weight and of the quantized x (both int8, K-major, 128-byte swizzle)
// into a ring under full / empty mbarriers, and the consumers run
// wgmma.m64nXNk32.s32.s8.s8 with both operands from shared memory: no
// widening at all.  K is split across the 1-8 blocks of a cluster
// (`sdtpu_w8a8_splits`) and the int32 partials summed through distributed
// shared memory in split order; int32 sums are exact in any order, so the
// result is bit-equal to the plain version whatever the split.  The
// epilogue is the other forms' (acc * s_x, then * s_w, each __fmul_rn).
// On an NVIDIA H100 80GB HBM3 at 700 W (device clock, the quantize and the
// GEMM summed; chip_smoke.py, sdtpu_torch/tools/time_dequant.py): 0.0093 /
// 0.0097 ms at 77x2048->640 / ->1280 (8 splits; the mma.sync pair it
// replaced 0.046-0.048), 0.0224 at 127x3072->12288 (unsplit; 0.095-0.097),
// against torch._int_mm's 0.0063 / 0.0227 for the GEMM alone.
//
// The row quantize stays its own launch (`quantize_rows_kernel`, which
// every M > 8 call runs first), and the GEMM is launched as its
// programmatic dependent: quantize_rows_kernel lets it start at once
// (griddep_launch_dependents), its producer issues the weight loads of the
// first ring's worth of stages, waits for the quantize to complete
// (griddep_wait) and only then loads x, and the consumers wait the same
// before the epilogue reads s_x.  So the weight ring fills while x is
// quantized, and the second launch's latency overlaps the first's.  This
// was chosen over folding the quantize into the GEMM as the M <= 8 GEMV
// does: there every block holds all of x in shared memory, but here a
// block would have to exchange per-row amax partials of its K slice with
// its cluster (every row's scale needs all of K) and then quantize each
// bf16 x stage in shared memory between its TMA load and its wgmma, on the
// consumers' critical path, for every band of the weight alike; the
// dependent launch keeps the int8 mainloop free of that work and leaves x
// quantized once per call.
//
// `w8a8_form` (exported as sdtpu_w8a8_form) names the form by shape alone.
// Every form needs K a multiple of 16 (16-byte loads; TMA's 16-byte global
// strides).
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
  griddep_launch_dependents();  // a split-K GEMM after it may start loading its weight
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

// ------------------------------------------------------- 8 < M < 128: split K

constexpr int kS8BK = 128;  // K a stage: 128 int8 bytes of a weight row and of an x row

template <int XN>
struct S8SplitSmem {
  static constexpr int kXTile = XN * kS8BK;        // 128-byte swizzle: whole 1 KB atoms
  static constexpr int kWTile = kSplitBN * kS8BK;  // 16 KB
  static constexpr int kStage = kXTile + kWTile;
  static constexpr int kStages = kSplitRing / kStage < 12 ? kSplitRing / kStage : 12;
  static constexpr int kBytes = 1024 + kStages * kStage + 2 * kStages * 8;
  static_assert(kStages * kXTile >= XN * kSplitPRow * 4, "w8a8 split-K: the partial tile must fit the x ring");
  static_assert(kBytes <= 232448, "w8a8 split-K: shared memory over the 227 KB a block may use");
};

// acc += W_tile . xq_tile^T for one k32 step, wgmma N = XN
template <int XN>
__device__ __forceinline__ void s8_splitk_wgmma(int (&acc)[XN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (XN == 128) {
    wgmma_m64n128k32_s8(acc, desc_a, desc_b, 1);
  } else if constexpr (XN == 80) {
    wgmma_m64n80k32_s8(acc, desc_a, desc_b, 1);
  } else if constexpr (XN == 64) {
    wgmma_m64n64k32_s8(acc, desc_a, desc_b, 1);
  } else {
    wgmma_m64n32k32_s8(acc, desc_a, desc_b, 1);
  }
}

// out[0:m, n0:n0 + 128] of one block of the cluster: xmap the quantized x
// int8 [m, k] (box 128 x XN), wmap the weight int8 [n, k] (box 128 x 128),
// both 128-byte swizzle; sx f32 [m] (written by the launch before this
// one), sw f32 [n]; the grid is ceil(n / 128) clusters of `splits` blocks.
template <typename TOut, int XN>
__global__ void __launch_bounds__(kSplitThreads, 1)
w8a8_splitk_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   TOut* __restrict__ out, int m, int n, int k, int splits) {
  using S = S8SplitSmem<XN>;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(16) uint8_t s8_smem[];
  const uint32_t raw = smem_u32(s8_smem);
  const uint32_t x_base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t w_base = x_base + kStages * S::kXTile;
  const uint32_t bars = w_base + kStages * S::kWTile;
  uint8_t* smem = s8_smem - raw;  // generic pointer of shared address 0
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int rank = static_cast<int>(cluster_ctarank());
  const int n0 = (blockIdx.x / splits) * kSplitBN;
  const int ktiles = (k + kS8BK - 1) / kS8BK;
  const int per = (ktiles + splits - 1) / splits;
  const int kt0 = rank * per;
  const int nk = max(0, min(ktiles, kt0 + per) - kt0);  // this block's stages

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);   // the TMA arrival
      mbar_init(empty(s), 8);  // the consumers' eight warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread.  The weight of the first ring's worth of stages
    // is loaded before x exists; x only once the quantize launch is done.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int pre = min(nk, kStages);
      for (int i = 0; i < pre; ++i) {
        mbar_expect_tx(full(i), S::kXTile + S::kWTile);
        tma_load_2d(w_base + i * S::kWTile, &wmap, full(i), (kt0 + i) * kS8BK, n0);
      }
      griddep_wait();
      for (int i = 0; i < pre; ++i)
        tma_load_2d(x_base + i * S::kXTile, &xmap, full(i), (kt0 + i) * kS8BK, 0);
      for (int i = pre; i < nk; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), S::kXTile + S::kWTile);
        tma_load_2d(w_base + s * S::kWTile, &wmap, full(s), (kt0 + i) * kS8BK, n0);
        tma_load_2d(x_base + s * S::kXTile, &xmap, full(s), (kt0 + i) * kS8BK, 0);
      }
    }
    if (splits > 1) {
      cluster_sync();  // the cluster's partial tiles are written
      cluster_sync();  // and read
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;  // this thread's weight rows in the band: r0, r0 + 8
  const uint32_t a_rows = wg * 64 * kS8BK;  // this warpgroup's 64 rows of the weight tile

  // acc[4j + e]: weight row r0 (+8 for e >= 2), x row 8j + 2tq (+1 for odd e)
  int acc[XN / 2];
#pragma unroll
  for (int i = 0; i < XN / 2; ++i) acc[i] = 0;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    mbar_wait(full(s), (i / kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kS8BK / 32; ++kk)
      s8_splitk_wgmma<XN>(acc, smem_desc_sw128(w_base + s * S::kWTile + a_rows + kk * 32, 16, 1024),
                          smem_desc_sw128(x_base + s * S::kXTile + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_regs(acc);
    if (i > 0 && lane == 0) mbar_arrive(empty((i - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  griddep_wait();  // s_x is the quantize launch's
  splitk_store<XN>(acc, smem, x_base, out, m, n, n0, r0, tq, splits, [&](int mm, int nn, int v) {
    return __fmul_rn(__fmul_rn(__int2float_rn(v), sx[mm]), sw[nn]);
  });
}

template <int XN>
const void* w8a8_splitk_for(bool bf16) {
  return bf16 ? reinterpret_cast<const void*>(w8a8_splitk_kernel<__nv_bfloat16, XN>)
              : reinterpret_cast<const void*>(w8a8_splitk_kernel<float, XN>);
}

// The split count a call of m rows takes at n x k: a function of the shape
// (and the card) alone (both output types' kernels share their shared
// memory and threads).
int w8a8_splits(int m, int n, int k) {
  return with_splitk_cols(m, [&](auto xn) {
    constexpr int XN = decltype(xn)::value;
    return splitk_splits_for<S8SplitSmem<XN>>(w8a8_splitk_for<XN>(true), n, ceil_div(k, kS8BK));
  });
}

template <int XN>
cudaError_t launch_w8a8_splitk_cols(bool bf16, const int8_t* xq, const int8_t* wq, const float* sx,
                                    const float* sw, void* out, int m, int n, int k, int splits,
                                    cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t xbox[2] = {kS8BK, XN}, wbox[2] = {kS8BK, kSplitBN};
  cudaError_t err = make_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, xdims, strides, xbox);
  if (err != cudaSuccess) return err;
  err = make_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, wdims, strides, wbox);
  if (err != cudaSuccess) return err;
  void* args[] = {&xmap, &wmap, &sx, &sw, &out, &m, &n, &k, &splits};
  return launch_splitk_grid(w8a8_splitk_for<XN>(bf16), S8SplitSmem<XN>::kBytes, n, splits, true,
                            args, stream);
}

cudaError_t launch_w8a8_splitk(bool bf16, const int8_t* xq, const int8_t* wq, const float* sx,
                               const float* sw, void* out, int m, int n, int k, cudaStream_t stream) {
  const int splits = w8a8_splits(m, n, k);
  return with_splitk_cols(m, [&](auto xn) {
    return launch_w8a8_splitk_cols<decltype(xn)::value>(bf16, xq, wq, sx, sw, out, m, n, k, splits,
                                                         stream);
  });
}

// The form a call of m rows and K = k takes, by shape alone: 0 the GEMV, 1
// the split-K form, 2 the wgmma kernel.
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
// f32 [m], which sdtpu_w8a8_quantize_rows wrote from x (the split-K form
// starts as that launch's programmatic dependent and waits for it before
// it reads them).  A refused launch is returned, never retried in another
// form.
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
  return launch_w8a8_splitk(dtype == kBF16, a, b, fx, fw, out, m, n, k, s);
}

// The form a call of m rows and K = k takes: 0 the GEMV, 1 the split-K
// form, 2 the wgmma kernel.
extern "C" long long sdtpu_w8a8_form(int m, int k) { return sdtpu::w8a8_form(m, k); }

// The splits of K the split-K form takes at m x k -> n (1 to 8, the blocks
// of a cluster; 0 where another form runs).
extern "C" long long sdtpu_w8a8_splits(int m, int n, int k) {
  using namespace sdtpu;
  return n > 0 && k > 0 && w8a8_form(m, k) == 1 ? w8a8_splits(m, n, k) : 0;
}
