// Shared helpers for the port's hand-written Hopper kernels.
//
// The kernels are compiled by nvcc into one shared library with a plain C
// interface (see sdtpu_torch/ops/_build.py).  Every entry point launches on
// the caller's stream, allocates nothing, and returns the cudaError_t of the
// launch so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace sdtpu {

// Element types the C entry points accept, as an int code.
enum DType : int { kBF16 = 0, kF32 = 1 };

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> packed bf16x2 (round to nearest even); `lo` lands in the low
// 16 bits, which is the first element of an mma operand pair.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col).
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D(16x8, s32) += A(16x32, s8, row) * B(32x8, s8, col).
__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D(16x8, f32) += A(16x8, tf32, row) * B(8x8, tf32, col).  A: a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B: b0 (k t, n g), b1
// (k t + 4, n g); C as mma_bf16_16816's (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32_1688(float c[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small + r: big = x rounded to a tf32 (10 explicit mantissa bits,
// to nearest), small = the exact rest x - big rounded to a tf32, |r| <=
// 2^-22 |x|.  The 3xTF32 product below keeps float32's accuracy on the
// tensor cores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(big));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// A.B in 3xTF32: big += Ab.Bb, small += As.Bb + Ab.Bs, float32 sums; the
// dropped As.Bs and the splits' rests are ~2^-21 of each product.  The
// tensor cores' adds truncate, so an MMA chain's error grows with its length
// and its accumulator's size: the cross terms, 2^-11 of the big ones, keep
// an accumulator of their own, and the caller adds the two (big + small)
// with an IEEE add.
__device__ __forceinline__ void mma_3xtf32(float big[4], float small[4], const uint32_t ab[4],
                                           const uint32_t as[4], const uint32_t bb[2],
                                           const uint32_t bs[2]) {
  mma_tf32_1688(small, as, bb);
  mma_tf32_1688(small, ab, bs);
  mma_tf32_1688(big, ab, bb);
}

// cp.async of 16 bytes into shared `dst` (zeros when `valid` is false: the
// source is not read), grouped by commit and waited on by group.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of a weight that is read once (the GEMVs' stream): through the
// non-coherent path, cached in L2 only.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------------------
// Weight-streaming GEMV for few rows of x (M <= kGemvMaxM = 8: the DiT's
// modulation and embedder linears, whose M is the batch, doubled under
// CFG): out[m, n] = sum_k x[m, k] * w[n, k], w a quantized weight read once.
// Its bound is the weight's bytes, so its job is to keep enough 16-byte
// loads in flight while the widening overlaps them.  The 4-bit form
// (q4_matmul.cu) and the int8 forms (gq_matmul.cu) differ only in the
// widening policy W and in their warp count and batch depth.
//
// A block owns 16 weight rows (the mma.sync M) and all of K; each of its
// warps takes a contiguous run of 64-byte row segments.  Each lane loads 16
// bytes of its rows g and g + 8 per segment straight into registers
// (ld.global.nc, not kept in L1; no shared memory, no TMA), Unroll segments
// a batch, and issues the next batch's loads before it widens the current
// one.  The mma's K is relabelled so that a lane's own bytes are its own A
// fragment: each 4-byte word j of its 16 feeds W::kKPerByte k16 steps, and
// its B fragment is the x values at the same k, 8 bytes of x row g a step
// (x rows are the mma's N = 8; rows past M are zero).  A dot product does not
// care which physical k a fragment slot holds as long as A and B agree, so
// no shuffle and no shared memory is needed.  x is read through L1, where it
// stays (at most 8 x 15360 bf16).  Each warp's 16 x 8 f32 partial goes to
// shared memory and one pass sums the warps in warp order: deterministic, no
// workspace, no atomics, one launch.
//
// The policy W gives:
//   kKPerByte      weights a byte (2: packed nibbles, 1: int8);
//   kGroupScale    a f32 scale a row and group of G weights, passed to widen;
//   kSumScale      a f32 scale a row, multiplying the f32 sum (G unused);
//   kZeroWord      a word whose weights are all zero (rows past N, bytes past
//                  the row's end; their scale is 0 as well);
//   widen(w, s, r) one word (4 kKPerByte weights) -> 2 kKPerByte bf16x2
//                  registers, r[i] holding the word's weights 2i and 2i + 1.
constexpr int kGemvMaxM = 8;   // x rows: the mma's N
constexpr int kGemvRows = 16;  // weight rows per block: the mma's M
constexpr int kGemvSeg = 64;   // bytes of a weight row per segment: 16 a lane

// out[m, n0 + r] for the block's 16 weight rows and all M <= 8 x rows.  w is
// [n, kp / kKPerByte] bytes; scale [n, kp / G] (kGroupScale) or [n]
// (kSumScale); x [m, k] with k <= kp and k % 8 == 0.
template <class W, int G, int Warps, int Unroll>
__device__ __forceinline__ void weight_gemv(const __nv_bfloat16* __restrict__ x,
                                            const uint8_t* __restrict__ w,
                                            const float* __restrict__ scale,
                                            __nv_bfloat16* __restrict__ out, int m, int n, int k,
                                            int kp) {
  static_assert(Warps * 32 >= kGemvMaxM * kGemvRows, "gemv: one thread per output");
  constexpr int kKB = W::kKPerByte;
  constexpr int kSegK = kGemvSeg * kKB;  // k per segment
  constexpr int kLaneK = 16 * kKB;       // k per lane and segment
  // scales a lane needs per row and segment (its k lie in one group unless
  // the group is smaller than its k), and a row's scales per segment
  constexpr int kLaneScales = !W::kGroupScale ? 0 : kLaneK > G ? kLaneK / G : 1;
  constexpr int kSegScales = W::kGroupScale ? kSegK / G : 0;
  __shared__ float part[Warps][kGemvMaxM][kGemvRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kGemvRows;
  const int row_bytes = kp / kKB;
  const int segs = (row_bytes + kGemvSeg - 1) / kGemvSeg;
  // warp w owns segments [seg0, seg1): a contiguous run of each row
  const int per = (segs + Warps - 1) / Warps;
  const int seg0 = min(segs, warp * per), seg1 = min(segs, seg0 + per);
  // This lane's weight rows n0 + g and n0 + g + 8 (a row past N reads
  // nothing) and x row g (a row past M gives zero B fragments), at the
  // warp's first segment: 16 bytes at 16 tq, k from kLaneK tq.
  const bool live0 = n0 + g < n, live1 = n0 + g + 8 < n, xlive = g < m;
  const size_t row0 = live0 ? n0 + g : 0, row1 = live1 ? n0 + g + 8 : 0;
  const int kl = seg0 * kSegK + kLaneK * tq;
  const uint8_t* wp0 = w + row0 * row_bytes + seg0 * kGemvSeg + 16 * tq;
  const uint8_t* wp1 = w + row1 * row_bytes + seg0 * kGemvSeg + 16 * tq;
  const float* sp0 = scale + (W::kGroupScale ? row0 * (kp / G) + kl / G : 0);
  const float* sp1 = scale + (W::kGroupScale ? row1 * (kp / G) + kl / G : 0);
  const __nv_bfloat16* xp = x + (xlive ? g : 0) * static_cast<size_t>(k) + kl;
  const bool rows_full = n0 + kGemvRows <= n;

  // One batch: segments s .. s + Unroll - 1 of the warp's run, every load
  // issued before any is used.  `full`: every row lies inside N and every x
  // inside K, so nothing is checked.  Otherwise a lane's 16 bytes past the
  // row's end (the last segment of a row whose length is not a multiple of
  // 64 bytes) or past N are kZeroWord with scale 0, exactly zero, and x past
  // K or M is zero.
  constexpr int kScaleSlots = kLaneScales > 0 ? kLaneScales : 1;
  using Batch = uint4[Unroll][2];                // [segment][row g, g + 8]
  using Scales = float[Unroll][2][kScaleSlots];  // [segment][row][group]
  auto batch_full = [&](int s) {
    return rows_full && (s + Unroll) * kSegK <= k && s + Unroll <= seg1;
  };
  auto load = [&](int s, Batch& wb, Scales& sb, bool full) {
    const int d = s - seg0;
    const uint4 zero = make_uint4(W::kZeroWord, W::kZeroWord, W::kZeroWord, W::kZeroWord);
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      const int seg = s + u;
      const bool in = full || (seg < seg1 && seg * kGemvSeg + 16 * tq < row_bytes);
      const bool in0 = full || (in && live0), in1 = full || (in && live1);
      wb[u][0] = in0 ? ld_stream(wp0 + (d + u) * kGemvSeg) : zero;
      wb[u][1] = in1 ? ld_stream(wp1 + (d + u) * kGemvSeg) : zero;
#pragma unroll
      for (int i = 0; i < kLaneScales; ++i) {
        sb[u][0][i] = in0 ? __ldg(sp0 + (d + u) * kSegScales + i) : 0.f;
        sb[u][1][i] = in1 ? __ldg(sp1 + (d + u) * kSegScales + i) : 0.f;
      }
    }
  };

  // acc[c]: rows (g, g + 8) x x rows (2tq, 2tq + 1), the mma's C fragment;
  // two chains (even and odd k16 steps), summed at the end
  float acc[2][4] = {};
  auto compute = [&](int s, const Batch& wb, const Scales& sb, bool full) {
    const int d = s - seg0;
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      if (s + u >= seg1) break;  // the same for the whole warp
      // the lane's 16 bytes hold k = kx .. kx + kLaneK - 1
      const int kx = (s + u) * kSegK + kLaneK * tq;
      const __nv_bfloat16* xu = xp + (d + u) * kSegK;
      uint32_t xw[kLaneK / 2];  // x at those k, bf16x2
#pragma unroll
      for (int j = 0; j < kLaneK / 8; ++j) {
        const uint4 v = xlive && (full || kx + 8 * j < k)
                            ? __ldg(reinterpret_cast<const uint4*>(xu + 8 * j))
                            : make_uint4(0, 0, 0, 0);
        xw[4 * j] = v.x, xw[4 * j + 1] = v.y, xw[4 * j + 2] = v.z, xw[4 * j + 3] = v.w;
      }
      const uint32_t w0[4] = {wb[u][0].x, wb[u][0].y, wb[u][0].z, wb[u][0].w};
      const uint32_t w1[4] = {wb[u][1].x, wb[u][1].y, wb[u][1].z, wb[u][1].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // word j: k = kx + 4 kKB j ..; k16 step t takes its weights 4t .. 4t
        // + 3, (4t, 4t + 1) in the fragment's slots 2tq.., (4t + 2, 4t + 3)
        // in slots 2tq + 8..
        const int si = j * kLaneScales / 4;
        uint32_t a0[2 * kKB], a1[2 * kKB];
        W::widen(w0[j], W::kGroupScale ? sb[u][0][si] : 1.f, a0);
        W::widen(w1[j], W::kGroupScale ? sb[u][1][si] : 1.f, a1);
#pragma unroll
        for (int t = 0; t < kKB; ++t) {
          const uint32_t a[4] = {a0[2 * t], a1[2 * t], a0[2 * t + 1], a1[2 * t + 1]};
          const uint32_t b[2] = {xw[2 * (j * kKB + t)], xw[2 * (j * kKB + t) + 1]};
          mma_bf16_16816(acc[(j * kKB + t) & 1], a, b);
        }
      }
    }
  };

  // Software pipeline: the next batch's loads are in flight while this one
  // is widened.
  Batch wv;
  Scales sc;
  bool full = batch_full(seg0);
  if (seg0 < seg1) load(seg0, wv, sc, full);
  for (int s = seg0; s < seg1; s += Unroll) {
    Batch cw;
    Scales csc;
#pragma unroll
    for (int u = 0; u < Unroll; ++u)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cw[u][r] = wv[u][r];
#pragma unroll
        for (int i = 0; i < kLaneScales; ++i) csc[u][r][i] = sc[u][r][i];
      }
    const bool cfull = full;
    const int next = s + Unroll;
    if (next < seg1) {
      full = batch_full(next);
      if (full) load(next, wv, sc, true); else load(next, wv, sc, false);
    }
    if (cfull) compute(s, cw, csc, true); else compute(s, cw, csc, false);
  }

  part[warp][2 * tq][g] = acc[0][0] + acc[1][0];
  part[warp][2 * tq + 1][g] = acc[0][1] + acc[1][1];
  part[warp][2 * tq][g + 8] = acc[0][2] + acc[1][2];
  part[warp][2 * tq + 1][g + 8] = acc[0][3] + acc[1][3];
  __syncthreads();
  if (threadIdx.x < kGemvMaxM * kGemvRows) {
    const int mm = threadIdx.x / kGemvRows, r = threadIdx.x % kGemvRows;
    if (mm < m && n0 + r < n) {
      float sum = 0.f;
#pragma unroll
      for (int wp = 0; wp < Warps; ++wp) sum += part[wp][mm][r];
      if constexpr (W::kSumScale) sum = __fmul_rn(sum, scale[n0 + r]);
      out[static_cast<size_t>(mm) * n + n0 + r] = __float2bfloat16_rn(sum);
    }
  }
}

// ------------------------------------------------------------------------
// Hopper (sm_90a): mbarrier, TMA and wgmma as inline PTX.
//
// The redesigned kernels share one skeleton: a producer warp TMA-loads tiles
// into a ring of shared-memory stages, each stage guarded by a "full"
// mbarrier (TMA completes its byte count) and an "empty" one (the consumer
// warps arrive when their wgmma reads are done); consumer warpgroups run
// wgmma on the stages that have arrived.  Tiles are written by TMA with the
// 128-byte swizzle, in boxes whose inner extent is 128 bytes, and read by
// wgmma through descriptors of the same swizzle.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` of TMA traffic on the barrier's phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once (a free stage).  A
// wait that lasts ~2^34 cycles (about 10 s) traps: a barrier that never
// completes becomes a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// cp.async of 4 bytes (zeros when `valid` is false), and an arrival on `bar`
// once all of this thread's earlier cp.async copies have landed.  The
// barrier's expected count includes one such arrival per copying thread.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// The same for N = 4, 8 or 16 bytes (source and destination N-byte aligned).
template <int N>
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
               "r"(valid ? N : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Arrive on named barrier `id` without waiting: the `threads` it counts are
// this warp's arrivals plus the waiting warps' named_bar_sync.
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Thread-block clusters: this block's rank in its cluster; a barrier over
// every thread of the cluster (shared-memory writes before it are visible to
// the cluster's reads after it); a shared address of this block mapped to
// the same offset in block `rank` of the cluster; a 16-byte load from such
// an address (distributed shared memory).
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();  // .aligned: the whole warp, converged
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");  // release
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");    // acquire
}
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// launch before it on the stream still runs, once every block of that launch
// has called griddep_launch_dependents (or exited); griddep_wait then blocks
// until that launch has completed and its writes are visible.  Both are
// no-ops where no such launch is involved.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// 2^x on the special-function unit (MUFU.EX2: 16 a clock per SM), inputs
// below -126 flushed to 0.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// TMA: the box of `map` at coordinates (c0 innermost, ...) → shared `dst`,
// its bytes counted on `bar`.  Out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Register hand-over between warpgroups (the producer gives, consumers take).
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers in program order around asynchronous wgmma:
// the compiler may not move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// Also for register-A fragments: keeps them live (and unmoved) until the
// wgmma that reads them is known to be complete.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(r[i]);
}

// wgmma shared-memory matrix descriptor for a tile TMA wrote with the
// 128-byte swizzle (tile base 1024-byte aligned).  K-major operands: rows of
// 128 bytes, 8-row groups `sbo` = 1024 bytes apart, `lbo` unused; a step of
// 32 bytes along K adds 32 to `addr`.  MN-major operands (the transposed B):
// `lbo` is the distance between 64-element column blocks along N, `sbo`
// between 8-row groups along K.
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The wgmma forms the kernels use.  SS: A and B from shared memory
// (descriptors); RS: A from registers (the mma.sync m16n8k16 A layout per
// warp), B from shared memory, read MN-major for TransB = 1 (flash's V) and
// K-major for TransB = 0 (the dequantizing GEMMs' activation tile).
// scale_d = 0 overwrites the accumulator, 1 adds to it.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 " "}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// m64nNk32 int8 x int8 -> int32, both operands K-major from shared memory,
// at W8A8's split-K x tiles (N = 32, 64, 80, 128; the s8 shapes take N =
// 8, 16, 24 and the multiples of 16 from 32 to 256).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 " "}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n80k32_s8(int (&d)[40], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 " "}, "
      "%40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 " "}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 " "}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_bf16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 " "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 " "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 " "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// m64n40k16 with A from registers (the D 40 flash kernel's P V over the 40
// head-dim columns of a V tile laid out in 64-column swizzle rows).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n40k16_bf16_rs(float (&d)[20], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19 " "}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// m64n32k16, both operands K-major in shared memory (the D = 512 flash
// kernel's partial scores).
__device__ __forceinline__ void wgmma_m64n32k16_bf16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 " "}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// m64n256k16 with A from registers (TransB as above).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n256k16_bf16_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 " "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// m64n64k16, both operands K-major in shared memory (the D 160 flash
// kernel's 64-key score tiles).
__device__ __forceinline__ void wgmma_m64n64k16_bf16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 " "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// m64n192k16 with A from registers (TransB as above; the D 160 flash
// kernel's P V over its 192 padded head-dim columns).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n192k16_bf16_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 " "}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// m64n80k16 and m64n32k16 with A from registers (TransB as above; the 4-bit
// split-K kernel's 80- and 32-row x tiles).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n80k16_bf16_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 " "}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n32k16_bf16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 " "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// ------------------------------------------------------------------------
// float32 activations against a quantized weight: out[m, n] = sum_k x[m, k]
// * w[n, k] in float32 on the TF32 tensor cores, the form every M takes when
// x is float32 (the group-dequant, affine and W8A16 matmuls in gq_matmul.cu,
// the 4-bit one in q4_matmul.cu), the widening a policy W.
//
// Its bound is 2*M*N*K operations at 495 TFLOP/s, the TF32 tensor-core peak
// (NVIDIA H100 SXM data sheet, 700 W; float32 outside the tensor cores runs
// at 67 TFLOP/s, which this form beats) at large M and the weight's bytes at
// M <= 8.  One TF32 pass keeps about three decimal digits, short of float32;
// but every weight is a small integer times a float32 scale, and the integer
// (nibble - 8, or q) is exact in tf32.  So only x is split, x = big + small +
// r with big and small tf32 and |r| <= 2^-23 |x| (split_tf32), and each K
// step runs two products, acc += Xb.W and acc += Xs.W, on mma.sync m16n8k8:
// the form's own floor, the split-x floor, is twice the bound.  The scales
// stay outside the products: each chain of kF32QChain 16-k blocks (at most
// one scale group, G = 16, 32 or 64 along K) sums into fresh accumulators,
// folded into the float32 master by fmaf(s[n, g], acc, master) (the affine
// mode then subtracts z[n, g] times the chain's sum of x, so w = q*s - z is
// never formed); the W8A16 policy (one row scale) adds them to the master
// with an IEEE add and multiplies by scale[n] in the epilogue.  The tensor
// cores' adds truncate, so a chain holds at most 16 MMAs while K runs to
// 15360.  On an H100 this form lies 6-8 times closer to a float64 answer
// than the plain version's float32 cuBLAS product, whose own rounding is
// most of their difference (chip_smoke.py records both against float64); a
// chain of one 16-k block, folding four times as often, ran slower and
// further from it.
//
// A block owns BM x rows and kF32QBN = 128 weight rows; warp (wm, wn) a
// 16 MT x 8 NT patch: 32 x 64 at BM = 128, 32 x 32 at 64, 16 x 16 at 16.  A
// cp.async ring of kF32QStages stages brings x (float32, 64 k a stage), the
// weight's bytes and the stage's scales (and zeros).  The mma's K is
// relabelled so that one 16-byte load of an x row gives a lane two k8 steps
// and each lane widens its own weight bytes: in the 16-k block p, lane slot
// tq of step 2p holds k = 16p + 4tq, slot tq + 4 k + 1, and step 2p + 1 k + 2
// and k + 3, in A (x) and B (the weight) alike; a step's 8 k stay in one 16-k
// block, so in one group.  Each warp splits the x it loads: a block-wide
// split into two tf32 planes in shared memory (float32 flash's choice) ran
// 23-41 % slower here, its extra pass, barrier and plane traffic costing more
// than the warps' duplicated splits.  Shared rows are padded so that these
// loads meet no bank conflict: x rows 80 floats, weight rows W::kRowStride
// bytes.  What bounds it is the mma.sync rate: with the widening and the
// split taken out (wrong answers, timing only) the DiT's widths ran only
// 17-18 % faster (sdtpu_torch/tools/time_dequant.py on trees differing in
// these lines, NVIDIA H100 80GB HBM3, 700.00 W); wgmma's TF32 rate is the
// next step.
//
// The policy W gives:
//   kKPerByte    weights a byte (2: packed nibbles, 1: int8);
//   kRowStride   bytes of a weight row in a stage (64 k, padded);
//   kG           K columns a scale group (the stage, 64, for a row scale);
//   kGroupScale  a f32 scale a row and group, scale[n, kp / kG];
//   kZero        an f32 zero beside each group scale (w = q*s - z);
//   kSumScale    a f32 scale a row, scale[n], multiplying the float32 sum;
//   fragment(row, p, tq, b)  the lane's four weights of the 16-k block p of
//                a stage row (k = 16p + 4tq ..), exact, as float bits.
constexpr int kF32QBN = 128, kF32QBK = 64, kF32QStages = 3;
constexpr int kF32QChain = 4;  // 16-k blocks a chain of fresh accumulators (at most a group)
constexpr int kF32QXS = kF32QBK + 16;  // x plane row stride, floats

// Warps along M and N, and each warp's m16 and n8 tiles, by the block's x rows.
template <int BM>
struct F32QCfg;
template <>
struct F32QCfg<16> {
  static constexpr int WM = 1, WN = 8, MT = 1, NT = 2;
};
template <>
struct F32QCfg<64> {
  static constexpr int WM = 2, WN = 4, MT = 2, NT = 4;
};
template <>
struct F32QCfg<128> {
  static constexpr int WM = 4, WN = 2, MT = 2, NT = 8;
};

// Shared memory, bytes: kStages x (x tile, weight tile, scales, zeros).
template <class W, int BM>
struct F32QSmem {
  using C = F32QCfg<BM>;
  static_assert(C::WM * C::MT * 16 == BM && C::WN * C::NT * 8 == kF32QBN, "f32q: warp layout");
  static constexpr int kThreads = 32 * C::WM * C::WN;
  static constexpr int kX = BM * kF32QXS * 4;
  static constexpr int kW = kF32QBN * W::kRowStride;
  static constexpr int kS = W::kGroupScale ? kF32QBN * (kF32QBK / W::kG) * 4 : 0;
  static constexpr int kZ = W::kZero ? kS : 0;
  static constexpr int kStage = kX + kW + kS + kZ;
  static constexpr int kBytes = kF32QStages * kStage;
  static_assert(kX % 16 == 0 && kW % 16 == 0 && kS % 16 == 0, "f32q: 16-byte aligned tiles");
  static_assert(kBytes <= 232448, "f32q: shared memory over the 227 KB a block may use");
};

// x [m, k] float32 with k % 4 == 0 and k <= kp; the weight's rows of kp /
// kKPerByte bytes (a multiple of 16); scales (and zeros) as the policy reads
// them; out [m, n] float32.  Grid: (N tiles, M tiles), dynamic shared memory
// F32QSmem<W, BM>::kBytes.
template <class W, int BM>
__device__ __forceinline__ void f32_quant_gemm(const float* __restrict__ x, const uint8_t* __restrict__ w,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ zero, float* __restrict__ out,
                                               int m, int n, int k, int kp) {
  using C = F32QCfg<BM>;
  using L = F32QSmem<W, BM>;
  constexpr int MT = C::MT, NT = C::NT, kThreads = L::kThreads;
  constexpr int G = W::kG, GPS = kF32QBK / G;  // groups a stage
  constexpr int PPC = kF32QChain < G / 16 ? kF32QChain : G / 16;  // 16-k blocks a chain
  constexpr int kRowBytes = kF32QBK / W::kKPerByte;          // weight bytes of a row a stage
  constexpr int XS = kF32QXS;
  extern __shared__ __align__(16) uint8_t f32q_smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kF32QBN;
  const int ktiles = (kp + kF32QBK - 1) / kF32QBK;
  const int row_bytes = kp / W::kKPerByte;
  const int groups = W::kGroupScale ? kp / G : 0;

  // stage kt into ring slot s: 16-byte copies of x and the weight, 4-byte
  // ones of the scales (a scale row need not be 16-byte aligned); zeros past
  // M, N, k and kp
  auto load = [&](int kt, int s) {
    uint8_t* st = f32q_smem + s * L::kStage;
    const int k0 = kt * kF32QBK;
    for (int c = tid; c < BM * (kF32QBK / 4); c += kThreads) {
      const int r = c / (kF32QBK / 4), col = (c % (kF32QBK / 4)) * 4;
      const bool ok = m0 + r < m && k0 + col < k;
      const size_t off = ok ? static_cast<size_t>(m0 + r) * k + k0 + col : 0;
      cp_async_16(smem_u32(st + (r * XS + col) * 4), x + off, ok);
    }
    constexpr int WC = kRowBytes / 16;
    for (int c = tid; c < kF32QBN * WC; c += kThreads) {
      const int r = c / WC, col = kt * kRowBytes + (c % WC) * 16;
      const bool ok = n0 + r < n && col < row_bytes;
      const size_t off = ok ? static_cast<size_t>(n0 + r) * row_bytes + col : 0;
      cp_async_16(smem_u32(st + L::kX + r * W::kRowStride + (c % WC) * 16), w + off, ok);
    }
    if constexpr (W::kGroupScale) {
      for (int c = tid; c < kF32QBN * GPS; c += kThreads) {
        const int r = c / GPS, gi = kt * GPS + c % GPS;
        const bool ok = n0 + r < n && gi < groups;
        const size_t off = ok ? static_cast<size_t>(n0 + r) * groups + gi : 0;
        cp_async_4(smem_u32(st + L::kX + L::kW + 4 * c), scale + off, ok);
        if constexpr (W::kZero) cp_async_4(smem_u32(st + L::kX + L::kW + L::kS + 4 * c), zero + off, ok);
      }
    }
  };

  // master[i][j][e]: x row 16 i + g (+8 for e >= 2), weight row 8 j + 2tq
  // (+1 for odd e) of the warp's patch, the mma's C fragment
  float master[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) master[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kF32QStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kF32QStages;
    cp_async_wait<kF32QStages - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with kt - 1
    if (kt + kF32QStages - 1 < ktiles) load(kt + kF32QStages - 1, (kt + kF32QStages - 1) % kF32QStages);
    cp_async_commit();
    uint8_t* st = f32q_smem + s * L::kStage;
    const float* xb = reinterpret_cast<const float*>(st);

    const uint8_t* wrow = st + L::kX + (wn * NT * 8 + g) * W::kRowStride;
    const float* sc = reinterpret_cast<const float*>(st + L::kX + L::kW);
    const float* zc = reinterpret_cast<const float*>(st + L::kX + L::kW + L::kS);
    const int xoff = (wm * MT * 16 + g) * XS + 4 * tq;
#pragma unroll
    for (int ch = 0; ch < 4 / PPC; ++ch) {
      const int gi = ch * PPC * 16 / G;  // the chain's scale group in the stage
      float acc[MT][NT][4];
      float xsum[MT][2];  // kZero: this lane's part of the chain's x sums, rows g and g + 8
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        xsum[i][0] = xsum[i][1] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
#pragma unroll
      for (int pp = 0; pp < PPC; ++pp) {
        const int p = ch * PPC + pp;
        uint32_t bw[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) W::fragment(wrow + 8 * j * W::kRowStride, p, tq, bw[j]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int o = xoff + 16 * i * XS + 16 * p;
          // x rows g and g + 8 at k = 16p + 4tq .. + 3, split into big (b) and
          // small (s) tf32 terms as they are loaded
          const float4 x0 = *reinterpret_cast<const float4*>(xb + o);
          const float4 x1 = *reinterpret_cast<const float4*>(xb + o + 8 * XS);
          uint4 b0, b1, s0, s1;
          split_tf32(x0.x, b0.x, s0.x);
          split_tf32(x0.y, b0.y, s0.y);
          split_tf32(x0.z, b0.z, s0.z);
          split_tf32(x0.w, b0.w, s0.w);
          split_tf32(x1.x, b1.x, s1.x);
          split_tf32(x1.y, b1.y, s1.y);
          split_tf32(x1.z, b1.z, s1.z);
          split_tf32(x1.w, b1.w, s1.w);
          if constexpr (W::kZero) {
            xsum[i][0] += (x0.x + x0.y) + (x0.z + x0.w);
            xsum[i][1] += (x1.x + x1.y) + (x1.z + x1.w);
          }
          const uint32_t ab0[4] = {b0.x, b1.x, b0.y, b1.y}, ab1[4] = {b0.z, b1.z, b0.w, b1.w};
          const uint32_t as0[4] = {s0.x, s1.x, s0.y, s1.y}, as1[4] = {s0.z, s1.z, s0.w, s1.w};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t w0[2] = {bw[j][0], bw[j][1]}, w1[2] = {bw[j][2], bw[j][3]};
            mma_tf32_1688(acc[i][j], ab0, w0);
            mma_tf32_1688(acc[i][j], as0, w0);
            mma_tf32_1688(acc[i][j], ab1, w1);
            mma_tf32_1688(acc[i][j], as1, w1);
          }
        }
      }
      // the chain's fold into the master
      if constexpr (W::kZero) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            xsum[i][h] += __shfl_xor_sync(0xffffffffu, xsum[i][h], 1);
            xsum[i][h] += __shfl_xor_sync(0xffffffffu, xsum[i][h], 2);
          }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = wn * NT * 8 + 8 * j + 2 * tq + c;
          const float s = W::kGroupScale ? sc[col * GPS + gi] : 1.f;
          const float z = W::kZero ? zc[col * GPS + gi] : 0.f;
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& mv = master[i][j][2 * h + c];
              if constexpr (W::kGroupScale) {
                mv = fmaf(s, acc[i][j][2 * h + c], mv);
                if constexpr (W::kZero) mv = fmaf(-z, xsum[i][h], mv);
              } else {
                mv = __fadd_rn(mv, acc[i][j][2 * h + c]);
              }
            }
        }
    }
  }

  // epilogue: out = master (kSumScale: * scale[n] in float32)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + 16 * i + g + 8 * h;
        const int col = n0 + wn * NT * 8 + 8 * j + 2 * tq;
        if (row >= m || col >= n) continue;
        float v0 = master[i][j][2 * h], v1 = master[i][j][2 * h + 1];
        if constexpr (W::kSumScale) {
          v0 = __fmul_rn(v0, scale[col]);
          if (col + 1 < n) v1 = __fmul_rn(v1, scale[col + 1]);
        }
        float* o = out + static_cast<size_t>(row) * n + col;
        if (col + 1 < n && (n & 1) == 0) {  // paired store needs 8-byte alignment
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (col + 1 < n) o[1] = v1;
        }
      }
}

// Host side: the device's SM count, read once (launchers size grids by it).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return v;
  }();
  return n;
}

// The x-row tile f32_quant_gemm takes for m x n: 16 for M <= 16, else of 128
// and 64 the one whose grid costs least, counted as waves x (BM + 32) (one
// block an SM; the 32 stands for the weight's widening and the split, which
// do not shrink with BM), a tie keeping the larger tile.
inline int f32q_tile_rows(int m, int n) {
  if (m <= 16) return 16;
  const long long sms = sm_count();
  const long long nt = (n + kF32QBN - 1) / kF32QBN;
  auto cost = [&](int bm) { return ((nt * ((m + bm - 1) / bm) + sms - 1) / sms) * (bm + 32); };
  return cost(128) <= cost(64) ? 128 : 64;
}

// Host side: one launch of an f32_quant_gemm kernel with tile rows BM (all
// share this signature; the weight's bytes as uint8), and the launch of the
// kernel of the tile the shape takes, of k16, k64 and k128.
using F32QKernel = void (*)(const float*, const uint8_t*, const float*, const float*, float*, int, int,
                            int, int);
template <class W, int BM>
inline cudaError_t launch_f32q_tile(F32QKernel kernel, const void* x, const void* w, const float* scale,
                                    const float* zero, void* out, int m, int n, int k, int kp,
                                    cudaStream_t stream) {
  constexpr int bytes = F32QSmem<W, BM>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kF32QBN - 1) / kF32QBN, (m + BM - 1) / BM);
  kernel<<<grid, F32QSmem<W, BM>::kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w), scale, zero, static_cast<float*>(out),
      m, n, k, kp);
  return cudaGetLastError();
}

template <class W>
inline cudaError_t launch_f32q(F32QKernel k16, F32QKernel k64, F32QKernel k128, const void* x,
                               const void* w, const float* scale, const float* zero, void* out, int m,
                               int n, int k, int kp, cudaStream_t stream) {
  switch (f32q_tile_rows(m, n)) {
    case 16:
      return launch_f32q_tile<W, 16>(k16, x, w, scale, zero, out, m, n, k, kp, stream);
    case 64:
      return launch_f32q_tile<W, 64>(k64, x, w, scale, zero, out, m, n, k, kp, stream);
    default:
      return launch_f32q_tile<W, 128>(k128, x, w, scale, zero, out, m, n, k, kp, stream);
  }
}

// Host side: cuTensorMapEncodeTiled, fetched through the CUDA runtime's
// entry-point query, so the library needs no -lcuda at link time.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major tensor of `rank` dimensions (dims[0] innermost, in elements;
// strides of dims 1.. in bytes, multiples of 16) → a TMA map of boxes
// `box`, 128-byte swizzle unless stated, zeros out of bounds.
inline cudaError_t make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                   const void* base, const cuuint64_t* dims,
                                   const cuuint64_t* strides, const cuuint32_t* box,
                                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}


// ------------------------------------------------------------------------
// Split-K weight-streaming GEMM for 8 < M < 128 bf16 rows of x against a
// quantized weight: out[m, n] = sum_k x[m, k] * w[n, k], the widening a
// policy W (as weight_gemv's).  The 4-bit matmul's middle form
// (q4_matmul.cu) and the group-dequant / W8A16 one (gq_matmul.cu)
// instantiate it: T5-XXL over SD3's 77 tokens, and an int8 SDXL UNet's
// context projections at CFG 1 (attn2.to_k / to_v over CLIP's 77 tokens).
//
// What bounds it on the card: at M = 77 a 4-bit weight does 2 * 80 = 160
// products a byte, about the H100's ridge (989 TFLOP/s over 3.35 TB/s is
// 295 operations a byte), so the bytes and the tensor cores bound it alike
// (77x4096->4096: 0.0032 ms of bytes, 0.0026 ms of bf16 products at 80
// rows); an int8 weight does half as many a byte and is bound by its bytes.
// Both want every SM busy and each SM's loads, widening and wgmma
// overlapped.
//
// Operands are swapped as in q4_wgmma_kernel: a block owns kSplitBN = 128
// weight rows (the wgmma M, 64 per consumer warpgroup) and every x row, one
// x tile of XN rows (the wgmma N: 32, 64, 80 or 128, the first that holds
// M), so no weight tile is fetched or widened twice.  A producer warp
// TMA-loads the weight tile (rows of W::kRowBytes, W::kSwizzle) and the
// bf16 x tile (128-byte swizzle) of each 64-k stage into a ring under full
// / empty mbarriers and cp.asyncs each row's f32 group scales of the stage
// beside them (none where W::kSumScale: the scale is a row's, applied in
// the epilogue); each consumer warpgroup builds its register-A fragments
// from the stage's bytes with W::row_pairs (the widened weight never
// touches shared memory) while the previous stage's wgmma run (fragments
// double-buffered).
//
// Filling the card: a band of 128 weight rows is a cluster of `splits`
// blocks (1 to 8, the portable cluster size), block r of which takes the
// r-th run of ceil(stages / splits) stages; the launcher picks the count
// whose grid costs least, counted as waves of clusters (as many as
// cudaOccupancyMaxActiveClusters says fit) x (stages a block +
// kSplitFixed).  On an H100 (132 SMs) 77x4096->4096 and 77x10240->4096 take
// 32 bands x 3 splits, 77x4096->10240 80 bands unsplit.  The reduction
// (splitk_store) is deterministic and needs no workspace and no second
// launch: each block writes its partial tile [XN][128] into its own (now
// idle) x ring, the cluster synchronises, and block r sums x rows [r *
// ceil(M / splits), ...) of all the cluster's partials through distributed
// shared memory in split order (0, 1, ...), applies the epilogue, rounds
// once and stores them; a second cluster barrier keeps every block's shared
// memory alive until its peers have read it.  An unsplit call stores its
// accumulators directly.  W8A8's int8 x int8 form (w8a8_matmul.cu) shares
// the launch shape, the split count and this reduction, with int32
// partials.
//
// What holds it: the consumers.  On an NVIDIA H100 80GB HBM3 at 700 W
// (device clock, chip_smoke.py and sdtpu_torch/tools/time_dequant.py)
// 77x4096->4096 and 77x10240->4096 at 4 bits, both 32 bands x 3 splits,
// 22 and 54 stages a block, take 0.0167 and 0.0323 ms: ~0.5 us a stage and
// ~6 us fixed (launch, first loads, the cluster reduction).  Timing-only
// development variants (wrong answers; not kept, nor their numbers) showed
// the stage's widening and its four chained m64n80k16 adding up rather than
// overlapping, the memory side hidden (the ring filled once and never
// waited on ran about as fast), and none of these overlapping them better:
// A from shared memory instead of registers, two accumulator chains,
// triple-buffered fragments, the next stage widened between this stage's
// wgmma, the warpgroups taking turns to issue, four consumer warpgroups
// (256-row bands, half the x reads), the partial tiles pushed to their
// summing block with one cluster barrier, and eight weight rows a thread in
// the sum (each slower).  So the launcher splits only where the grid would
// otherwise leave most SMs idle (kSplitFixed: ~12 stages), and an unsplit
// call skips the reduction.
//
// x traffic: each band re-reads its x columns from L2, XN x 2 bytes a k
// against the band's 64 bytes of packed weight a k (2.5x at XN = 80); the
// 256-row bands that halve it ran no faster (above): L2 serves these reads
// (0.63 MB of x at 77x4096) within the consumers' time.
//
// The policy W gives:
//   kKPerByte         weights a byte (2: packed nibbles, 1: int8);
//   kRowBytes         bytes of a weight row in a 64-k stage (64 / kKPerByte);
//   kSwizzle          the weight tile's TMA swizzle;
//   kSumScale         true: `scale` is f32 [n], one a weight row, the
//                     widening exact and the f32 sum multiplied by it before
//                     its rounding; false: f32 group scales [n, kp / G];
//   row_pairs<G>(tile, row, srow, tq, f)  the thread's bf16x2 register-A
//                     pairs of weight row `row` of the stage's tile and its
//                     f32 group scales `srow` (one a group of G in the
//                     stage): f[kk][h] holds k = 16 kk + 8 h + 2 tq and + 1.
constexpr int kSplitBN = 128;       // weight rows a block: two consumer warpgroups x 64 (wgmma M)
constexpr int kSplitBK = 64;        // K a stage: 128 bytes of a bf16 x row
constexpr int kSplitThreads = 384;  // warpgroups 0-1: consumers; 2: producer (its first warp)
constexpr int kSplitMax = 8;        // splits a call: the portable cluster size
constexpr int kSplitSTile = kSplitBN * (kSplitBK / 16) * 4;  // a stage's f32 scales, G >= 16
constexpr int kSplitPRow = kSplitBN + 4;  // words a row of the partial tile: conflict-free stores
constexpr int kSplitFixed = 12;     // a block's fixed cost in stages: pipeline fill, reduction
constexpr int kSplitRing = 200 * 1024;  // shared bytes the ring may take

// x rows a block (the wgmma N) at m rows
constexpr int splitk_cols(int m) {
  return m <= 32 ? 32 : m <= 64 ? 64 : m <= 80 ? 80 : 128;
}

template <class W, int XN>
struct SplitKSmem {
  static constexpr int kXTile = XN * kSplitBK * 2;  // whole 1 KB swizzle atoms
  static constexpr int kWTile = kSplitBN * W::kRowBytes;
  static constexpr int kStage = kXTile + kWTile + kSplitSTile;
  static constexpr int kStages = kSplitRing / kStage < 12 ? kSplitRing / kStage : 12;
  static constexpr int kBytes = 1024 + kStages * kStage + 2 * kStages * 8;
  static_assert(kStages * kXTile >= XN * kSplitPRow * 4, "split-K: the partial tile must fit the x ring");
  static_assert(kBytes <= 232448, "split-K: shared memory over the 227 KB a block may use");
};

// acc += W_tile . x_tile^T for one k16 step, wgmma N = XN
template <int XN>
__device__ __forceinline__ void splitk_wgmma(float (&acc)[XN / 2], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  if constexpr (XN == 128) {
    wgmma_m64n128k16_bf16_rs<0>(acc, a, desc_b, 1);
  } else if constexpr (XN == 80) {
    wgmma_m64n80k16_bf16_rs<0>(acc, a, desc_b, 1);
  } else if constexpr (XN == 64) {
    wgmma_m64n64k16_bf16_rs<0>(acc, a, desc_b, 1);
  } else {
    wgmma_m64n32k16_bf16_rs<0>(acc, a, desc_b, 1);
  }
}

// A 32-bit word of shared memory as the accumulator type it holds.
template <typename T>
__device__ __forceinline__ T word_as(uint32_t w);
template <>
__device__ __forceinline__ float word_as<float>(uint32_t w) { return __uint_as_float(w); }
template <>
__device__ __forceinline__ int word_as<int>(uint32_t w) { return static_cast<int>(w); }

// The end of a split-K block: its consumer warpgroups' accumulators acc
// (the wgmma layout: acc[4j + e] is weight row r0 (+8 for e >= 2) of the
// band at n0, x row 8j + 2tq (+1 for odd e)), summed over the cluster's
// `splits` blocks in split order where K was split, each sum v of x row mm
// and weight row nn stored as out[mm, nn] = round(value(mm, nn, v)).  The
// x ring at x_base takes the partial tile, so every stage's wgmma must be
// complete.  Called by the two consumer warpgroups (256 threads); the
// producer warpgroup meets the two cluster barriers.
template <int XN, typename Acc, typename TOut, class Value>
__device__ __forceinline__ void splitk_store(const Acc (&acc)[XN / 2], uint8_t* smem, uint32_t x_base,
                                             TOut* __restrict__ out, int m, int n, int n0, int r0,
                                             int tq, int splits, Value value) {
  if (splits == 1) {  // the whole sum: no reduction
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nn = n0 + r0 + 8 * h;
      if (nn >= n) continue;
#pragma unroll
      for (int j = 0; j < XN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mm = 8 * j + 2 * tq + e;
          if (mm < m)
            out[static_cast<size_t>(mm) * n + nn] = from_f32<TOut>(value(mm, nn, acc[4 * j + 2 * h + e]));
        }
    }
    return;
  }

  // This block's partial tile, part[x row][weight row], over its own x ring
  // once both consumer warpgroups' wgmma are done reading it.
  __syncwarp();
  named_bar_sync(1, 256);
  Acc* part = reinterpret_cast<Acc*>(smem + x_base);
#pragma unroll
  for (int j = 0; j < XN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        part[(8 * j + 2 * tq + e) * kSplitPRow + r0 + 8 * h] = acc[4 * j + 2 * h + e];
  cluster_sync();

  // x rows [m_lo, m_hi) of the band: the cluster's partials summed in split
  // order, four weight rows a thread and step
  const int rank = static_cast<int>(cluster_ctarank());
  const int rows = (m + splits - 1) / splits;
  const int m_lo = rank * rows, m_hi = min(m, m_lo + rows);
  const int items = max(0, m_hi - m_lo) * (kSplitBN / 4);
  for (int idx = threadIdx.x; idx < items; idx += 256) {
    const int mm = m_lo + idx / (kSplitBN / 4), c = (idx % (kSplitBN / 4)) * 4;
    const uint32_t addr = x_base + (mm * kSplitPRow + c) * 4;
    const uint4 v0 = ld_cluster_v4(cluster_map(addr, 0));
    Acc sum[4] = {word_as<Acc>(v0.x), word_as<Acc>(v0.y), word_as<Acc>(v0.z), word_as<Acc>(v0.w)};
    for (int q = 1; q < splits; ++q) {
      const uint4 v = ld_cluster_v4(cluster_map(addr, q));
      sum[0] += word_as<Acc>(v.x);
      sum[1] += word_as<Acc>(v.y);
      sum[2] += word_as<Acc>(v.z);
      sum[3] += word_as<Acc>(v.w);
    }
    const int nn = n0 + c;
    TOut* o = out + static_cast<size_t>(mm) * n + nn;
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = nn + e < n ? value(mm, nn + e, sum[e]) : 0.f;
    if ((n & 3) == 0 && nn < n) {  // four outputs, aligned to their width
      if constexpr (sizeof(TOut) == 2) {
        *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
      } else {
        *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nn + e < n) o[e] = from_f32<TOut>(f[e]);
    }
  }
  cluster_sync();
}

// out[0:m, n0:n0 + 128] of one block of the cluster: xmap the bf16 x [m, k]
// (box 64 x XN), wmap the weight bytes [n, kp / kKPerByte] (box kRowBytes x
// 128), scale f32 [n, kp / G] (W::kSumScale: [n]); the grid is ceil(n / 128)
// clusters of `splits` blocks.
template <class W, int G, int XN>
__device__ __forceinline__ void splitk_gemm(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                            const float* __restrict__ scale,
                                            __nv_bfloat16* __restrict__ out, int m, int n, int k,
                                            int kp, int splits) {
  using S = SplitKSmem<W, XN>;
  constexpr int kStages = S::kStages;
  constexpr int GPS = kSplitBK / G;  // scale groups a row per stage: 4, 2 or 1
  extern __shared__ __align__(16) uint8_t splitk_smem[];
  const uint32_t raw = smem_u32(splitk_smem);
  const uint32_t x_base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t w_base = x_base + kStages * S::kXTile;
  const uint32_t s_base = w_base + kStages * S::kWTile;
  const uint32_t bars = s_base + kStages * kSplitSTile;
  uint8_t* smem = splitk_smem - raw;  // generic pointer of shared address 0
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int rank = static_cast<int>(cluster_ctarank());
  const int n0 = (blockIdx.x / splits) * kSplitBN;
  const int ktiles = (k + kSplitBK - 1) / kSplitBK;  // stages past K would add zeros
  const int per = (ktiles + splits - 1) / splits;
  const int kt0 = rank * per;
  const int nk = max(0, min(ktiles, kt0 + per) - kt0);  // this block's stages
  const int groups = kp / G;

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA arrival, plus one cp.async arrival per producer lane
      mbar_init(full(s), W::kSumScale ? 1 : 1 + 32);
      mbar_init(empty(s), 8);  // the consumers' eight warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: the first warp; lane 0 issues the TMA loads, all lanes
    // cp.async the stage's scales (a scale row is kp / G x 4 bytes, not
    // always the 16-byte multiple a TMA map needs): one copy of 4 * GPS
    // bytes a row where a row's groups come in whole stages (every 4-bit
    // weight: kp % 64 == 0), else one of 4 bytes a group, the groups past a
    // row's last zero-filled
    setmaxnreg_dec<40>();
    if (threadIdx.x < 256 + 32) {
      const bool whole = groups % GPS == 0;
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages, kt = kt0 + i;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(s), S::kXTile + S::kWTile);
          tma_load_2d(x_base + s * S::kXTile, xmap, full(s), kt * kSplitBK, 0);
          tma_load_2d(w_base + s * S::kWTile, wmap, full(s), kt * W::kRowBytes, n0);
        }
        if constexpr (!W::kSumScale) {
          const uint32_t dst = s_base + s * kSplitSTile;
          if (whole) {
            for (int r = lane; r < kSplitBN; r += 32) {
              const bool valid = n0 + r < n && kt * GPS < groups;
              const size_t off = valid ? static_cast<size_t>(n0 + r) * groups + kt * GPS : 0;
              cp_async_n<4 * GPS>(dst + r * 4 * GPS, scale + off, valid);
            }
          } else {
            for (int idx = lane; idx < kSplitBN * GPS; idx += 32) {
              const int r = idx / GPS, grp = kt * GPS + idx % GPS;
              const bool valid = n0 + r < n && grp < groups;
              const size_t off = valid ? static_cast<size_t>(n0 + r) * groups + grp : 0;
              cp_async_4(dst + idx * 4, scale + off, valid);
            }
          }
          cp_async_mbar_arrive(full(s));
        }
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

  // The stage's weight tile widened into the register-A layout of four k16
  // steps: a[kk] = {(r0, 2tq..+1), (r0+8, 2tq..+1), (r0, 2tq+8..+9),
  // (r0+8, 2tq+8..+9)} of K columns 16kk..
  auto widen = [&](uint32_t (&a)[4][4], int s) {
    const uint8_t* wt = smem + w_base + s * S::kWTile;
    const float* sc = reinterpret_cast<const float*>(smem + s_base + s * kSplitSTile);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      uint32_t f[4][2];
      W::template row_pairs<G>(wt, row, sc + row * GPS, tq, f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a[kk][rr] = f[kk][0];
        a[kk][2 + rr] = f[kk][1];
      }
    }
  };

  // acc[4j + e]: weight row r0 (+8 for e >= 2), x row 8j + 2tq (+1 for odd e)
  float acc[XN / 2];
#pragma unroll
  for (int i = 0; i < XN / 2; ++i) acc[i] = 0.f;
  uint32_t a0[4][4], a1[4][4];

  // One stage: issue its four wgmma on `cur`, then, while they run, free
  // the stage before it and widen the next stage into `nxt` (whose previous
  // wgmma group is complete after wait<1>).
  auto step = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4], int i) {
    const int s = i % kStages;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      splitk_wgmma<XN>(acc, cur[kk], smem_desc_sw128(x_base + s * S::kXTile + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    fence_regs(nxt);
    if (i > 0 && lane == 0) mbar_arrive(empty((i - 1) % kStages));
    if (i + 1 < nk) {
      const int s1 = (i + 1) % kStages;
      mbar_wait(full(s1), ((i + 1) / kStages) & 1);
      widen(nxt, s1);
    }
  };

  if (nk > 0) {
    mbar_wait(full(0), 0);
    widen(a0, 0);
    for (int i = 0; i < nk; i += 2) {
      step(a0, a1, i);
      if (i + 1 < nk) step(a1, a0, i + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a0);
    fence_regs(a1);
  }

  // W::kSumScale: the f32 sum times its row's scale, then the one rounding
  splitk_store<XN>(acc, smem, x_base, out, m, n, n0, r0, tq, splits,
                   [&](int, int nn, float v) { return W::kSumScale ? __fmul_rn(v, scale[nn]) : v; });
}

// Host side: the bf16 kernels of this form share one signature.
using SplitKKernel = void (*)(CUtensorMap, CUtensorMap, const float*, __nv_bfloat16*, int, int, int,
                              int, int);

// Clusters of `splits` blocks of `kernel` (kSplitThreads threads, `smem`
// bytes of shared memory) that the card holds at once (the SM count over
// `splits` where the runtime cannot say).
inline int splitk_capacity(const void* kernel, int smem, int splits) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess || clusters <= 0) {
    cudaGetLastError();  // not sticky: clear it
    return sm_count() / splits;
  }
  return clusters;
}

// Splits of K a call of `stages` K stages takes: of 1 to kSplitMax (at most
// one a stage), the count whose grid costs least, counted as waves of
// clusters x (stages a block + kSplitFixed); a tie keeps fewer.
// `capacity(s)`: clusters of s blocks the card holds at once.
template <class Capacity>
inline int splitk_splits(int n, int stages, Capacity capacity) {
  const long long bands = ceil_div(n, kSplitBN);
  int best = 1;
  long long best_cost = LLONG_MAX;
  for (int s = 1; s <= kSplitMax && s <= stages; ++s) {
    const long long clusters = capacity(s);
    if (clusters <= 0) continue;
    const long long cost = (bands + clusters - 1) / clusters * ((stages + s - 1) / s + kSplitFixed);
    if (cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// splitk_splits on `kernel` (Smem::kBytes of shared memory), the card's
// capacity asked once per split count for each Smem: the kernels that share
// a shared-memory layout share their threads and so their capacity.
template <class Smem>
inline int splitk_splits_for(const void* kernel, int n, int stages) {
  static int cap[kSplitMax + 1] = {};
  return splitk_splits(n, stages, [&](int s) {
    if (cap[s] == 0) cap[s] = splitk_capacity(kernel, Smem::kBytes, s);
    return cap[s];
  });
}

// f(std::integral_constant<int, XN>{}) at XN = splitk_cols(m): the one place
// a call's row count picks a split-K kernel's compile-time x rows.
template <class F>
inline auto with_splitk_cols(int m, F&& f) {
  switch (splitk_cols(m)) {
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 80:
      return f(std::integral_constant<int, 80>{});
    default:
      return f(std::integral_constant<int, 128>{});
  }
}

// One launch of `kernel` over ceil(n / 128) clusters of `splits` blocks,
// with its arguments `args`.  `dependent`: it may start while the launch
// before it on the stream still runs (programmatic dependent launch; the
// kernel calls griddep_wait before it reads that launch's output).
inline cudaError_t launch_splitk_grid(const void* kernel, int smem, int n, int splits, bool dependent,
                                      void** args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ceil_div(n, kSplitBN) * splits);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = dependent ? 2 : 1;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One launch of a bf16 split-K kernel: the TMA maps of x (bf16 [m, k]) and
// the weight's bytes ([n, kp / W::kKPerByte]), then ceil(n / 128) clusters
// of `splits` blocks.
template <class W>
inline cudaError_t launch_splitk(SplitKKernel kernel, int smem, int xn, const void* x,
                                 const void* w, const float* scale, void* out, int m, int n, int k,
                                 int kp, int splits, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t xbox[2] = {kSplitBK, static_cast<cuuint32_t>(xn)};
  cudaError_t err = make_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(kp / W::kKPerByte), static_cast<cuuint64_t>(n)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(kp / W::kKPerByte)};
  const cuuint32_t wbox[2] = {W::kRowBytes, kSplitBN};
  err = make_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, wstrides, wbox, W::kSwizzle);
  if (err != cudaSuccess) return err;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  void* args[] = {&xmap, &wmap, &scale, &o, &m, &n, &k, &kp, &splits};
  return launch_splitk_grid(reinterpret_cast<const void*>(kernel), smem, n, splits, false, args, stream);
}

}  // namespace sdtpu
