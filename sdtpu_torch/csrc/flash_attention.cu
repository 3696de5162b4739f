// Flash attention for Hopper: softmax(q.k^T * scale + bias) . v
//
// Replaces the TPU kernels `_flash_kernel` (sdtpu/ops/flash_attention.py:51)
// and `_flash_kernel_whole_chunked` (:129), with their bias-free forms (:304,
// :312).  On the TPU the two differ only in how much of K/V is held in VMEM;
// here a block walks the keys in tiles in a loop, which takes the place of
// the TPU's sequential KV grid axis.  The online softmax (running max m, sum
// l, accumulator) stays in registers in f32 and runs in exp2 with log2(e)
// folded into the score scale, as on the TPU.  The L x L scores never reach
// device memory.  Rows past Lq and keys past Lk need no padding copies.
//
// What bounds it on the card: at the FLUX shapes (L = 4352 or 1280, D = 128)
// attention is compute bound -- 4*L^2*D FLOPs against 4*L*D*2 bytes per
// head (233 GFLOP at 1024^2: 0.235 ms at 989 TFLOP/s, against 0.0034 ms of
// bytes) -- so both products belong on the tensor cores at full rate.
//
// bf16, D = 64 and 128 (FLUX joint attention, CLIP-L): `flash_wgmma_kernel`.
// A block owns a 128-row Q tile of one batch*head: one producer warp and
// two consumer warpgroups of 64 rows each (setmaxnreg hands the producer's
// registers to the consumers).  The producer TMA-loads Q once and streams
// 128-key K and V tiles through a two-stage ring (128-byte swizzle, 64-wide
// column blocks, full/empty mbarriers; 160 KB at D = 128), so loads overlap
// the math.  S = Q K^T is wgmma m64n128k16 with both operands K-major in
// shared memory; P is converted to bf16 in registers, in the register-A
// layout, and O += P V is wgmma with A = P from registers and B = the V tile
// read MN-major through the descriptor's transpose bit: P never touches
// shared memory and V is never transposed.  TMA zero-fills rows past Lq and
// Lk (the maps are 3-D: D, L, batch*head); keys past Lk are masked only in
// the last tile.  The dense f32 [Lq, Lk] bias (CLIP's causal mask) is a
// template parameter, so the unbiased FLUX path has no per-score branch.
//
// bf16, D = 512 (the VAE mid-block, one head over a 64 x 64 latent tile,
// Lq = Lk = 4096): `flash_d512_kernel`, replacing the same four TPU kernels
// at that head dim.  What bounds it: 4 * 4096^2 * 512 = 34.4 GFLOP per
// tile, 0.0347 ms at 989 TFLOP/s (NVIDIA H100 SXM data sheet, 700 W),
// against 0.0050 ms of bytes -- compute bound, so both products go to
// wgmma.  A 64-row Q tile's 64 x 512 f32 accumulator does not fit one
// warpgroup, so the block's two consumer warpgroups split the head dim:
// each computes a partial S = Q K^T over its 256 columns (wgmma m64n32k16,
// Q and K K-major from TMA), the halves are summed through a 64 x 32 f32
// swap buffer in shared memory under one named barrier, each runs the
// same online softmax on the full S, and O[:, half] += P V runs with P from
// registers and the warpgroup's 256-column V half read MN-major (wgmma
// m64n256k16, transpose bit).  The scores are computed once per key tile:
// the first form recomputed them for each of four 128-wide output slices.
// Shared memory (bytes): Q 65,536 + two K stages and two V stages of 32
// keys 131,072 + swap buffer (two tiles in flight x two halves) 32,768 +
// 1 KB alignment + barriers = 230,472 of the 232,448 a block may have; K
// and V have rings of their own, so the next K tile loads under P V.  The
// VAE call gives 64 blocks for 132 SMs, so the keys are split (the launcher
// picks the count that minimises the grid's waves: two there, one at Lq =
// 16384): each split writes its f32 accumulator, max and sum, and
// `flash_d512_combine_kernel` merges them.  Ragged edges, the last-tile
// mask, the bias template and the exp2 units are as in the D 64/128 kernel.
//
// The f32 kernel is the parity variant: plain FMA arithmetic, one thread per
// query row, Q stored transposed in shared memory.  It is slow by design.
#include "common.cuh"

#include <math.h>

#include <algorithm>

namespace sdtpu {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;

// --------------------------------------------- bf16 D 64/128: TMA + wgmma

constexpr int kWQ = 128;        // query rows per block: two consumer warpgroups x 64
constexpr int kWK = 128;        // keys per K/V tile
constexpr int kWStages = 2;     // K/V ring depth
constexpr int kWThreads = 384;  // warpgroups 0-1: consumers; 2: producer
constexpr int kColBytes = 128;  // a 64-element bf16 column block: one swizzle row

template <int D>
constexpr int wgmma_smem_bytes() {
  return 1024 + kWQ * D * 2 + 2 * kWStages * kWK * D * 2 + (1 + 3 * kWStages) * 8;
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ o, int lq, int lk, float scale_log2) {
  static_assert(D == 64 || D == 128, "the wgmma kernel takes head dims 64 and 128");
  constexpr int CB = D / 64;                   // column blocks per row
  constexpr int kQBlock = kWQ * kColBytes;     // one column block of the Q tile
  constexpr int kKVBlock = kWK * kColBytes;    // one column block of a K or V tile
  constexpr int kKVBytes = CB * kKVBlock;      // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t k_base = q_base + CB * kQBlock;
  const uint32_t v_base = k_base + kWStages * kKVBytes;
  const uint32_t bars = v_base + kWStages * kKVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kWStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kWStages + s); };

  const int wg = threadIdx.x >> 7;
  const int q0 = blockIdx.x * kWQ;
  const int bh = blockIdx.y;
  const int ntiles = (lk + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // the consumers' eight warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, CB * kQBlock);
      for (int cb = 0; cb < CB; ++cb) tma_load_3d(q_base + cb * kQBlock, &qmap, q_full, cb * 64, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kWStages;
        mbar_wait(empty(s), ((t / kWStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), kKVBytes);
        for (int cb = 0; cb < CB; ++cb)
          tma_load_3d(k_base + s * kKVBytes + cb * kKVBlock, &kmap, k_full(s), cb * 64, t * kWK, bh);
        mbar_expect_tx(v_full(s), kKVBytes);
        for (int cb = 0; cb < CB; ++cb)
          tma_load_3d(v_base + s * kKVBytes + cb * kKVBlock, &vmap, v_full(s), cb * 64, t * kWK, bh);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int row_w = wg * 64 + warp * 16 + g;  // this thread's rows in the tile: row_w, row_w + 8
    const uint32_t q_rows = wg * 64 * kColBytes;  // this warpgroup's 64 rows of each Q column block

    // acc[4j + e]: row row_w (+8 for e >= 2), column 8j + 2tq (+1 for odd e)
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegBig, kNegBig};
    float l_run[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kWStages;
      const uint32_t par = (t / kWStages) & 1;
      const int kt = t * kWK;

      // S = Q K^T: 64 rows x 128 keys, f32, as sc[4j + e] like acc
      float sc[kWK / 2];
      mbar_wait(k_full(s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kQBlock + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * kKVBlock + (kk % 4) * 32;
        wgmma_m64n128k16_bf16_ss(sc, smem_desc_sw128(q_base + q_rows + off, 16, 1024),
                                 smem_desc_sw128(k_base + s * kKVBytes + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale into log2 units; the bias and the Lk edge where they apply
#pragma unroll
      for (int i = 0; i < kWK / 2; ++i) sc[i] *= scale_log2;
      if constexpr (kBias) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qrow = q0 + row_w + 8 * h;
          if (qrow >= lq) continue;
          const float* brow = bias + static_cast<size_t>(qrow) * lk;
#pragma unroll
          for (int j = 0; j < kWK / 8; ++j) {
            const int key = kt + j * 8 + 2 * tq;
            if (key < lk) sc[4 * j + 2 * h] += brow[key] * kLog2e;
            if (key + 1 < lk) sc[4 * j + 2 * h + 1] += brow[key + 1] * kLog2e;
          }
        }
      }
      if (kt + kWK > lk) {
#pragma unroll
        for (int j = 0; j < kWK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kt + j * 8 + 2 * tq + (e & 1) >= lk) sc[4 * j + e] = -INFINITY;
      }

      // online softmax; a row's 128 scores are spread over the 4 threads of a quad
      float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < kWK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m_new[e >> 1] = fmaxf(m_new[e >> 1], sc[4 * j + e]);
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
        m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
        alpha[h] = exp2f(m_run[h] - m_new[h]);
        m_run[h] = m_new[h];
      }
      // P in bf16, in the register-A layout of the k16 steps of P V: the S
      // columns of two neighbouring 8-key chunks are one A fragment
      uint32_t pa[kWK / 16][4];
#pragma unroll
      for (int j = 0; j < kWK / 8; ++j) {
        const float p0 = exp2f(sc[4 * j + 0] - m_new[0]), p1 = exp2f(sc[4 * j + 1] - m_new[0]);
        const float p2 = exp2f(sc[4 * j + 2] - m_new[1]), p3 = exp2f(sc[4 * j + 3] - m_new[1]);
        rsum[0] += p0 + p1;
        rsum[1] += p2 + p3;
        pa[j / 2][(j & 1) * 2 + 0] = pack_bf16x2(p0, p1);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(p2, p3);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
        l_run[h] = l_run[h] * alpha[h] + rsum[h];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: B = the V tile [keys][D], read MN-major (D contiguous)
      mbar_wait(v_full(s), par);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kWK / 16; ++kc) {
        const uint64_t dv = smem_desc_sw128(v_base + s * kKVBytes + kc * 16 * kColBytes, kKVBlock, 1024);
        if constexpr (D == 128) {
          wgmma_m64n128k16_bf16_rs<1>(acc, pa[kc], dv, 1);
        } else {
          wgmma_m64n64k16_bf16_rs<1>(acc, pa[kc], dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty(s));
    }

    __nv_bfloat16* ob = o + static_cast<size_t>(bh) * lq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qrow = q0 + row_w + 8 * h;
      if (qrow >= lq) continue;
      const float inv = 1.f / l_run[h];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(qrow) * D + j * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
    }
  }
}

// ----------------------------------------------- bf16 D 512: TMA + wgmma

constexpr int kXQ = 64;        // query rows per block: one wgmma M tile, shared by both consumers
constexpr int kXK = 32;        // keys per K/V tile
constexpr int kXStages = 2;    // K and V ring depth
constexpr int kXD = 512;       // head dim
constexpr int kXHalf = kXD / 2;               // head-dim columns per consumer warpgroup
constexpr int kXQBlock = kXQ * kColBytes;     // one 64-column block of the Q tile: 8 KB
constexpr int kXKVBlock = kXK * kColBytes;    // one 64-column block of a K or V tile: 4 KB
constexpr int kXKVBytes = (kXD / 64) * kXKVBlock;  // one K or V tile: 32 KB
constexpr int kXSwapFloats = (kXK / 2) * 128;      // one warpgroup's partial S, 16 floats a thread
constexpr int kXSmem = 1024 + (kXD / 64) * kXQBlock + 2 * kXStages * kXKVBytes +
                       2 * 2 * kXSwapFloats * 4 + (1 + 4 * kXStages) * 8;
static_assert(kXSmem <= 232448, "D 512 flash: shared memory over the 227 KB a block may use");
constexpr int kXMaxSplits = 16;

// A block owns a 64-row Q tile of one batch*head and the key tiles
// [t_begin, t_end) of its split (blockIdx.z).  Warpgroup 0 owns head-dim
// columns 0-255 and warpgroup 1 columns 256-511, both for the partial
// scores and for the output.  With one split the block writes the
// normalised bf16 output; with several it writes its f32 accumulator and
// its running max / sum for the combine kernel.
template <bool kBias>
__global__ void __launch_bounds__(kWThreads, 1)
flash_d512_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ part_o,
                  float* __restrict__ part_ml, int lq, int lk, int tiles_per_split,
                  float scale_log2) {
  constexpr int CB = kXD / 64;  // column blocks per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t k_base = q_base + CB * kXQBlock;
  const uint32_t v_base = k_base + kXStages * kXKVBytes;
  const uint32_t swap_base = v_base + kXStages * kXKVBytes;
  const uint32_t bars = swap_base + 2 * 2 * kXSwapFloats * 4;
  float* swap = reinterpret_cast<float*>(smem_raw + (swap_base - raw));
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kXStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kXStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kXStages + s); };

  const int wg = threadIdx.x >> 7;
  const int q0 = blockIdx.x * kXQ;
  const int bh = blockIdx.y;
  const int ntiles = (lk + kXK - 1) / kXK;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int count = min(ntiles, t_begin + tiles_per_split) - t_begin;  // >= 1 by the launcher

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kXStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // the consumers' eight warps
      mbar_init(v_empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load; K and V have rings of their
    // own, so the next K tile streams in while this tile's P V runs
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, CB * kXQBlock);
      for (int cb = 0; cb < CB; ++cb) tma_load_3d(q_base + cb * kXQBlock, &qmap, q_full, cb * 64, q0, bh);
      for (int i = 0; i < count; ++i) {
        const int s = i % kXStages;
        const uint32_t free_par = ((i / kXStages) & 1) ^ 1;
        const int key0 = (t_begin + i) * kXK;
        mbar_wait(k_empty(s), free_par);
        mbar_expect_tx(k_full(s), kXKVBytes);
        for (int cb = 0; cb < CB; ++cb)
          tma_load_3d(k_base + s * kXKVBytes + cb * kXKVBlock, &kmap, k_full(s), cb * 64, key0, bh);
        mbar_wait(v_empty(s), free_par);
        mbar_expect_tx(v_full(s), kXKVBytes);
        for (int cb = 0; cb < CB; ++cb)
          tma_load_3d(v_base + s * kXKVBytes + cb * kXKVBlock, &vmap, v_full(s), cb * 64, key0, bh);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int wtid = threadIdx.x & 127;
    const int row_w = warp * 16 + g;  // this thread's rows in the tile: row_w, row_w + 8

    // acc[4j + e]: row row_w (+8 for e >= 2), column wg * 256 + 8j + 2tq (+1 for odd e)
    float acc[kXHalf / 2];
#pragma unroll
    for (int i = 0; i < kXHalf / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegBig, kNegBig};
    float l_run[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int i = 0; i < count; ++i) {
      const int s = i % kXStages;
      const uint32_t par = (i / kXStages) & 1;
      const int kt = (t_begin + i) * kXK;

      // this warpgroup's half of S = Q K^T: 64 rows x 32 keys over its 256
      // head-dim columns, as sc[4j + e] like acc
      float sc[kXK / 2];
      mbar_wait(k_full(s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kXHalf / 16; ++kk) {
        const int cb = wg * (kXHalf / 64) + kk / 4;
        const uint32_t off = (kk % 4) * 32;
        wgmma_m64n32k16_bf16_ss(sc, smem_desc_sw128(q_base + cb * kXQBlock + off, 16, 1024),
                                smem_desc_sw128(k_base + s * kXKVBytes + cb * kXKVBlock + off, 16, 1024),
                                kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty(s));

      // the two halves meet in shared memory: each warpgroup adds the other's
      // partial (a + b == b + a, so both hold the same S, bit for bit).  The
      // swap buffer alternates with the tile, so one barrier a tile suffices.
      float* mine = swap + ((i & 1) * 2 + wg) * kXSwapFloats;
      const float* other = swap + ((i & 1) * 2 + (wg ^ 1)) * kXSwapFloats;
#pragma unroll
      for (int r = 0; r < kXK / 2; ++r) mine[r * 128 + wtid] = sc[r];
      named_bar_sync(1, 256);
#pragma unroll
      for (int r = 0; r < kXK / 2; ++r) sc[r] += other[r * 128 + wtid];

      // scale into log2 units; the bias and the Lk edge where they apply
#pragma unroll
      for (int r = 0; r < kXK / 2; ++r) sc[r] *= scale_log2;
      if constexpr (kBias) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qrow = q0 + row_w + 8 * h;
          if (qrow >= lq) continue;
          const float* brow = bias + static_cast<size_t>(qrow) * lk;
#pragma unroll
          for (int j = 0; j < kXK / 8; ++j) {
            const int key = kt + j * 8 + 2 * tq;
            if (key < lk) sc[4 * j + 2 * h] += brow[key] * kLog2e;
            if (key + 1 < lk) sc[4 * j + 2 * h + 1] += brow[key + 1] * kLog2e;
          }
        }
      }
      if (kt + kXK > lk) {
#pragma unroll
        for (int j = 0; j < kXK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kt + j * 8 + 2 * tq + (e & 1) >= lk) sc[4 * j + e] = -INFINITY;
      }

      // online softmax; a row's 32 scores are spread over the 4 threads of a quad
      float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < kXK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m_new[e >> 1] = fmaxf(m_new[e >> 1], sc[4 * j + e]);
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
        m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
        alpha[h] = exp2f(m_run[h] - m_new[h]);
        m_run[h] = m_new[h];
      }
      uint32_t pa[kXK / 16][4];
#pragma unroll
      for (int j = 0; j < kXK / 8; ++j) {
        const float p0 = exp2f(sc[4 * j + 0] - m_new[0]), p1 = exp2f(sc[4 * j + 1] - m_new[0]);
        const float p2 = exp2f(sc[4 * j + 2] - m_new[1]), p3 = exp2f(sc[4 * j + 3] - m_new[1]);
        rsum[0] += p0 + p1;
        rsum[1] += p2 + p3;
        pa[j / 2][(j & 1) * 2 + 0] = pack_bf16x2(p0, p1);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(p2, p3);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
        l_run[h] = l_run[h] * alpha[h] + rsum[h];
      }
#pragma unroll
      for (int r = 0; r < kXHalf / 2; ++r) acc[r] *= alpha[(r >> 1) & 1];

      // O += P V over this warpgroup's 256 columns: B = the V tile's four
      // column blocks, read MN-major (head dim contiguous), `lbo` apart
      mbar_wait(v_full(s), par);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kXK / 16; ++kc) {
        const uint64_t dv = smem_desc_sw128(
            v_base + s * kXKVBytes + wg * (kXHalf / 64) * kXKVBlock + kc * 16 * kColBytes, kXKVBlock, 1024);
        wgmma_m64n256k16_bf16_rs<1>(acc, pa[kc], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(v_empty(s));
    }

    const size_t bh_rows = static_cast<size_t>(bh) * lq;
    const int col0 = wg * kXHalf + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qrow = q0 + row_w + 8 * h;
      if (qrow >= lq) continue;
      if (part_o == nullptr) {
        const float inv = 1.f / l_run[h];
        __nv_bfloat16* orow = o + (bh_rows + qrow) * kXD;
#pragma unroll
        for (int j = 0; j < kXHalf / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + col0 + j * 8) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      } else {
        const size_t prow = static_cast<size_t>(blockIdx.z) * gridDim.y * lq + bh_rows + qrow;
        float* orow = part_o + prow * kXD;
#pragma unroll
        for (int j = 0; j < kXHalf / 8; ++j)
          *reinterpret_cast<float2*>(orow + col0 + j * 8) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (wg == 0 && tq == 0) {
          part_ml[2 * prow] = m_run[h];
          part_ml[2 * prow + 1] = l_run[h];
        }
      }
    }
  }
}

// The split-keys combine: o = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s,
// M the largest m_s.  One block per output row, four columns a thread.
__global__ void __launch_bounds__(128)
flash_d512_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                          __nv_bfloat16* __restrict__ o, int rows, int splits) {
  const size_t row = blockIdx.x;
  const int c = threadIdx.x * 4;
  float mx = kNegBig;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[2 * (s * static_cast<size_t>(rows) + row)]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const size_t prow = s * static_cast<size_t>(rows) + row;
    const float w = exp2f(part_ml[2 * prow] - mx);
    l += w * part_ml[2 * prow + 1];
    const float4 p = *reinterpret_cast<const float4*>(part_o + prow * kXD + c);
    acc.x += w * p.x;
    acc.y += w * p.y;
    acc.z += w * p.z;
    acc.w += w * p.w;
  }
  const float inv = 1.f / l;
  __nv_bfloat16* orow = o + row * kXD + c;
  *reinterpret_cast<__nv_bfloat162*>(orow) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  *reinterpret_cast<__nv_bfloat162*>(orow + 2) = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
}

// Key splits for D 512: the fewest that minimise the waves of the grid
// (ceil(blocks * s / SMs) / s), at least one key tile a split.  The VAE's
// [1, 4096] call has 64 Q tiles on 132 SMs and takes two; Lq = 16384 takes one.
int d512_splits(int bh, int lq, int lk) {
  const long long blocks = static_cast<long long>(ceil_div(lq, kXQ)) * bh;
  const int ntiles = ceil_div(lk, kXK);
  const int sms = sm_count();
  int best = 1;
  double best_cost = static_cast<double>((blocks + sms - 1) / sms);
  for (int s = 2; s <= std::min(kXMaxSplits, ntiles); ++s) {
    const double cost = static_cast<double>((blocks * s + sms - 1) / sms) / s;
    if (cost < best_cost - 1e-9) {
      best = s;
      best_cost = cost;
    }
  }
  const int per = ceil_div(ntiles, best);
  return ceil_div(ntiles, per);  // every split gets at least one tile
}

size_t d512_workspace_bytes(int bh, int lq, int lk) {
  const int splits = d512_splits(bh, lq, lk);
  if (splits == 1) return 0;
  return static_cast<size_t>(splits) * bh * lq * (kXD + 2) * sizeof(float);
}

// ----------------------------------------------------------------- f32

constexpr int kFQ = 64;   // query rows per block, one per thread
constexpr int kFK = 32;   // keys per tile
constexpr int kFDV = 64;  // output head-dim slice per block

template <int D>
constexpr int f32_smem_bytes() {
  return (D * kFQ + kFK * D + kFK * kFDV) * 4;
}

template <int D>
__global__ void __launch_bounds__(kFQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, int lq, int lk, float scale_log2) {
  extern __shared__ __align__(16) float fsm[];
  float* qt = fsm;               // [D][kFQ]: Q tile transposed
  float* ks = qt + D * kFQ;      // [kFK][D]
  float* vs = ks + kFK * D;      // [kFK][kFDV]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kFQ;
  const size_t bh = blockIdx.y;
  const int d0 = blockIdx.z * kFDV;
  const float* qb = q + bh * lq * D;
  const float* kb = k + bh * lk * D;
  const float* vb = v + bh * lk * D;

  for (int c = tid; c < kFQ * D; c += kFQ) {
    const int r = c / D, d = c % D;
    qt[d * kFQ + r] = (q0 + r < lq) ? qb[(size_t)(q0 + r) * D + d] : 0.f;
  }
  float acc[kFDV];
#pragma unroll
  for (int c = 0; c < kFDV; ++c) acc[c] = 0.f;
  float m_run = kNegBig, l_run = 0.f;
  const int qrow = q0 + tid;

  for (int kt = 0; kt < lk; kt += kFK) {
    __syncthreads();
    for (int c = tid; c < kFK * D; c += kFQ) {
      const int r = c / D, d = c % D;
      ks[c] = (kt + r < lk) ? kb[(size_t)(kt + r) * D + d] : 0.f;
    }
    for (int c = tid; c < kFK * kFDV; c += kFQ) {
      const int r = c / kFDV, d = c % kFDV;
      vs[c] = (kt + r < lk) ? vb[(size_t)(kt + r) * D + d0 + d] : 0.f;
    }
    __syncthreads();

    float s[kFK];
#pragma unroll
    for (int j = 0; j < kFK; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qt[d * kFQ + tid];
#pragma unroll
      for (int j = 0; j < kFK; ++j) s[j] = fmaf(qv, ks[j * D + d], s[j]);
    }
    float m_new = m_run;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      const int key = kt + j;
      float x = s[j] * scale_log2;
      if (key >= lk) {
        x = -INFINITY;
      } else if (bias != nullptr && qrow < lq) {
        x += bias[(size_t)qrow * lk + key] * kLog2e;
      }
      s[j] = x;
      m_new = fmaxf(m_new, x);
    }
    const float alpha = exp2f(m_run - m_new);
    m_run = m_new;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      s[j] = exp2f(s[j] - m_new);
      rsum += s[j];
    }
    l_run = l_run * alpha + rsum;
#pragma unroll
    for (int c = 0; c < kFDV; ++c) {
      float a = acc[c] * alpha;
#pragma unroll
      for (int j = 0; j < kFK; ++j) a = fmaf(s[j], vs[j * kFDV + c], a);
      acc[c] = a;
    }
  }
  if (qrow < lq) {
    float* orow = o + (bh * lq + qrow) * D + d0;
#pragma unroll
    for (int c = 0; c < kFDV; ++c) orow[c] = acc[c] / l_run;
  }
}

template <bool kBias>
cudaError_t launch_d512(const void* q, const void* k, const void* v, const float* bias, void* o,
                        void* workspace, int bh, int lq, int lk, float scale_log2,
                        cudaStream_t stream) {
  const int splits = d512_splits(bh, lq, lk);
  if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int lens[3] = {lq, lk, lk};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[3] = {kXD, static_cast<cuuint64_t>(lens[i]), static_cast<cuuint64_t>(bh)};
    const cuuint64_t strides[2] = {kXD * 2ull, static_cast<cuuint64_t>(lens[i]) * kXD * 2ull};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(i == 0 ? kXQ : kXK), 1};
    cudaError_t err =
        make_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptrs[i], dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  auto kernel = flash_d512_kernel<kBias>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kXSmem);
  if (err != cudaSuccess) return err;
  const int ntiles = ceil_div(lk, kXK);
  float* part_o = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  float* part_ml = splits > 1 ? part_o + static_cast<size_t>(splits) * bh * lq * kXD : nullptr;
  dim3 grid(ceil_div(lq, kXQ), bh, splits);
  kernel<<<grid, kWThreads, kXSmem, stream>>>(maps[0], maps[1], maps[2], bias,
                                              static_cast<__nv_bfloat16*>(o), part_o, part_ml, lq,
                                              lk, ceil_div(ntiles, splits), scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  flash_d512_combine_kernel<<<bh * lq, 128, 0, stream>>>(part_o, part_ml,
                                                        static_cast<__nv_bfloat16*>(o), bh * lq, splits);
  return cudaGetLastError();
}

template <int D, bool kBias>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* bias, void* o,
                         int bh, int lq, int lk, float scale_log2, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int lens[3] = {lq, lk, lk};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(lens[i]), static_cast<cuuint64_t>(bh)};
    const cuuint64_t strides[2] = {D * 2ull, static_cast<cuuint64_t>(lens[i]) * D * 2ull};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(i == 0 ? kWQ : kWK), 1};
    cudaError_t err =
        make_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptrs[i], dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  constexpr int smem = wgmma_smem_bytes<D>();
  auto kernel = flash_wgmma_kernel<D, kBias>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(lq, kWQ), bh);
  kernel<<<grid, kWThreads, smem, stream>>>(maps[0], maps[1], maps[2], bias,
                                            static_cast<__nv_bfloat16*>(o), lq, lk, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_wgmma(const void* q, const void* k, const void* v, const float* bias,
                              void* o, int bh, int lq, int lk, float scale_log2, cudaStream_t s) {
  if (bias != nullptr) return launch_wgmma<D, true>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
  return launch_wgmma<D, false>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* bias, void* o, int bh, int lq, int lk,
                       float scale_log2, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<D>();
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(lq, kFQ), bh, D / kFDV);
  kernel<<<grid, kFQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lq, lk, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdtpu

// Bytes of f32 scratch the call needs (bf16 D 512 with its keys split; 0
// otherwise).  The caller allocates it and passes it as `workspace`.
extern "C" long long sdtpu_flash_workspace_bytes(int dtype, int bh, int lq, int lk, int d) {
  using namespace sdtpu;
  if (dtype != kBF16 || d != kXD || bh <= 0 || lq <= 0 || lk <= 0) return 0;
  return static_cast<long long>(d512_workspace_bytes(bh, lq, lk));
}

// q, k, v, o: contiguous [bh, L, d] in `dtype`; bias: dense f32 [lq, lk] or
// null; workspace: sdtpu_flash_workspace_bytes of f32 scratch, or null when
// that is 0.  `scale` is the plain softmax scale (log2(e) is folded in here).
extern "C" int sdtpu_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, const float* bias, void* o, void* workspace,
                                     int bh, int lq, int lk, int d, float scale,
                                     void* stream) {
  using namespace sdtpu;
  if (bh <= 0 || lq <= 0 || lk <= 0) return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    switch (d) {
      case 64: return launch_bf16_wgmma<64>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 128: return launch_bf16_wgmma<128>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 512:
        if (bias != nullptr) return launch_d512<true>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
        return launch_d512<false>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
    }
  } else if (dtype == kF32) {
    switch (d) {
      case 64: return launch_f32<64>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 128: return launch_f32<128>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 512: return launch_f32<512>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
    }
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* sdtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
