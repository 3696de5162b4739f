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
// bf16, D = 512 (the VAE mid-block): `flash_bf16_kernel`, the first form:
// synchronous tile loads, mma.sync m16n8k16, 4 warps x 16 query rows, fixed
// at D = 512; a register accumulator of 16 x 512 per warp does not fit, so
// the grid gains a third axis that tiles the output head dim into 128-wide
// slices, each block recomputing the scores over the full D.  Its redesign
// is queued.
//
// The f32 kernel is the parity variant: plain FMA arithmetic, one thread per
// query row, Q stored transposed in shared memory.  It is slow by design.
#include "common.cuh"

#include <math.h>

namespace sdtpu {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;

// ------------------------------------------- bf16 D 512: mma.sync, first form

constexpr int kBQ = 64;    // query rows per block: 4 warps x 16 rows
constexpr int kBK = 64;    // keys per tile
constexpr int kPad = 8;    // bf16 row padding (16 bytes): conflict-free fragments
constexpr int kThreads = 128;
constexpr int kD512 = 512;  // head dim
constexpr int kDV = 128;    // output head-dim slice per block (grid z: kD512 / kDV)
constexpr int kBf16Smem = (kBQ * (kD512 + kPad) + kBK * (kD512 + kPad) + kDV * (kBK + kPad)) * 2;

__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ o, int lq, int lk,
                  float scale_log2) {
  constexpr int D = kD512, DV = kDV;
  constexpr int QS = D + kPad;   // row stride of the Q and K tiles
  constexpr int VS = kBK + kPad; // row stride of the transposed V tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBQ * QS;
  __nv_bfloat16* vt = ks + kBK * QS;  // [DV][VS]: V tile transposed

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const int d0 = blockIdx.z * DV;
  const __nv_bfloat16* qb = q + bh * lq * D;
  const __nv_bfloat16* kb = k + bh * lk * D;
  const __nv_bfloat16* vb = v + bh * lk * D;

  constexpr int CH = D / 8;  // 16-byte chunks per Q/K row
  for (int c = tid; c < kBQ * CH; c += kThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < lq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + col);
    *reinterpret_cast<uint4*>(qs + r * QS + col) = val;
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {kNegBig, kNegBig};
  float l_run[2] = {0.f, 0.f};
  const int row_w = warp * 16 + g;  // this thread's rows: row_w and row_w + 8

  for (int kt = 0; kt < lk; kt += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int c = tid; c < kBK * CH; c += kThreads) {
      const int r = c / CH, col = (c % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kt + r < lk) val = *reinterpret_cast<const uint4*>(kb + (size_t)(kt + r) * D + col);
      *reinterpret_cast<uint4*>(ks + r * QS + col) = val;
    }
    constexpr int CHV = DV / 8;
    for (int c = tid; c < kBK * CHV; c += kThreads) {
      const int r = c / CHV, col = (c % CHV) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kt + r < lk)
        val = *reinterpret_cast<const uint4*>(vb + (size_t)(kt + r) * D + d0 + col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(col + i) * VS + r] = e[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys, f32.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = qs + row_w * QS + kk + tq * 2;
      const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * QS), ld_u32(qa + 8),
                             ld_u32(qa + 8 * QS + 8)};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const __nv_bfloat16* kp = ks + (j * 8 + g) * QS + kk + tq * 2;
        const uint32_t b[2] = {ld_u32(kp), ld_u32(kp + 8)};
        mma_bf16_16816(s[j], a, b);
      }
    }

    // Scale into log2 units, add the bias, mask keys past Lk.
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + j * 8 + tq * 2 + (e & 1);
        const int qrow = q0 + row_w + ((e & 2) ? 8 : 0);
        float x = s[j][e] * scale_log2;
        if (key >= lk) {
          x = -INFINITY;
        } else if (bias != nullptr && qrow < lq) {
          x += bias[(size_t)qrow * lk + key] * kLog2e;
        }
        s[j][e] = x;
      }
    }

    // Online softmax; a row's 64 scores are spread over the 4 threads of a quad.
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      alpha[h] = exp2f(m_run[h] - m_new[h]);
      m_run[h] = m_new[h];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_new[e >> 1]);
        s[j][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + rsum[h];
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // acc += P V: the S accumulator layout of two adjacent 8-key tiles is the
    // A-operand layout of one 16-key step, so P never leaves registers.
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int jd = 0; jd < DV / 8; ++jd) {
        const __nv_bfloat16* vp = vt + (jd * 8 + g) * VS + kc * 16 + tq * 2;
        const uint32_t b[2] = {ld_u32(vp), ld_u32(vp + 8)};
        mma_bf16_16816(acc[jd], a, b);
      }
    }
  }

  __nv_bfloat16* ob = o + bh * lq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qrow = q0 + row_w + h * 8;
    if (qrow >= lq) continue;
#pragma unroll
    for (int jd = 0; jd < DV / 8; ++jd) {
      const int col = d0 + jd * 8 + tq * 2;
      __nv_bfloat162 pair = __floats2bfloat162_rn(acc[jd][2 * h] / l_run[h],
                                                  acc[jd][2 * h + 1] / l_run[h]);
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qrow * D + col) = pair;
    }
  }
}

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
          wgmma_m64n128k16_bf16_rs_tb(acc, pa[kc], dv, 1);
        } else {
          wgmma_m64n64k16_bf16_rs_tb(acc, pa[kc], dv, 1);
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

cudaError_t launch_bf16_d512(const void* q, const void* k, const void* v,
                             const float* bias, void* o, int bh, int lq, int lk,
                             float scale_log2, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16Smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(lq, kBQ), bh, kD512 / kDV);
  flash_bf16_kernel<<<grid, kThreads, kBf16Smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(o),
      lq, lk, scale_log2);
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

// q, k, v, o: contiguous [bh, L, d] in `dtype`; bias: dense f32 [lq, lk] or
// null.  `scale` is the plain softmax scale (log2(e) is folded in here).
extern "C" int sdtpu_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, const float* bias, void* o,
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
      case 512: return launch_bf16_d512(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
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
