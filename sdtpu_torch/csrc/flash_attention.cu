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
// bf16, D = 80 and 160 (the SD1.5 UNet: 8 heads over 640 and 1280
// channels; self-attention over 1024 and 256 latent tokens at 512^2 and
// cross-attention over CLIP's 77): the same kernel, the head dim padded to
// whole 64-column swizzle blocks (128, 192) in shared memory only.  The TMA
// maps keep the true D as their innermost extent (row strides of 160 and
// 320 bytes, multiples of 16) and load 64-column boxes, so TMA fills the
// columns past D with zeros; Q K^T skips the k16 steps that are all zeros
// (5 and 10 of them run), P V computes the padded width (1.6x and 1.2x the
// work) and the store writes D columns.  D 160 takes 64-key tiles
// (m64n64k16 scores, P V m64n192k16): a 128-key two-stage ring of 192
// columns would need 240 KB of shared memory.  The cross-attention calls
// (77 keys) and the D 160 calls over 256 and 64 tokens are a few
// microseconds of work or bytes.
//
// bf16, D = 40 (the UNet's 320-channel levels, the self-attention [2, 8,
// 4096, 4096, 40] and the 77-key cross-attention): `flash_d40_kernel`.
// Its floor is the exponential, not the tensor cores: 2 * 8 * 4096^2 =
// 2.68e8 ex2 at the 16 a clock of each SM's MUFU take ~0.064 ms at 132 SMs
// and 1.98 GHz, against 0.043 ms for 4 * 16 * 4096^2 * 40 = 42.9 GFLOP at
// 989 TFLOP/s and 0.0063 ms of bytes.  The D 64 design ran the products
// and the softmax of a warpgroup in series (0.207 ms against SDPA's
// 0.170).  What this one does, found on an H100 with clock64() stamps a
// phase and with trial builds that each dropped one unit's work: (1) with
// two consumer warpgroups a step is a chain of K/V wait, wgmma issue,
// softmax and bf16 pack, and dropping the exponentials, either product or
// the per-step K/V loads left the time within about a tenth: no unit
// bounds it, the chain's latency does.  So the block runs three consumer
// warpgroups of 64 rows (a 192-row Q tile, 160 registers a thread, as
// FlashAttention-3 does at small head dims) instead of two, a fifth
// faster although 22 Q tiles a head fill 2.67 waves.  Two stay where the
// grid of 192-row tiles would leave SMs idle, and for the biased form (a
// 512-thread block caps the compiler at 128 registers, and its bias loads
// spilled).  (2) Within a warpgroup, step t
// issues S(t) = Q K(t)^T and P(t-1) V(t-1) together, waits for S(t) alone
// and runs its exponentials in place in the score registers; only the bf16
// packing of P(t) waits for the P V (one P register set: with two, ptxas
// gave both the same registers and waited for the P V before the
// softmax), and O's rescale for P(t) is applied just before P(t) V(t) is
// issued, as in FlashAttention-3.  K and V have three-stage rings of their
// own, so K(t) is released as soon as S(t) is done.  (3) The consumer
// warpgroups take turns issuing their wgmmas under named barriers, round
// robin, so one's exponentials run under another's products.  (4) The
// running max is taken on the raw scores and the scale enters the
// exponent's FFMA, 2^(s * scale - m * scale), with no separate scaling
// pass, and each thread keeps its own share of the row sum until the end.
// (5) P V is wgmma m64n40k16 on the V tile as TMA lands it (64-column
// swizzle rows, of which N = 40 are read): 20 accumulator floats a thread
// instead of 32, 1.6x less work than the padded n = 64.  Q K^T contracts
// over 48 columns (three k16 steps, the 8 past D zeros by TMA).  Tried and
// dropped: a quarter of the exponentials on the FMA pipe (a degree-3
// polynomial; slower) and a four-stage ring (no change).
//
// bf16, D = 512 (the VAE mid-block, one head over a 64 x 64 latent tile,
// Lq = Lk = 4096): `flash_wide_kernel<512>`, replacing the same four TPU kernels
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
// `flash_combine_kernel` merges them.  Ragged edges, the last-tile
// mask, the bias template and the exp2 units are as in the D 64/128 kernel.
//
// bf16, D = 320 (SDXS-0.9's 320-channel level as one head: the self-
// attention [B, 1, 4096, 4096, 320] and the cross-attention over
// OpenCLIP-H's 77 tokens at 512^2): the same kernel, `flash_wide_kernel<D>`
// with the head dim as its template parameter.  A 64 x 320 f32 accumulator
// would be 160 registers a thread in one warpgroup, so the two consumer
// warpgroups split the head dim as at 512.  320 columns are five 64-column
// atoms of the 128-byte swizzle, so the head dim is padded to 384 in shared
// memory only (six column blocks, as D 80 / 160 pad to 128 / 192): the
// output halves are 192 columns (P V as wgmma m64n192k16, register A), but
// the scores' contraction splits at 160, inside the third block -- a k16
// step is 32 bytes of a swizzle row, so a descriptor may start there -- and
// each warpgroup runs ten k16 steps, no zero columns.  The sixth block is
// never loaded: only the accumulator's columns 320-383 read it, and they
// are never stored.  So the products are 320 + 384 columns, 1.1x the work
// of D, where the 64-byte swizzle's m64n160 halves would need a second
// descriptor layout for one head dim.  What bounds it: [1, 1, 4096, 4096,
// 320] is 21.5 GFLOP, 0.0217 ms at 989 TFLOP/s, against 0.0031 ms of bytes.
// Its 64 Q tiles are under half of 132 SMs, so the keys split as at 512.
//
// float32, D = 40, 64, 80, 128, 160, 320 and 512 (the default float32
// pipeline: FLUX joint attention at D 128, the SD1.5 UNet at D 40, 80 and
// 160, SDXS-0.9's wide head at D 320, CLIP-L's causal attention at D 64,
// the VAE mid-block at D 512):
// `flash_f32_kernel<D, kBias>`.  The reference runs float32 at
// Precision.HIGHEST (sdtpu/ops/flash_attention.py:68), so one TF32 pass
// (about three decimal digits) is not enough.  What bounds it: 4 * L^2 * D
// float32 operations per head, 3.47 ms at [24 heads, 4352, 128] at 67
// TFLOP/s on the FP32 pipes (NVIDIA H100 SXM data sheet, 700 W); on the
// tensor cores in 3xTF32, three TF32 products for each (495 TFLOP/s), the
// floor is 1.41 ms.  So both products run on the tensor cores in 3xTF32:
// each operand is split into big = tf32(x) and small = tf32(x - big) and
// A.B ~ As.Bb + Ab.Bs + Ab.Bb, accumulated in f32 (mma.sync m16n8k8 tf32;
// float32's accuracy to ~2^-21 of each product).  A block of eight warps
// owns a Q tile of all of D, scaled once into log2 units, and walks the
// keys in a loop, so the scores are computed once per key tile (the first
// form recomputed them for each 64-wide output slice).  K, V and the bias
// tile are staged by cp.async into a two-stage ring, the next tile's copies
// in flight under this tile's math.  Each warp owns 16 query rows; at D 64
// and 128 all of D (BQ = 128 rows, 32-key tiles), at D 320 and 512 a
// quarter of it (BQ = 32, 16-key tiles; D 160 takes 16-key tiles too, for shared
// memory; D 40 contracts Q K^T over 48 columns, the 8 past D zeros in shared
// memory): the four quarters' partial scores are summed
// through shared memory in one order, so each warp runs the same softmax,
// and the keys split across blocks where the grid is small, merged by the
// combine kernel writing f32.  D 160 splits its keys too where the grid of
// 128-row Q tiles leaves SMs idle: the UNet's [2, 8, 256, 256, 160] call has
// 32 Q tiles for 132 SMs and ran 16 key tiles in series in each; four
// splits give 128 blocks of four.  S = Q K^T reads Q and K with 16-byte loads
// (the contraction index relabelled so one load feeds two k8 steps); P's
// accumulator fragment is its own A fragment for P V once the keys of each
// 8-key block are relabelled, and V is read a column at a time (rows padded
// so a warp's reads hit 32 banks).  Each tile's P V is summed in fresh
// accumulators and added to O with an IEEE add, and the big products keep
// accumulators apart from the cross terms: the tensor cores' adds truncate,
// and one chain over all keys read 4e-5 of the largest output at [1, 24,
// 4352, 128] against 4e-6 now.  At D 64 / 128 the whole block splits each K
// and V tile once into big (in place) and small planes, where every warp
// would split all of it again; Q and P are split as they are loaded, and at
// D 512, whose planes would not fit, everything is.  Measured with
// sdtpu_torch/tools/time_dequant.py on trees differing in these constants
// (NVIDIA H100 80GB HBM3, 700.00 W), [1, 24, 4352, 4352, 128]: 5.17-5.24 ms
// with the planes and eight warps, 6.11 without them, 5.89-5.95 / 7.15-7.23
// with four warps a block (two blocks an SM) without / with them.
#include "common.cuh"

#include <math.h>

#include <algorithm>

namespace sdtpu {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;

// ------------------------------------- bf16 D 40-160: TMA + wgmma

constexpr int kWQ = 128;        // query rows per block: two consumer warpgroups x 64
constexpr int kWStages = 2;     // K/V ring depth
constexpr int kWThreads = 384;  // warpgroups 0-1: consumers; 2: producer
constexpr int kColBytes = 128;  // a 64-element bf16 column block: one swizzle row

// The head dim a block computes on: D rounded up to whole 64-column swizzle
// blocks.  The TMA maps keep the true D as their innermost extent and load
// boxes of 64 columns, so the columns past D arrive as zeros: no padded
// copy is made in device memory, and the zero columns add nothing to Q K^T
// and leave zeros in the output columns that are never stored.
__host__ __device__ constexpr int wgmma_dp(int d) { return (d + 63) / 64 * 64; }
// Keys per K/V tile: 128, and 64 where the padded head dim is 192 (D 160),
// whose 128-key two-stage ring would need 240 KB of shared memory.
__host__ __device__ constexpr int wgmma_bk(int d) { return wgmma_dp(d) > 128 ? 64 : 128; }

template <int D>
__host__ __device__ constexpr int wgmma_smem_bytes() {
  return 1024 + kWQ * wgmma_dp(D) * 2 + 2 * kWStages * wgmma_bk(D) * wgmma_dp(D) * 2 +
         (1 + 3 * kWStages) * 8;
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ o, int lq, int lk, float scale_log2) {
  static_assert(D == 64 || D == 80 || D == 128 || D == 160,
                "the wgmma kernel takes head dims 64, 80, 128 and 160 (D 40: flash_d40_kernel)");
  static_assert(wgmma_smem_bytes<D>() <= 232448, "bf16 flash: shared memory over 227 KB");
  constexpr int DP = wgmma_dp(D);              // head-dim columns computed: 64, 128 or 192
  constexpr int kWK = wgmma_bk(D);             // keys per K/V tile
  constexpr int CB = DP / 64;                  // column blocks per row
  constexpr int KS = (D + 15) / 16;            // k16 steps of Q K^T (all-zero steps skipped)
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
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegBig, kNegBig};
    float l_run[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kWStages;
      const uint32_t par = (t / kWStages) & 1;
      const int kt = t * kWK;

      // S = Q K^T: 64 rows x kWK keys, f32, as sc[4j + e] like acc
      float sc[kWK / 2];
      mbar_wait(k_full(s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = (kk / 4) * kQBlock + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * kKVBlock + (kk % 4) * 32;
        const uint64_t dq = smem_desc_sw128(q_base + q_rows + off, 16, 1024);
        const uint64_t dk = smem_desc_sw128(k_base + s * kKVBytes + koff, 16, 1024);
        if constexpr (kWK == 128) {
          wgmma_m64n128k16_bf16_ss(sc, dq, dk, kk > 0);
        } else {
          wgmma_m64n64k16_bf16_ss(sc, dq, dk, kk > 0);
        }
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

      // online softmax; a row's kWK scores are spread over the 4 threads of a quad
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
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: B = the V tile [keys][DP], read MN-major (D contiguous)
      mbar_wait(v_full(s), par);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kWK / 16; ++kc) {
        const uint64_t dv = smem_desc_sw128(v_base + s * kKVBytes + kc * 16 * kColBytes, kKVBlock, 1024);
        if constexpr (DP == 192) {
          wgmma_m64n192k16_bf16_rs<1>(acc, pa[kc], dv, 1);
        } else if constexpr (DP == 128) {
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

// ------------------------------------ bf16 D 40: the exponential-bound form

// WG consumer warpgroups of 64 query rows each (3, or 2: launch_wgmma
// picks), and a producer warpgroup.
__host__ __device__ constexpr int d40_rows(int wg) { return 64 * wg; }  // Q rows a block
__host__ __device__ constexpr int d40_threads(int wg) { return 128 * (wg + 1); }
constexpr int kEK = 128;      // keys per K/V tile
constexpr int kEStages = 3;   // K ring and V ring depth
constexpr int kED = 40;       // head dim
constexpr int kEN = 40;       // P V's N: the head dim itself (wgmma takes N in steps of 8)
constexpr int kEKS = 3;       // k16 steps of Q K^T: 48 columns, the 8 past D zeros
constexpr int kETile = kEK * kColBytes;  // one K or V tile: 128 rows of one 64-column block
__host__ __device__ constexpr int d40_smem(int wg) {
  return 1024 + d40_rows(wg) * kColBytes + 2 * kEStages * kETile + (1 + 4 * kEStages) * 8;
}
static_assert(d40_smem(3) <= 232448, "D 40 flash: shared memory over 227 KB");

// Shared-memory addresses and the launch's scalars, as one consumer
// warpgroup of flash_d40_kernel sees them.
struct D40Args {
  uint32_t q_rows, k_base, v_base, bars;
  const float* bias;
  int lq, lk, q0, row_w, tq, lane;
  float scale_log2, sl;  // sl: the exponent's scale (scale_log2, or 1 with a bias)
};

// One consumer warpgroup's running state: O (64 rows x 40 columns), and per
// row the running max (raw scores; log2 units with a bias) and this thread's
// share of the running sum (its 32 of the tile's 128 keys; the quad's four
// shares are added once, at the end).
struct D40State {
  float acc[kEN / 2];  // acc[4j + e]: row row_w (+8 for e >= 2), column 8j + 2tq (+1 for odd e)
  float m_run[2], l_run[2];
};

__device__ __forceinline__ uint32_t d40_bar(const D40Args& a, int i) { return a.bars + 8 * i; }
// barriers: 0 q_full; then k_full, v_full, k_empty, v_empty, kEStages each
__device__ __forceinline__ uint32_t d40_k_full(const D40Args& a, int s) { return d40_bar(a, 1 + s); }
__device__ __forceinline__ uint32_t d40_v_full(const D40Args& a, int s) { return d40_bar(a, 1 + kEStages + s); }
__device__ __forceinline__ uint32_t d40_k_empty(const D40Args& a, int s) { return d40_bar(a, 1 + 2 * kEStages + s); }
__device__ __forceinline__ uint32_t d40_v_empty(const D40Args& a, int s) { return d40_bar(a, 1 + 3 * kEStages + s); }

// Wait until K(t) / V(t) has landed.
__device__ __forceinline__ void d40_wait_k(const D40Args& a, int t) {
  mbar_wait(d40_k_full(a, t % kEStages), (t / kEStages) & 1);
}
__device__ __forceinline__ void d40_wait_v(const D40Args& a, int t) {
  mbar_wait(d40_v_full(a, t % kEStages), (t / kEStages) & 1);
}

// S(t) = Q K(t)^T, 64 rows x 128 keys, issued and committed (not waited on).
__device__ __forceinline__ void d40_issue_s(const D40Args& a, int t, float (&sc)[kEK / 2]) {
  const int s = t % kEStages;
#pragma unroll
  for (int kk = 0; kk < kEKS; ++kk)
    wgmma_m64n128k16_bf16_ss(sc, smem_desc_sw128(a.q_rows + kk * 32, 16, 1024),
                             smem_desc_sw128(a.k_base + s * kETile + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// O += P(t) V(t): B = the V tile read MN-major, its first 40 columns.
__device__ __forceinline__ void d40_issue_pv(const D40Args& a, D40State& st, int t,
                                             const uint32_t (&p)[kEK / 16][4]) {
  const int s = t % kEStages;
#pragma unroll
  for (int kc = 0; kc < kEK / 16; ++kc)
    wgmma_m64n40k16_bf16_rs<1>(
        st.acc, p[kc], smem_desc_sw128(a.v_base + s * kETile + kc * 16 * kColBytes, kETile, 1024), 1);
  wgmma_commit();
}

// The online softmax of S(t), in place: sc becomes P(t) in f32, and alpha
// the factor that rescales O for it.  The max is taken on the raw scores
// and the scale enters the exponent's FFMA: p = 2^(s sl - m sl).
template <bool kBias>
__device__ __forceinline__ void d40_softmax(const D40Args& a, D40State& st, int t, float (&sc)[kEK / 2],
                                            float (&alpha)[2]) {
  const int kt = t * kEK;
  if constexpr (kBias) {
    // the bias is in natural-log units: scores into log2 units first
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qrow = a.q0 + a.row_w + 8 * h;
      const float* brow = a.bias + static_cast<size_t>(min(qrow, a.lq - 1)) * a.lk;
#pragma unroll
      for (int j = 0; j < kEK / 8; ++j) {
        const int key = kt + j * 8 + 2 * a.tq;
        const float b0 = key < a.lk ? brow[key] : 0.f, b1 = key + 1 < a.lk ? brow[key + 1] : 0.f;
        sc[4 * j + 2 * h] = fmaf(sc[4 * j + 2 * h], a.scale_log2, b0 * kLog2e);
        sc[4 * j + 2 * h + 1] = fmaf(sc[4 * j + 2 * h + 1], a.scale_log2, b1 * kLog2e);
      }
    }
  }
  if (kt + kEK > a.lk) {
#pragma unroll
    for (int j = 0; j < kEK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kt + j * 8 + 2 * a.tq + (e & 1) >= a.lk) sc[4 * j + e] = -INFINITY;
  }
  // the max and the sum in four independent chains a row (latency, not
  // issue slots, bounds one long chain)
  float mx[2][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) mx[e >> 1][(e & 1) * 2] = mx[e >> 1][(e & 1) * 2 + 1] = sc[e];
#pragma unroll
  for (int j = 1; j < kEK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1][(e & 1) * 2 + (j & 1)] = fmaxf(mx[e >> 1][(e & 1) * 2 + (j & 1)], sc[4 * j + e]);
  float m_new[2], ms[2], rs[2][4] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_new[h] = fmaxf(fmaxf(st.m_run[h], fmaxf(mx[h][0], mx[h][1])), fmaxf(mx[h][2], mx[h][3]));
    m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
    m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
    alpha[h] = ex2_approx((st.m_run[h] - m_new[h]) * a.sl);
    st.m_run[h] = m_new[h];
    ms[h] = m_new[h] * a.sl;
  }
#pragma unroll
  for (int j = 0; j < kEK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = ex2_approx(fmaf(sc[4 * j + e], a.sl, -ms[e >> 1]));
      rs[e >> 1][(j & 1) * 2 + (e & 1)] += sc[4 * j + e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    st.l_run[h] = fmaf(st.l_run[h], alpha[h], (rs[h][0] + rs[h][1]) + (rs[h][2] + rs[h][3]));
}

// P(t) in bf16, in the register-A layout of P V's k16 steps: the S columns
// of two neighbouring 8-key chunks are one A fragment.
__device__ __forceinline__ void d40_pack(const float (&sc)[kEK / 2], uint32_t (&p)[kEK / 16][4]) {
#pragma unroll
  for (int j = 0; j < kEK / 8; ++j) {
    p[j / 2][(j & 1) * 2 + 0] = pack_bf16x2(sc[4 * j + 0], sc[4 * j + 1]);
    p[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// The warpgroups take turns issuing their wgmmas, round robin (named
// barrier 1 + w: warpgroup w waits on it, then lets the next go), so one
// warpgroup's exponentials run while another's products do.
__device__ __forceinline__ void d40_my_turn(int wg) { named_bar_sync(1 + wg, 256); }
template <int WG>
__device__ __forceinline__ void d40_your_turn(int wg) { named_bar_arrive(1 + (wg + 1) % WG, 256); }

// Step t >= 1: rescale O for P(t-1), issue S(t) and P(t-1) V(t-1), wait for
// S(t) alone and run its softmax under the P V, then wait for the P V and
// pack P(t) into the registers it read.
template <bool kBias, int WG>
__device__ __forceinline__ void d40_step(const D40Args& a, D40State& st, int wg, int t,
                                         uint32_t (&p)[kEK / 16][4], float (&alpha)[2]) {
  float sc[kEK / 2];
  d40_wait_k(a, t);
  d40_wait_v(a, t - 1);
  d40_my_turn(wg);
#pragma unroll
  for (int i = 0; i < kEN / 2; ++i) st.acc[i] *= alpha[(i >> 1) & 1];
  wgmma_fence();
  d40_issue_s(a, t, sc);
  d40_issue_pv(a, st, t - 1, p);
  d40_your_turn<WG>(wg);
  wgmma_wait<1>();
  fence_regs(sc);
  if (a.lane == 0) mbar_arrive(d40_k_empty(a, t % kEStages));
  d40_softmax<kBias>(a, st, t, sc, alpha);
  // pinned before the wait, so the softmax stays under the P V
  fence_regs(sc);
  fence_regs(alpha);
  wgmma_wait<0>();
  fence_regs(st.acc);
  fence_regs(p);
  if (a.lane == 0) mbar_arrive(d40_v_empty(a, (t - 1) % kEStages));
  d40_pack(sc, p);
}

// A block owns a 64 * WG-row Q tile of one batch*head: warpgroup WG's
// producer thread TMA-loads Q once and 128-key K and V tiles into rings of
// their own; consumer warpgroups 0..WG-1 own 64 rows each.  Each consumer
// runs S(0) and its softmax, then d40_step for t = 1.., then the last P V.
// K(t) is released when S(t) is done, V(t) when its P V is.
template <bool kBias, int WG>
__global__ void __launch_bounds__(d40_threads(WG), 1)
flash_d40_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ o, int lq, int lk, float scale_log2) {
  constexpr int kRows = d40_rows(WG);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  D40Args a;
  a.k_base = q_base + kRows * kColBytes;
  a.v_base = a.k_base + kEStages * kETile;
  a.bars = a.v_base + kEStages * kETile;
  a.bias = bias;
  a.lq = lq;
  a.lk = lk;
  a.q0 = blockIdx.x * kRows;
  a.scale_log2 = scale_log2;
  a.sl = kBias ? 1.f : scale_log2;
  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y;
  const int ntiles = (lk + kEK - 1) / kEK;

  if (threadIdx.x == 0) {
    mbar_init(d40_bar(a, 0), 1);
    for (int s = 0; s < kEStages; ++s) {
      mbar_init(d40_k_full(a, s), 1);
      mbar_init(d40_v_full(a, s), 1);
      mbar_init(d40_k_empty(a, s), 4 * WG);  // the consumers' warps
      mbar_init(d40_v_empty(a, s), 4 * WG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == WG) {
    // producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * WG) {
      mbar_expect_tx(d40_bar(a, 0), kRows * kColBytes);
      tma_load_3d(q_base, &qmap, d40_bar(a, 0), 0, a.q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kEStages;
        const uint32_t free_par = ((t / kEStages) & 1) ^ 1;
        mbar_wait(d40_k_empty(a, s), free_par);
        mbar_expect_tx(d40_k_full(a, s), kETile);
        tma_load_3d(a.k_base + s * kETile, &kmap, d40_k_full(a, s), 0, t * kEK, bh);
        mbar_wait(d40_v_empty(a, s), free_par);
        mbar_expect_tx(d40_v_full(a, s), kETile);
        tma_load_3d(a.v_base + s * kETile, &vmap, d40_v_full(a, s), 0, t * kEK, bh);
      }
    }
  } else {
    // the registers the producer gave up: 160 a thread for three consumer
    // warpgroups, 240 for two
    setmaxnreg_inc<WG == 3 ? 160 : 240>();
    const int warp = (threadIdx.x >> 5) & 3;
    a.lane = threadIdx.x & 31;
    a.tq = a.lane & 3;
    a.row_w = wg * 64 + warp * 16 + (a.lane >> 2);  // this thread's rows: row_w, row_w + 8
    a.q_rows = q_base + wg * 64 * kColBytes;
    D40State st;
#pragma unroll
    for (int i = 0; i < kEN / 2; ++i) st.acc[i] = 0.f;
    st.m_run[0] = st.m_run[1] = kNegBig;
    st.l_run[0] = st.l_run[1] = 0.f;
    uint32_t p[kEK / 16][4];
    float alpha[2];

    if (wg == WG - 1) d40_your_turn<WG>(wg);  // warpgroup 0 issues first
    mbar_wait(d40_bar(a, 0), 0);
    {
      float sc[kEK / 2];
      d40_wait_k(a, 0);
      d40_my_turn(wg);
      wgmma_fence();
      d40_issue_s(a, 0, sc);
      d40_your_turn<WG>(wg);
      wgmma_wait<0>();
      fence_regs(sc);
      if (a.lane == 0) mbar_arrive(d40_k_empty(a, 0));
      d40_softmax<kBias>(a, st, 0, sc, alpha);  // alpha 0: O starts at 0 either way
      d40_pack(sc, p);
    }
    for (int t = 1; t < ntiles; ++t) d40_step<kBias, WG>(a, st, wg, t, p, alpha);
    // the last P V; the last warpgroup does not hand the turn on, which
    // balances the arrival that gave warpgroup 0 its first turn
    d40_wait_v(a, ntiles - 1);
    d40_my_turn(wg);
#pragma unroll
    for (int i = 0; i < kEN / 2; ++i) st.acc[i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
    d40_issue_pv(a, st, ntiles - 1, p);
    if (wg < WG - 1) d40_your_turn<WG>(wg);
    wgmma_wait<0>();
    fence_regs(st.acc);

    __nv_bfloat16* ob = o + static_cast<size_t>(bh) * lq * kED;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = st.l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qrow = a.q0 + a.row_w + 8 * h;
      if (qrow >= lq) continue;
      const float inv = 1.f / l;
#pragma unroll
      for (int j = 0; j < kED / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(qrow) * kED + j * 8 + 2 * a.tq) =
            __floats2bfloat162_rn(st.acc[4 * j + 2 * h] * inv, st.acc[4 * j + 2 * h + 1] * inv);
    }
  }
}

// ------------------------------------ bf16 D 320 and 512: TMA + wgmma

constexpr int kXQ = 64;        // query rows per block: one wgmma M tile, shared by both consumers
constexpr int kXK = 32;        // keys per K/V tile
constexpr int kXStages = 2;    // K and V ring depth
constexpr int kXD = 512;       // the VAE's head dim
constexpr int kXQBlock = kXQ * kColBytes;     // one 64-column block of the Q tile: 8 KB
constexpr int kXKVBlock = kXK * kColBytes;    // one 64-column block of a K or V tile: 4 KB
constexpr int kXSwapFloats = (kXK / 2) * 128;      // one warpgroup's partial S, 16 floats a thread
constexpr int kXMaxSplits = 16;

// The wide-head form's layout at head dim D (320 or 512): D padded to an
// even count of 64-column blocks (DP: 384, 512) in shared memory, so each
// warpgroup's output half is whole blocks; each consumer
// warpgroup contracts Q K^T over D / 2 columns and owns DP / 2 output
// columns.  Only the ceil(D / 64) blocks that hold data are loaded.
template <int D>
struct Wide {
  static_assert(D == 320 || D == kXD, "the wide-head kernel takes head dims 320 and 512");
  static constexpr int DP = (D + 127) / 128 * 128, CB = DP / 64, CBL = (D + 63) / 64;
  static constexpr int kHalf = DP / 2;           // output columns per consumer warpgroup
  static constexpr int kKS = D / 32;             // k16 steps of a warpgroup's partial Q K^T
  static constexpr int kKVBytes = CB * kXKVBlock;  // one K or V tile
  static constexpr int kSmem = 1024 + CB * kXQBlock + 2 * kXStages * kKVBytes + 2 * 2 * kXSwapFloats * 4 +
                               (1 + 4 * kXStages) * 8;
  static_assert(kSmem <= 232448, "wide-head flash: shared memory over the 227 KB a block may use");
};

// A block owns a 64-row Q tile of one batch*head and the key tiles
// [t_begin, t_end) of its split (blockIdx.z).  Warpgroup w contracts the
// partial scores over head-dim columns [w D / 2, (w + 1) D / 2) and owns
// the output columns [w DP / 2, (w + 1) DP / 2).  With one split the block
// writes the normalised bf16 output; with several it writes its f32
// accumulator and its running max / sum for the combine kernel.
template <int D, bool kBias>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ part_o,
                  float* __restrict__ part_ml, int lq, int lk, int tiles_per_split,
                  float scale_log2) {
  using W = Wide<D>;
  constexpr int CB = W::CB, CBL = W::CBL, kHalf = W::kHalf, kXKVBytes = W::kKVBytes;
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
      mbar_expect_tx(q_full, CBL * kXQBlock);
      for (int cb = 0; cb < CBL; ++cb) tma_load_3d(q_base + cb * kXQBlock, &qmap, q_full, cb * 64, q0, bh);
      for (int i = 0; i < count; ++i) {
        const int s = i % kXStages;
        const uint32_t free_par = ((i / kXStages) & 1) ^ 1;
        const int key0 = (t_begin + i) * kXK;
        mbar_wait(k_empty(s), free_par);
        mbar_expect_tx(k_full(s), CBL * kXKVBlock);
        for (int cb = 0; cb < CBL; ++cb)
          tma_load_3d(k_base + s * kXKVBytes + cb * kXKVBlock, &kmap, k_full(s), cb * 64, key0, bh);
        mbar_wait(v_empty(s), free_par);
        mbar_expect_tx(v_full(s), CBL * kXKVBlock);
        for (int cb = 0; cb < CBL; ++cb)
          tma_load_3d(v_base + s * kXKVBytes + cb * kXKVBlock, &vmap, v_full(s), cb * 64, key0, bh);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int wtid = threadIdx.x & 127;
    const int row_w = warp * 16 + g;  // this thread's rows in the tile: row_w, row_w + 8

    // acc[4j + e]: row row_w (+8 for e >= 2), column wg * kHalf + 8j + 2tq (+1 for odd e)
    float acc[kHalf / 2];
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegBig, kNegBig};
    float l_run[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int i = 0; i < count; ++i) {
      const int s = i % kXStages;
      const uint32_t par = (i / kXStages) & 1;
      const int kt = (t_begin + i) * kXK;

      // this warpgroup's half of S = Q K^T: 64 rows x 32 keys over its D / 2
      // head-dim columns (a k16 step is 32 bytes of a 128-byte swizzle row,
      // so a half may start inside a column block: D 320's second at 160),
      // as sc[4j + e] like acc
      float sc[kXK / 2];
      mbar_wait(k_full(s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W::kKS; ++kk) {
        const int col = wg * (D / 2) + 16 * kk;
        const int cb = col / 64;
        const uint32_t off = (col % 64) / 16 * 32;
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
      for (int r = 0; r < kHalf / 2; ++r) acc[r] *= alpha[(r >> 1) & 1];

      // O += P V over this warpgroup's kHalf columns: B = the V tile's
      // kHalf / 64 column blocks, read MN-major (head dim contiguous), `lbo`
      // apart.  At D 320 the last block (columns 320-383) is never loaded:
      // whatever it holds reaches only accumulator columns that are never
      // stored, since a column of P V reads only that column of V.
      mbar_wait(v_full(s), par);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kXK / 16; ++kc) {
        const uint64_t dv = smem_desc_sw128(
            v_base + s * kXKVBytes + wg * (kHalf / 64) * kXKVBlock + kc * 16 * kColBytes, kXKVBlock, 1024);
        if constexpr (kHalf == 256) {
          wgmma_m64n256k16_bf16_rs<1>(acc, pa[kc], dv, 1);
        } else {
          wgmma_m64n192k16_bf16_rs<1>(acc, pa[kc], dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(v_empty(s));
    }

    const size_t bh_rows = static_cast<size_t>(bh) * lq;
    const int col0 = wg * kHalf + 2 * tq;
    const int jn = min(kHalf, D - wg * kHalf) / 8;  // this warpgroup's stored column groups
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qrow = q0 + row_w + 8 * h;
      if (qrow >= lq) continue;
      if (part_o == nullptr) {
        const float inv = 1.f / l_run[h];
        __nv_bfloat16* orow = o + (bh_rows + qrow) * D;
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j)
          if (j < jn)
            *reinterpret_cast<__nv_bfloat162*>(orow + col0 + j * 8) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      } else {
        const size_t prow = static_cast<size_t>(blockIdx.z) * gridDim.y * lq + bh_rows + qrow;
        float* orow = part_o + prow * D;
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j)
          if (j < jn)
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
// M the largest m_s.  One block per output row, four of its D columns a
// thread; T is the output's type (bf16, or f32 for the f32 kernel).
template <typename T, int D>
__global__ void __launch_bounds__(D / 4)
flash_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                     T* __restrict__ o, int rows, int splits) {
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
    const float4 p = *reinterpret_cast<const float4*>(part_o + prow * D + c);
    acc.x += w * p.x;
    acc.y += w * p.y;
    acc.z += w * p.z;
    acc.w += w * p.w;
  }
  T* orow = o + row * D + c;
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(orow) = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  } else {
    const float inv = 1.f / l;
    *reinterpret_cast<__nv_bfloat162*>(orow) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(orow + 2) = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
}

// Key splits (blocks of `bq` query rows, key tiles of `bk`): the fewest that
// minimise the waves of the grid (ceil(blocks * s / SMs) / s), at least one
// key tile a split.  The VAE's bf16 [1, 4096] call (D 512) has 64 Q tiles on
// 132 SMs and takes two; Lq = 16384 takes one.
int key_splits(int bh, int lq, int lk, int bq, int bk) {
  const long long blocks = static_cast<long long>(ceil_div(lq, bq)) * bh;
  const int ntiles = ceil_div(lk, bk);
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

// f32 scratch of a split call: each split's unnormalised [bh, lq, D]
// output, then its running max and sum a row.
size_t split_workspace_bytes(int splits, int bh, int lq, int d) {
  if (splits == 1) return 0;
  return static_cast<size_t>(splits) * bh * lq * (d + 2) * sizeof(float);
}

// ------------------------------------------- f32: 3xTF32 on mma.sync

// Warps a block: RG row groups of 16 query rows x DS head-dim slices; BK
// keys a tile; kPresplit: K and V split into tf32 big / small planes once a
// tile, by the whole block, instead of by every warp as they are loaded.
// D 512 splits the head dim four ways (a warp's 16 x 512 f32 accumulator
// would not fit its registers) and shares S through shared memory; D 64 /
// 128 give each warp all of D.
template <int D>
struct F32Cfg;
template <>
struct F32Cfg<64> {
  static constexpr int RG = 8, DS = 1, BK = 32;
  static constexpr bool kPresplit = true;
};
template <>
struct F32Cfg<128> {
  static constexpr int RG = 8, DS = 1, BK = 32;
  static constexpr bool kPresplit = true;
};
// the SD1.5 UNet's head dims (8 heads over 320, 640 and 1280 channels)
template <>
struct F32Cfg<40> {
  static constexpr int RG = 8, DS = 1, BK = 32;
  static constexpr bool kPresplit = true;
};
template <>
struct F32Cfg<80> {
  static constexpr int RG = 8, DS = 1, BK = 32;
  static constexpr bool kPresplit = true;
};
// 16-key tiles: with 32 the biased form's two stages and planes would need
// 255 KB; a warp holds all 160 columns (80 accumulator floats a lane)
template <>
struct F32Cfg<160> {
  static constexpr int RG = 8, DS = 1, BK = 16;
  static constexpr bool kPresplit = true;
};
// SDXS-0.9's one head of 320: a quarter of the head dim a warp, as at 512
template <>
struct F32Cfg<320> {
  static constexpr int RG = 2, DS = 4, BK = 16;
  static constexpr bool kPresplit = false;
};
template <>
struct F32Cfg<512> {
  static constexpr int RG = 2, DS = 4, BK = 16;
  static constexpr bool kPresplit = false;
};

// Shared-memory layout, in floats.  Q K^T contracts over DK, D rounded up
// to the 16 of a pair of k8 steps (48 at D 40): the columns past D are
// zeros in shared memory, written once.  Q and K rows are QS apart, the
// least width >= DK that is 16 modulo 32 (a row start moves 64 bytes
// modulo 128, so the 16-byte fragment loads of two rows that one
// quarter-warp makes fall in different banks: 48, 80, 80, 144, 176 and 528
// at D 40, 64, 80, 128, 160 and 512); V rows D + 4 (the column reads of
// one warp, keys 2t and 2t + 1 at 8 dims, hit 32 different banks: 2 (D + 4)
// is 8 or 24 modulo 32 at every D); bias rows BK + 8 (its 8-byte reads by
// row pairs).
template <int D, bool kBias>
struct F32Smem {
  using C = F32Cfg<D>;
  static constexpr int kThreads = 32 * C::RG * C::DS;
  static constexpr int BQ = 16 * C::RG, BK = C::BK;
  static constexpr int DK = (D + 15) / 16 * 16;
  static constexpr int QS = DK + (48 - DK % 32) % 32, VS = D + 4, BS = BK + 8;
  static_assert(C::DS == 1 || DK == D, "a head-dim split needs D a multiple of 16");
  static constexpr int kQ = BQ * QS;
  static constexpr int kStage = BK * QS + BK * VS + (kBias ? BQ * BS : 0);
  static constexpr int kSmall = C::kPresplit ? BK * QS + BK * VS : 0;  // the small planes
  static constexpr int kSwap = C::DS > 1 ? C::RG * C::DS * 16 * BK : 0;
  static constexpr int kBytes = (kQ + 2 * kStage + kSmall + kSwap) * 4;
  static_assert(kBytes <= 232448, "f32 flash: shared memory over the 227 KB a block may use");
};

// A block owns BQ query rows of one batch*head (all of D) and the key tiles
// [t_begin, t_begin + tiles_per_split) of its split (blockIdx.z); warp w
// owns rows 16 (w / DS).. and head-dim columns (w % DS) * D / DS ...  With
// one split the block writes the normalised f32 output; with several its
// f32 accumulator and running max / sum for the combine kernel.
template <int D, bool kBias>
__global__ void __launch_bounds__(F32Smem<D, kBias>::kThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ part_o, float* __restrict__ part_ml,
                 int lq, int lk, int tiles_per_split, float scale_log2) {
  using C = F32Cfg<D>;
  using L = F32Smem<D, kBias>;
  constexpr int DS = C::DS, BK = C::BK, BQ = L::BQ, DW = D / DS, kFThreads = L::kThreads;
  constexpr int QS = L::QS, VS = L::VS, BS = L::BS;
  constexpr int KW = DS == 1 ? L::DK : DW;  // a warp's contraction width in Q K^T
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                     // [BQ][QS]: Q * scale * log2(e)
  float* stages = qs + L::kQ;          // two of: K [BK][QS], V [BK][VS], bias [BQ][BS]
  float* small = stages + 2 * L::kStage;  // kPresplit: K, V small planes (the stage holds big)
  float* swap = small + L::kSmall;       // DS > 1: [RG][DS][BK / 2][32] partial scores
  auto ks = [&](int st) { return stages + st * L::kStage; };
  auto vs = [&](int st) { return stages + st * L::kStage + BK * QS; };
  auto bsm = [&](int st) { return stages + st * L::kStage + BK * (QS + VS); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp / DS, ds = warp % DS;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const int ntiles = (lk + BK - 1) / BK;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int count = min(ntiles, t_begin + tiles_per_split) - t_begin;  // >= 1 by the launcher
  const float* qb = q + bh * lq * D;
  const float* kb = k + bh * lk * D;
  const float* vb = v + bh * lk * D;

  // K, V (and bias) of key tile t into stage st: 16-byte copies, zeros past Lk / Lq
  auto load_tile = [&](int t, int st) {
    const int kt = t * BK;
    for (int c = tid; c < BK * D / 4; c += kFThreads) {
      const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
      const bool ok = kt + r < lk;
      const size_t off = ok ? static_cast<size_t>(kt + r) * D + c4 : 0;
      cp_async_16(smem_u32(ks(st) + r * QS + c4), kb + off, ok);
      cp_async_16(smem_u32(vs(st) + r * VS + c4), vb + off, ok);
    }
    if constexpr (kBias) {
      for (int c = tid; c < BQ * BK; c += kFThreads) {
        const int r = c / BK, j = c % BK;
        const bool ok = q0 + r < lq && kt + j < lk;
        const size_t off = ok ? static_cast<size_t>(q0 + r) * lk + kt + j : 0;
        cp_async_4(smem_u32(bsm(st) + r * BS + j), bias + off, ok);
      }
    }
    cp_async_commit();
  };
  load_tile(t_begin, 0);

  if constexpr (L::DK > D) {
    // the zero columns past D of Q, of both K stages and of the K small
    // plane; the copies and the split write columns below D only
    constexpr int P = L::DK - D, kRows = BQ + (C::kPresplit ? 3 : 2) * BK;
    for (int c = tid; c < kRows * P; c += kFThreads) {
      const int r = c / P, j = D + c % P;
      float* row = r < BQ            ? qs + r * QS
                   : r < BQ + BK     ? ks(0) + (r - BQ) * QS
                   : r < BQ + 2 * BK ? ks(1) + (r - BQ - BK) * QS
                                     : small + (r - BQ - 2 * BK) * QS;
      row[j] = 0.f;
    }
  }

  // Q once, scaled into log2 units (the first tile's barrier publishes it)
  for (int c = tid; c < BQ * D / 4; c += kFThreads) {
    const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < lq) x = *reinterpret_cast<const float4*>(qb + static_cast<size_t>(q0 + r) * D + c4);
    *reinterpret_cast<float4*>(qs + r * QS + c4) =
        make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2, x.w * scale_log2);
  }

  // acc[4nb + e]: row g (+8 for e >= 2), column ds * DW + 8nb + 2tq (+1 for odd e)
  float acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegBig, kNegBig};
  float l_run[2] = {0.f, 0.f};
  const float* qrow = qs + (rg * 16 + g) * QS + ds * DW + 4 * tq;

  for (int i = 0; i < count; ++i) {
    const int st = i & 1;
    if (i + 1 < count) {
      load_tile(t_begin + i + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kt = (t_begin + i) * BK;
    if constexpr (C::kPresplit) {
      // split K and V once for the block: big in place, small beside
      for (int c = tid; c < BK * D / 4; c += kFThreads) {
        const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
        float* kp = ks(st) + r * QS + c4;
        float* vp = vs(st) + r * VS + c4;
        float* kq = small + r * QS + c4;
        float* vq = small + BK * QS + r * VS + c4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 x = *reinterpret_cast<float4*>(h ? vp : kp);
          uint4 b, sm;
          split_tf32(x.x, b.x, sm.x);
          split_tf32(x.y, b.y, sm.y);
          split_tf32(x.z, b.z, sm.z);
          split_tf32(x.w, b.w, sm.w);
          *reinterpret_cast<uint4*>(h ? vp : kp) = b;
          *reinterpret_cast<uint4*>(h ? vq : kq) = sm;
        }
      }
      __syncthreads();
    }

    // S = Q K^T over this warp's DW columns, 16 rows x BK keys, as sc[4j + e]
    // like acc.  The contraction index is relabelled so one 16-byte load
    // feeds two k8 steps: in the pair of steps 2p, 2p + 1, lane slot t holds
    // d = 16p + 4t (+2 in the second) and slot t + 4 the d after it, in A (Q)
    // and B (K) alike.
    float sc[BK / 2], sx[BK / 2];  // the big products' sums and the cross terms'
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) sc[r] = sx[r] = 0.f;
    const float* krow = ks(st) + g * QS + ds * DW + 4 * tq;
#pragma unroll
    for (int p = 0; p < KW / 16; ++p) {
      const float4 qa = *reinterpret_cast<const float4*>(qrow + 16 * p);
      const float4 qc = *reinterpret_cast<const float4*>(qrow + 8 * QS + 16 * p);
      uint32_t ab[2][4], as[2][4];
      split_tf32(qa.x, ab[0][0], as[0][0]);
      split_tf32(qc.x, ab[0][1], as[0][1]);
      split_tf32(qa.y, ab[0][2], as[0][2]);
      split_tf32(qc.y, ab[0][3], as[0][3]);
      split_tf32(qa.z, ab[1][0], as[1][0]);
      split_tf32(qc.z, ab[1][1], as[1][1]);
      split_tf32(qa.w, ab[1][2], as[1][2]);
      split_tf32(qc.w, ab[1][3], as[1][3]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t bb[2][2], bs[2][2];
        if constexpr (C::kPresplit) {
          const uint4 kb4 = *reinterpret_cast<const uint4*>(krow + 8 * j * QS + 16 * p);
          const uint4 ks4 = *reinterpret_cast<const uint4*>(krow - ks(st) + small + 8 * j * QS + 16 * p);
          bb[0][0] = kb4.x, bb[0][1] = kb4.y, bb[1][0] = kb4.z, bb[1][1] = kb4.w;
          bs[0][0] = ks4.x, bs[0][1] = ks4.y, bs[1][0] = ks4.z, bs[1][1] = ks4.w;
        } else {
          const float4 kv = *reinterpret_cast<const float4*>(krow + 8 * j * QS + 16 * p);
          split_tf32(kv.x, bb[0][0], bs[0][0]);
          split_tf32(kv.y, bb[0][1], bs[0][1]);
          split_tf32(kv.z, bb[1][0], bs[1][0]);
          split_tf32(kv.w, bb[1][1], bs[1][1]);
        }
        mma_3xtf32(sc + 4 * j, sx + 4 * j, ab[0], as[0], bb[0], bs[0]);
        mma_3xtf32(sc + 4 * j, sx + 4 * j, ab[1], as[1], bb[1], bs[1]);
      }
    }
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) sc[r] += sx[r];

    if constexpr (DS > 1) {
      // the slices' partial scores meet in shared memory; every warp of the
      // row group sums them in the same order, so all hold the same S, bit
      // for bit, and run the same softmax
      float* mine = swap + (rg * DS + ds) * 16 * BK;
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) mine[r * 32 + lane] = sc[r];
      named_bar_sync(1 + rg, 32 * DS);
      const float* all = swap + rg * DS * 16 * BK;
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) {
        float total = 0.f;
#pragma unroll
        for (int d2 = 0; d2 < DS; ++d2) total += all[d2 * 16 * BK + r * 32 + lane];
        sc[r] = total;
      }
    }

    // the bias and the Lk edge where they apply
    if constexpr (kBias) {
      const float* brow = bsm(st) + (rg * 16 + g) * BS + 2 * tq;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 b0 = *reinterpret_cast<const float2*>(brow + 8 * j);
        const float2 b1 = *reinterpret_cast<const float2*>(brow + 8 * BS + 8 * j);
        sc[4 * j + 0] += b0.x * kLog2e;
        sc[4 * j + 1] += b0.y * kLog2e;
        sc[4 * j + 2] += b1.x * kLog2e;
        sc[4 * j + 3] += b1.y * kLog2e;
      }
    }
    if (kt + BK > lk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt + j * 8 + 2 * tq + (e & 1) >= lk) sc[4 * j + e] = -INFINITY;
    }

    // online softmax in f32; a row's scores are spread over a quad
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
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
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - m_new[e >> 1]);
        rsum[e >> 1] += sc[4 * j + e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + rsum[h];
    }

    // O = O * alpha + P V: the keys of score block j are relabelled so that
    // P's C fragment is its own A fragment (slot t: key 8j + 2t, slot t + 4:
    // key 8j + 2t + 1), and B is V at those keys, read a column at a time.
    // Each tile's P V is summed in fresh accumulators and added to O with an
    // IEEE add: one chain across all key tiles would gather the tensor
    // cores' truncation (a bias that grows with Lk).
    uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      split_tf32(sc[4 * j + 0], pb[j][0], ps[j][0]);
      split_tf32(sc[4 * j + 2], pb[j][1], ps[j][1]);
      split_tf32(sc[4 * j + 1], pb[j][2], ps[j][2]);
      split_tf32(sc[4 * j + 3], pb[j][3], ps[j][3]);
    }
    const float* vcol = vs(st) + 2 * tq * VS + ds * DW + g;
#pragma unroll
    for (int nb = 0; nb < DW / 8; ++nb) {
      float tb[4] = {0.f, 0.f, 0.f, 0.f}, tx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float* vr = vcol + 8 * j * VS + 8 * nb;
        uint32_t bb[2], bs[2];
        if constexpr (C::kPresplit) {
          const float* vq = vr - vs(st) + small + BK * QS;
          bb[0] = __float_as_uint(vr[0]), bb[1] = __float_as_uint(vr[VS]);
          bs[0] = __float_as_uint(vq[0]), bs[1] = __float_as_uint(vq[VS]);
        } else {
          split_tf32(vr[0], bb[0], bs[0]);
          split_tf32(vr[VS], bb[1], bs[1]);
        }
        mma_3xtf32(tb, tx, pb[j], ps[j], bb, bs);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * nb + e] = acc[4 * nb + e] * alpha[e >> 1] + (tb[e] + tx[e]);
    }
    __syncthreads();  // the stage (and the swap buffer) may be refilled
  }

  const size_t bh_rows = bh * lq;
  const int col0 = ds * DW + 2 * tq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qrow_i = q0 + rg * 16 + g + 8 * h;
    if (qrow_i >= lq) continue;
    if (part_o == nullptr) {
      float* orow = o + (bh_rows + qrow_i) * D + col0;
#pragma unroll
      for (int nb = 0; nb < DW / 8; ++nb)
        *reinterpret_cast<float2*>(orow + 8 * nb) =
            make_float2(acc[4 * nb + 2 * h] / l_run[h], acc[4 * nb + 2 * h + 1] / l_run[h]);
    } else {
      const size_t prow = static_cast<size_t>(blockIdx.z) * gridDim.y * lq + bh_rows + qrow_i;
      float* orow = part_o + prow * D + col0;
#pragma unroll
      for (int nb = 0; nb < DW / 8; ++nb)
        *reinterpret_cast<float2*>(orow + 8 * nb) = make_float2(acc[4 * nb + 2 * h], acc[4 * nb + 2 * h + 1]);
      if (ds == 0 && tq == 0) {
        part_ml[2 * prow] = m_run[h];
        part_ml[2 * prow + 1] = l_run[h];
      }
    }
  }
}

// bf16: TMA maps of q, k, v ([bh, L, D]) in 64-column boxes over the true
// D (a box past D reads zeros), Q boxes of `q_rows` rows, K and V boxes of
// `kv_rows` keys.
template <int D>
cudaError_t bf16_maps(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v, int bh,
                      int lq, int lk, int q_rows, int kv_rows) {
  const void* ptrs[3] = {q, k, v};
  const int lens[3] = {lq, lk, lk};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(lens[i]), static_cast<cuuint64_t>(bh)};
    const cuuint64_t strides[2] = {D * 2ull, static_cast<cuuint64_t>(lens[i]) * D * 2ull};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(i == 0 ? q_rows : kv_rows), 1};
    cudaError_t err =
        make_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptrs[i], dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D, bool kBias>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const float* bias, void* o,
                        void* workspace, int bh, int lq, int lk, float scale_log2,
                        cudaStream_t stream) {
  const int splits = key_splits(bh, lq, lk, kXQ, kXK);
  if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  cudaError_t err = bf16_maps<D>(maps, q, k, v, bh, lq, lk, kXQ, kXK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_wide_kernel<D, kBias>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Wide<D>::kSmem);
  if (err != cudaSuccess) return err;
  const int ntiles = ceil_div(lk, kXK);
  float* part_o = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  float* part_ml = splits > 1 ? part_o + static_cast<size_t>(splits) * bh * lq * D : nullptr;
  dim3 grid(ceil_div(lq, kXQ), bh, splits);
  kernel<<<grid, kWThreads, Wide<D>::kSmem, stream>>>(maps[0], maps[1], maps[2], bias,
                                                      static_cast<__nv_bfloat16*>(o), part_o, part_ml, lq,
                                                      lk, ceil_div(ntiles, splits), scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  flash_combine_kernel<__nv_bfloat16, D><<<bh * lq, D / 4, 0, stream>>>(
      part_o, part_ml, static_cast<__nv_bfloat16*>(o), bh * lq, splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wide_bias(const void* q, const void* k, const void* v, const float* bias, void* o,
                             void* workspace, int bh, int lq, int lk, float scale_log2, cudaStream_t s) {
  if (bias != nullptr) return launch_wide<D, true>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
  return launch_wide<D, false>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
}

// One launch of a bf16 D 40-160 kernel: a block per `q_rows` query rows of
// each batch*head.
template <typename Kernel>
cudaError_t launch_bf16(Kernel kernel, const CUtensorMap (&maps)[3], int threads, int smem, int q_rows,
                        const float* bias, void* o, int bh, int lq, int lk, float scale_log2,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(ceil_div(lq, q_rows), bh), threads, smem, stream>>>(
      maps[0], maps[1], maps[2], bias, static_cast<__nv_bfloat16*>(o), lq, lk, scale_log2);
  return cudaGetLastError();
}

// bf16 D 64-160: flash_wgmma_kernel.  D 40: flash_d40_kernel with three
// consumer warpgroups where its grid of 192-row Q tiles fills the card
// (the UNet's [2, 8, 4096] calls: 352 blocks), and with two where it does
// not ([1, 8, 1000]: 48 blocks of 192 rows, 64 of 128) and for the biased
// form (at three, its bias loads spilled).
template <int D, bool kBias>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* bias, void* o,
                         int bh, int lq, int lk, float scale_log2, cudaStream_t stream) {
  CUtensorMap maps[3];
  if constexpr (D == kED) {
    if constexpr (!kBias) {
      if (static_cast<long long>(ceil_div(lq, d40_rows(3))) * bh >= sm_count()) {
        cudaError_t err = bf16_maps<D>(maps, q, k, v, bh, lq, lk, d40_rows(3), kEK);
        if (err != cudaSuccess) return err;
        return launch_bf16(flash_d40_kernel<kBias, 3>, maps, d40_threads(3), d40_smem(3), d40_rows(3),
                           bias, o, bh, lq, lk, scale_log2, stream);
      }
    }
    cudaError_t err = bf16_maps<D>(maps, q, k, v, bh, lq, lk, d40_rows(2), kEK);
    if (err != cudaSuccess) return err;
    return launch_bf16(flash_d40_kernel<kBias, 2>, maps, d40_threads(2), d40_smem(2), d40_rows(2), bias,
                       o, bh, lq, lk, scale_log2, stream);
  } else {
    cudaError_t err = bf16_maps<D>(maps, q, k, v, bh, lq, lk, kWQ, wgmma_bk(D));
    if (err != cudaSuccess) return err;
    return launch_bf16(flash_wgmma_kernel<D, kBias>, maps, kWThreads, wgmma_smem_bytes<D>(), kWQ, bias, o,
                       bh, lq, lk, scale_log2, stream);
  }
}

template <int D>
cudaError_t launch_bf16_wgmma(const void* q, const void* k, const void* v, const float* bias,
                              void* o, int bh, int lq, int lk, float scale_log2, cudaStream_t s) {
  if (bias != nullptr) return launch_wgmma<D, true>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
  return launch_wgmma<D, false>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
}

// Key splits of the f32 kernel, by its tiles: at D 512 as for bf16; at D
// 160 where the grid of Q tiles leaves SMs idle (the SD1.5 UNet's [2, 8,
// 256] calls have 32 Q tiles and split four ways, 128 blocks of four 16-key
// tiles).  The other head dims keep one split.
template <int D>
int f32_splits(int bh, int lq, int lk) {
  using L = F32Smem<D, false>;  // BQ and BK do not depend on the bias
  if (D == 320 || D == kXD) return key_splits(bh, lq, lk, L::BQ, L::BK);
  if (D == 160 && static_cast<long long>(ceil_div(lq, L::BQ)) * bh < sm_count())
    return key_splits(bh, lq, lk, L::BQ, L::BK);
  return 1;
}

// The f32 kernel at head dim D; with several key splits the combine writes f32.
template <int D, bool kBias>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias, void* o,
                       void* workspace, int bh, int lq, int lk, float scale_log2,
                       cudaStream_t stream) {
  using L = F32Smem<D, kBias>;
  const int splits = f32_splits<D>(bh, lq, lk);
  if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  auto kernel = flash_f32_kernel<D, kBias>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const int ntiles = ceil_div(lk, L::BK);
  float* part_o = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  float* part_ml = splits > 1 ? part_o + static_cast<size_t>(splits) * bh * lq * D : nullptr;
  dim3 grid(ceil_div(lq, L::BQ), bh, splits);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), bias,
      static_cast<float*>(o), part_o, part_ml, lq, lk, ceil_div(ntiles, splits), scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  flash_combine_kernel<float, D><<<bh * lq, D / 4, 0, stream>>>(
      part_o, part_ml, static_cast<float*>(o), bh * lq, splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_bias(const void* q, const void* k, const void* v, const float* bias, void* o,
                            void* workspace, int bh, int lq, int lk, float scale_log2,
                            cudaStream_t s) {
  if (bias != nullptr) return launch_f32<D, true>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
  return launch_f32<D, false>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
}

}  // namespace
}  // namespace sdtpu

// The key splits a call runs (1 where the keys are not split): bf16 at D
// 320 and 512, f32 at D 160, 320 and 512 (f32_splits).
extern "C" long long sdtpu_flash_splits(int dtype, int bh, int lq, int lk, int d) {
  using namespace sdtpu;
  if (bh <= 0 || lq <= 0 || lk <= 0) return 1;
  if (dtype == kBF16 && (d == 320 || d == kXD)) return key_splits(bh, lq, lk, kXQ, kXK);
  if (dtype == kF32 && d == 160) return f32_splits<160>(bh, lq, lk);
  if (dtype == kF32 && d == 320) return f32_splits<320>(bh, lq, lk);
  if (dtype == kF32 && d == kXD) return f32_splits<kXD>(bh, lq, lk);
  return 1;
}

// Bytes of f32 scratch the call needs (0 unless its keys split).  The caller
// allocates it and passes it as `workspace`.
extern "C" long long sdtpu_flash_workspace_bytes(int dtype, int bh, int lq, int lk, int d) {
  using namespace sdtpu;
  const long long splits = sdtpu_flash_splits(dtype, bh, lq, lk, d);
  return static_cast<long long>(split_workspace_bytes(static_cast<int>(splits), bh, lq, d));
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
      case 40: return launch_bf16_wgmma<40>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 64: return launch_bf16_wgmma<64>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 80: return launch_bf16_wgmma<80>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 128: return launch_bf16_wgmma<128>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 160: return launch_bf16_wgmma<160>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 320: return launch_wide_bias<320>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
      case 512: return launch_wide_bias<512>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
    }
  } else if (dtype == kF32) {
    switch (d) {
      case 40: return launch_f32_bias<40>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
      case 64: return launch_f32_bias<64>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
      case 80: return launch_f32_bias<80>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
      case 128: return launch_f32_bias<128>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
      case 160: return launch_f32_bias<160>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
      case 320: return launch_f32_bias<320>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
      case 512: return launch_f32_bias<512>(q, k, v, bias, o, workspace, bh, lq, lk, scale_log2, s);
    }
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* sdtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
