// Dequantize-in-the-tile int8 matmuls for Hopper: out[m, n] = sum_k x[m, k] * w[n, k]
// with the weight kept int8 in device memory and widened tile by tile.
//
// Replaces the TPU kernels
//   `_gq_matmul_kernel`      (sdtpu/ops/quant.py:616) -> sdtpu_gq_matmul
//   `_gq_matmul_ws_kernel`   (sdtpu/ops/quant.py:652) -> sdtpu_gq_matmul_ws
//   `_gq_zero_matmul_kernel` (sdtpu/ops/quant.py:687) -> sdtpu_gq_zero_matmul
//   `_q_matmul_kernel`       (sdtpu/ops/quant.py:525) -> sdtpu_w8a16_matmul
// each through a form chosen by dtype, mode and the row count M alone
// (`gq_form`, exported as sdtpu_gq_form): `gq_wgmma_kernel<Mode, G>` for
// bf16 activations with M >= kGqMinM rows, `gq_gemv_kernel<Mode, G>` for
// bf16 with M <= kGqGemvMaxM in the group and W8A16 modes,
// `gq_splitk_kernel<Mode, G, XN>` for bf16 between them in those modes,
// `gq_gemm_kernel<G>` for the affine mode's bf16 calls below
// kGqMinM, and, for float32 activations at every M and in every mode
// (W8A16's too),
// `gq_gemm_f32_kernel<Mode, G, BM>`: common.cuh's split-x TF32 tile
// `f32_quant_gemm` with an int8 widening (x split into two tf32 terms, q
// exact in tf32, two tensor-core products a step, the scales outside them;
// bound by 2*M*N*K operations at 495 TFLOP/s TF32, its own floor 2 x
// that).
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
// here the zero is subtracted per element while the tile is widened.
//
// What bounds it on the card: 2*M*N*K operations on the bf16 tensor cores
// (989 TFLOP/s, NVIDIA H100 SXM data sheet at 700 W): 0.332 ms at
// 4352x3072->12288, where its 176 MB (x, int8 weight, scales, bf16 out)
// take 0.053 ms at 3.35 TB/s, so at FLUX's large M (1024-4352 tokens) the
// product is compute bound; at M = 1 (modulation linears) it is bound by
// reading the weight.
//
// Large M: `gq_wgmma_kernel`, the operands swapped as in CUTLASS's Hopper
// mixed-input GEMM.  A block computes outT[n, m] for 128 weight rows x 256
// x rows: a producer warp TMA-loads the int8 weight tile ([128 x 64 bytes],
// 64-byte swizzle, so the widening reads are free of bank conflicts) and
// the bf16 x tile ([256 x 64], 128-byte swizzle) into a four-stage ring
// under full/empty mbarriers, and cp.asyncs the stage's f32 scales (and
// zeros) beside them, counted on the same barrier.  Each of two consumer
// warpgroups reads its 64 weight rows from shared memory straight into the
// wgmma register-A layout, widens them there (q * s (- z) in f32, one bf16
// rounding) and issues wgmma.m64n256k16 with A from registers and B = the x
// tile K-major: the widened weight never returns to shared memory, and the
// widening of stage k+1 runs while stage k's wgmma are in flight (the A
// fragments are double-buffered).  The epilogue writes the transposed
// accumulator to out[m, n] (kRowScale: * scale[n] in f32 first).  This form
// was chosen over widening into a swizzled bf16 shared tile for wgmma SS
// because the int8 stage is half a bf16 one (a deeper ring in the same
// shared memory) and the widened tile costs no shared-memory traffic.  Each
// block reads its weight tile once per 256 x rows, so the TPU's
// weight-stationary variant has nothing left to save: its entry launches
// the same kernels.  No scratch grows with M.
//
// Few rows (M <= kGqGemvMaxM = 8), group and W8A16 modes:
// `gq_gemv_kernel`, common.cuh's weight-streaming `weight_gemv` with an int8
// widening (about three instructions a weight: a byte permute under 2^23
// and an exact subtract give q in f32, __fmul_rn by the scale for kGroup,
// half a bf16x2 pack), half the 4-bit form's per streamed byte.  Its bound
// is the int8 bytes (and, for kGroup, the f32 scales: 1.125 bytes a weight
// at G = 32), 0.0169 ms for a 3072->18432 W8A16 modulation linear.  A
// lane's 16 bytes lie in one scale group (G = 16 or 32): one f32 scale a
// lane and row.  Four warps of two-segment batches won on the card over
// the DiT's mix a step, 38 launches each at 3072->18432 and 3072->9216, on
// the device clock (sdtpu_torch/tools/time_dequant.py on trees differing in
// these two constants, in turns, before the GEMVs shared one template;
// NVIDIA H100 80GB HBM3, 700.00 W): 1.46 ms for kGroup and 1.60 for
// kRowScale, against 1.68 / 1.49 for eight warps of two segments, 1.80 /
// 1.69 for eight warps of one (the 4-bit form's choice), 1.98 / 1.53 for
// four warps of one and 1.66 / 1.73 for four warps of four.  Unlike the
// 4-bit form, deeper batches pay: the widening costs half as much per
// streamed byte.  The rest is how whole 16-row blocks fill the SMs' slots:
// in the shared template kGroup takes 96 registers (5 blocks of 128 threads
// an SM) and kRowScale 80 (6; 72 and 7 in its own kernel, which ran
// 3072->18432 in 0.0288 ms against 0.0261 now, and 3072->9216 alike).
//
// Between them (kGqGemvMaxM < M < kGqMinM), group and W8A16 modes:
// `gq_splitk_kernel<Mode, G, XN>`, common.cuh's split-K weight-streaming
// `wgmma` GEMM `splitk_gemm` with an int8 widening as its policy
// (`WidenI8Rows`): operands swapped (128 weight rows a block as the wgmma
// M, every x row in one tile of XN = 32, 64, 80 or 128 as its N), a TMA
// ring under full / empty mbarriers, K split across the blocks of a cluster
// (1 to 8, by shape: `sdtpu_gq_splits` reports it) and reduced through
// distributed shared memory in split order, one launch and no workspace.
// The first path that runs it is an int8 SDXL UNet at CFG 1, whose 140
// context projections a forward (attn2.to_k / to_v over CLIP's 77 tokens:
// 77x2048->640 and ->1280) take it as group-32 blocks (a q8_0 GGUF kept in
// them) or under W8A16.  The weight tile is TMA-loaded with the 64-byte
// swizzle and each register-A pair read as 16 bits at its swizzled offset,
// as in the wgmma form (no bank conflicts); kGroup widens q * s in f32
// (__fmul_rn: no contraction) and rounds once to bf16, kRowScale widens q
// exactly, loads no stage scales and multiplies the f32 sum by s[n] before
// its one rounding, in the unsplit store and after the cluster's split-order
// sum alike.  Its bound is the int8 weight's bytes (77x2048->1280:
// 0.0009 ms at 3.35 TB/s), so at SDXL's shapes the launch's fixed cost
// (~6 us, common.cuh) is most of its time: on an NVIDIA H100 80GB HBM3 at
// 700 W (device clock; chip_smoke.py, sdtpu_torch/tools/time_dequant.py)
// 0.0073-0.0079 ms there (8 splits; the mma.sync form it replaced
// 0.049-0.052), 0.029-0.032 at 127x3072->12288 (0.109-0.120).
//
// The affine mode below kGqMinM: the first form, tiles loaded
// synchronously (global -> registers -> shared, then a barrier) and
// mma.sync m16n8k16.  x is row-major [M, K] with K a multiple of 8; rows,
// columns and K past the edge are zero-filled.
#include "common.cuh"

namespace sdtpu {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kRow = kBK + 8;  // bf16 row padding: 144-byte rows
constexpr int kThreads = 256;  // 8 warps: 2 along M (32 rows) x 4 along N (32 cols)

// How a weight tile is widened.
enum WMode : int { kGroup = 0, kGroupZero = 1, kRowScale = 2 };

// The block's [kBN x kBK] affine weight tile, widened to bf16 into shared
// memory.  512 chunks of 16 int8 values; a chunk starts at a multiple of 16
// and so lies inside one scale group (G >= 16).
template <int G>
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
    const size_t gi = (size_t)row * (kp / G) + kk / G;
    const float s = scale[gi], z = zero[gi];
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = __fsub_rn(__fmul_rn(static_cast<float>(v[2 * i]), s), z);
      const float b = __fsub_rn(__fmul_rn(static_cast<float>(v[2 * i + 1]), s), z);
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

// The warp's patch to bf16 out.
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], __nv_bfloat16* out, int m,
                                           int n, int m0, int n0, int wm, int wn, int g, int tq) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + h * 8;
        const int col = n0 + wn * 32 + j * 8 + tq * 2;
        if (row >= m) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (col + 1 < n && (n & 1) == 0) {  // paired store needs 4-byte alignment
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < n) out[(size_t)row * n + col] = __float2bfloat16_rn(v0);
          if (col + 1 < n) out[(size_t)row * n + col + 1] = __float2bfloat16_rn(v1);
        }
      }
}

// The affine mode's small-M form: a block owns a 64 x kBN output tile.  Per
// K step it widens the weight tile into shared memory, loads the x tile
// beside it and runs mma.sync over both.
template <int G>
__global__ void __launch_bounds__(kThreads)
gq_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, const float* __restrict__ zero,
               __nv_bfloat16* __restrict__ out, int m, int n, int k, int kp) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBM * kRow];
  __shared__ __align__(16) __nv_bfloat16 ws[kBN * kRow];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[2][4][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < kp; k0 += kBK) {
    load_w_tile<G>(ws, q, scale, zero, n, kp, n0, k0, tid);
    load_x_tile(xs, x, m, k, m0, k0, tid);
    __syncthreads();
    mma_tile(acc, xs, ws, wm, wn, g, tq);
    __syncthreads();
  }
  store_tile(acc, out, m, n, m0, n0, wm, wn, g, tq);
}

// float32 activations, every M and mode: common.cuh's split-x TF32 tile
// `f32_quant_gemm` with this int8 widening.  A lane's four bytes at 16p +
// 4tq of a stage row are its four weights of the 16-k block p, each q exact
// as a float (offset binary under 2^23, as the GEMV's widening), a valid
// tf32.  kGroup folds each group's float32 sum into the master by
// fmaf(s, acc, master); kGroupZero then subtracts z times the group's sum of
// x, fmaf(-z, sum_x, master), so q * s - z is never formed (the TPU's affine
// kernel factored the zero out as well); this was chosen over widening q * s
// - z in float32 and running 3xTF32 on it, which would take three products
// a step, not two, and a split of every weight.  kRowScale adds fresh
// accumulators to the master every 64-k stage and multiplies the float32
// sum by its row scale in the epilogue, as the TPU kernel scales its sum
// (sdtpu/ops/quant.py:541-543).  Rows of 64 bytes a stage, padded to 80 so
// the eight rows one load reads start 20 banks apart.
template <int Mode, int G>
struct WidenI8F32 {
  static constexpr int kKPerByte = 1, kRowStride = 80, kG = Mode == kRowScale ? 64 : G;
  static constexpr bool kGroupScale = Mode != kRowScale, kZero = Mode == kGroupZero;
  static constexpr bool kSumScale = Mode == kRowScale;
  static __device__ __forceinline__ void fragment(const uint8_t* row, int p, int tq, uint32_t (&b)[4]) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(row + 16 * p + 4 * tq) ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[i] = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)), 8388736.f));
  }
};

// kGroup / kGroupZero: scale (and zero) f32 [n, kp / G]; kRowScale (G
// unused): scale f32 [n].
template <int Mode, int G, int BM>
__global__ void __launch_bounds__(F32QSmem<WidenI8F32<Mode, G>, BM>::kThreads, 1)
gq_gemm_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
                   const float* __restrict__ scale, const float* __restrict__ zero,
                   float* __restrict__ out, int m, int n, int k, int kp) {
  f32_quant_gemm<WidenI8F32<Mode, G>, BM>(x, q, scale, zero, out, m, n, k, kp);
}

template <int Mode, int G>
cudaError_t launch_gq_f32(const void* x, const void* q, const float* scale, const float* zero,
                          void* out, int m, int n, int k, int kp, cudaStream_t stream) {
  return launch_f32q<WidenI8F32<Mode, G>>(gq_gemm_f32_kernel<Mode, G, 16>, gq_gemm_f32_kernel<Mode, G, 64>,
                                          gq_gemm_f32_kernel<Mode, G, 128>, x, q, scale, zero, out, m,
                                          n, k, kp, stream);
}

// ------------------------------------------------------- large M: wgmma

constexpr int kGqMinM = 128;    // bf16 calls with at least this many rows take the wgmma kernel
constexpr int kGqBN = 128;      // weight rows per block: two consumer warpgroups x 64 (wgmma M)
constexpr int kGqBM = 256;      // x rows per block (wgmma N)
constexpr int kGqBK = 64;       // K per stage: 64 int8 bytes a weight row, 128 bytes an x row
constexpr int kGqStages = 4;
constexpr int kGqThreads = 384;  // warpgroups 0-1: consumers; 2: producer (its first warp)
constexpr int kGqXTile = kGqBM * kGqBK * 2;    // 32 KB, 128-byte swizzle
constexpr int kGqWTile = kGqBN * kGqBK;        // 8 KB, 64-byte swizzle
constexpr int kGqSTile = kGqBN * (kGqBK / 16) * 4;  // f32 scales (or zeros) of one stage, G >= 16
constexpr int kGqSmem = 1024 + kGqStages * (kGqXTile + kGqWTile + 2 * kGqSTile) + 2 * kGqStages * 8;
static_assert(kGqSmem <= 232448, "gq wgmma: shared memory over the 227 KB a block may use");

// One weight row's 16-bit pair at byte `col` of a stage's [kGqBN x 64] int8
// tile, as TMA wrote it with the 64-byte swizzle: the 16-byte chunk index
// (bits 4-5) is XORed with bits 7-8 of the offset, i.e. with (row / 2) % 4.
// The eight rows one warp-wide load reads (g = 0..7, four lanes a row)
// then fall in eight different 16-byte bank groups: no conflicts.
__device__ __forceinline__ uint32_t w_pair_offset(int row, int col) {
  return row * kGqBK + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// outT[n, m] = W[n, :] . x[m, :] for a kGqBN x kGqBM tile, W widened in
// registers (the wgmma A operand) and x read from shared memory (B,
// K-major), so the widened weight never goes back to shared memory.
template <int Mode, int G>
__global__ void __launch_bounds__(kGqThreads, 1)
gq_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ scale, const float* __restrict__ zero,
                __nv_bfloat16* __restrict__ out, int m, int n, int kp) {
  constexpr int GPS = Mode == kRowScale ? 0 : kGqBK / G;  // scale groups a row per stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t x_base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t w_base = x_base + kGqStages * kGqXTile;
  const uint32_t s_base = w_base + kGqStages * kGqWTile;
  const uint32_t z_base = s_base + kGqStages * kGqSTile;
  const uint32_t bars = z_base + kGqStages * kGqSTile;
  const uint8_t* smem = smem_raw - raw;  // generic pointer of shared address 0
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kGqStages + s); };

  // blocks walk the M tiles of one weight band before the next band, so the
  // ~132 blocks in flight share a band of ~8 x 128 weight rows and all of x
  const int num_m = (m + kGqBM - 1) / kGqBM;
  const int m0 = (blockIdx.x % num_m) * kGqBM, n0 = (blockIdx.x / num_m) * kGqBN;
  const int ktiles = (kp + kGqBK - 1) / kGqBK;
  const int groups = GPS ? kp / G : 0;

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGqStages; ++s) {
      // the TMA arrival, plus one cp.async arrival per producer lane
      mbar_init(full(s), 1 + (GPS ? 32 : 0));
      mbar_init(empty(s), 8);  // the consumers' eight warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: the first warp; lane 0 issues the TMA loads of the x and
    // weight tiles, all lanes cp.async the stage's scales (and zeros), whose
    // row stride need not be the 16 bytes a TMA map wants
    setmaxnreg_dec<40>();
    if (threadIdx.x < 256 + 32) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kGqStages;
        mbar_wait(empty(s), ((kt / kGqStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(s), kGqXTile + kGqWTile);
          tma_load_2d(x_base + s * kGqXTile, &xmap, full(s), kt * kGqBK, m0);
          tma_load_2d(w_base + s * kGqWTile, &wmap, full(s), kt * kGqBK, n0);
        }
        if constexpr (GPS > 0) {
          for (int idx = lane; idx < kGqBN * GPS; idx += 32) {
            const int row = n0 + idx / GPS, grp = kt * GPS + idx % GPS;
            const bool valid = row < n && grp < groups;
            const size_t off = valid ? static_cast<size_t>(row) * groups + grp : 0;
            cp_async_4(s_base + s * kGqSTile + idx * 4, scale + off, valid);
            if constexpr (Mode == kGroupZero) cp_async_4(z_base + s * kGqSTile + idx * 4, zero + off, valid);
          }
          cp_async_mbar_arrive(full(s));
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's weight rows in the tile: r0, r0 + 8

    // The stage's weight tile widened into the register-A layout of four
    // k16 steps: a[kk] = {(r0, 2tq..+1), (r0+8, 2tq..+1), (r0, 2tq+8..+9),
    // (r0+8, 2tq+8..+9)} of K columns 16kk.., each q * scale (- zero) in f32
    // (no fma contraction, as the plain version) rounded once to bf16.
    auto widen = [&](uint32_t (&a)[4][4], int s) {
      const uint8_t* wt = smem + w_base + s * kGqWTile;
      const float* sc = reinterpret_cast<const float*>(smem + s_base + s * kGqSTile);
      const float* zc = reinterpret_cast<const float*>(smem + z_base + s * kGqSTile);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = r0 + 8 * rr;
            const uint32_t v = *reinterpret_cast<const uint16_t*>(wt + w_pair_offset(row, 16 * kk + 8 * h + 2 * tq));
            float lo = static_cast<float>(static_cast<int8_t>(v & 0xff));
            float hi = static_cast<float>(static_cast<int8_t>(v >> 8));
            if constexpr (GPS > 0) {
              const int gi = row * GPS + (16 * kk) / G;
              lo = __fmul_rn(lo, sc[gi]);
              hi = __fmul_rn(hi, sc[gi]);
              if constexpr (Mode == kGroupZero) {
                lo = __fsub_rn(lo, zc[gi]);
                hi = __fsub_rn(hi, zc[gi]);
              }
            }
            a[kk][2 * h + rr] = pack_bf16x2(lo, hi);
          }
    };

    // acc[4j + e]: weight row r0 (+8 for e >= 2), x row 8j + 2tq (+1 for odd e)
    float acc[kGqBM / 2];
#pragma unroll
    for (int i = 0; i < kGqBM / 2; ++i) acc[i] = 0.f;
    uint32_t a0[4][4], a1[4][4];

    // One K stage: issue its four wgmma on `cur`, then, while they run,
    // free the stage before it and widen the next stage into `nxt` (whose
    // previous wgmma group is complete after wait<1>).
    auto step = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4], int kt) {
      const int s = kt % kGqStages;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16_bf16_rs<0>(acc, cur[kk], smem_desc_sw128(x_base + s * kGqXTile + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(nxt[kk]);
      if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % kGqStages));
      if (kt + 1 < ktiles) {
        const int s1 = (kt + 1) % kGqStages;
        mbar_wait(full(s1), ((kt + 1) / kGqStages) & 1);
        widen(nxt, s1);
      }
    };

    mbar_wait(full(0), 0);
    widen(a0, 0);
    for (int kt = 0; kt < ktiles; kt += 2) {
      step(a0, a1, kt);
      if (kt + 1 < ktiles) step(a1, a0, kt + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(a0[kk]);
      fence_regs(a1[kk]);
    }

    // epilogue: out[m, n] = acc (kRowScale: * scale[n] in f32)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nn = n0 + r0 + 8 * h;
      if (nn >= n) continue;
      const float rs = Mode == kRowScale ? scale[nn] : 1.f;
#pragma unroll
      for (int j = 0; j < kGqBM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mm = m0 + 8 * j + 2 * tq + e;
          if (mm >= m) continue;
          float v = acc[4 * j + 2 * h + e];
          if (Mode == kRowScale) v = __fmul_rn(v, rs);
          out[static_cast<size_t>(mm) * n + nn] = __float2bfloat16_rn(v);
        }
    }
  }
}

template <int Mode>
cudaError_t launch_gq_wgmma(const void* x, const void* q, const float* scale, const float* zero,
                            void* out, int m, int n, int k, int kp, int group, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t xbox[2] = {kGqBK, kGqBM};
  cudaError_t err = make_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(n)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t wbox[2] = {kGqBK, kGqBN};
  err = make_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, wdims, wstrides, wbox,
                        CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  auto kernel = group == 16 ? gq_wgmma_kernel<Mode, 16> : gq_wgmma_kernel<Mode, 32>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGqSmem);
  if (err != cudaSuccess) return err;
  const int blocks = ceil_div(n, kGqBN) * ceil_div(m, kGqBM);
  kernel<<<blocks, kGqThreads, kGqSmem, stream>>>(xmap, wmap, scale, zero,
                                                  static_cast<__nv_bfloat16*>(out), m, n, kp);
  return cudaGetLastError();
}

// ------------------------------------------------------- 8 < M < 128: split K

// splitk_gemm's policy for int8 rows of 64 bytes a stage, TMA-loaded with
// the 64-byte swizzle: a thread's pair (2tq + 8h) of k16 step kk is the
// 16-bit word at column 16kk + 8h + 2tq of its row (w_pair_offset), each q
// exact in f32 (offset binary under 2^23, as the GEMV's widening); kGroup
// multiplies by the group's scale (__fmul_rn) before the one bf16x2
// rounding, bit-equal to the plain version's weight; kRowScale's q is exact
// in bf16 and its scale waits for the epilogue.
template <int Mode>
struct WidenI8Rows {
  static_assert(Mode == kGroup || Mode == kRowScale, "gq split-K: the affine mode keeps mma.sync");
  static constexpr int kKPerByte = 1, kRowBytes = kSplitBK;
  static constexpr bool kSumScale = Mode == kRowScale;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  template <int G>
  static __device__ __forceinline__ void row_pairs(const uint8_t* tile, int row, const float* srow,
                                                   int tq, uint32_t (&f)[4][2]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v =
            *reinterpret_cast<const uint16_t*>(tile + w_pair_offset(row, 16 * kk + 8 * h + 2 * tq)) ^ 0x8080u;
        float lo = __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u)), 8388736.f);
        float hi = __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7441u)), 8388736.f);
        if constexpr (!kSumScale) {
          const float s = srow[(16 * kk) / G];
          lo = __fmul_rn(lo, s);
          hi = __fmul_rn(hi, s);
        }
        f[kk][h] = pack_bf16x2(lo, hi);
      }
  }
};

// kGroup: scale f32 [n, kp / G]; kRowScale (G unused): scale f32 [n]
template <int Mode, int G, int XN>
__global__ void __launch_bounds__(kSplitThreads, 1)
gq_splitk_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int m, int n,
                 int k, int kp, int splits) {
  splitk_gemm<WidenI8Rows<Mode>, G, XN>(&xmap, &wmap, scale, out, m, n, k, kp, splits);
}

template <int Mode, int XN>
SplitKKernel gq_splitk_for(int group) {
  if constexpr (Mode == kRowScale) {
    return gq_splitk_kernel<kRowScale, 32, XN>;
  } else {
    return group == 16 ? gq_splitk_kernel<Mode, 16, XN> : gq_splitk_kernel<Mode, 32, XN>;
  }
}

// The split count a call of m rows takes at n x k: a function of the shape
// (and the card) alone, the same for both modes (their kernels share their
// shared memory and threads).
int gq_splits(int m, int n, int k) {
  return with_splitk_cols(m, [&](auto xn) {
    constexpr int XN = decltype(xn)::value;
    return splitk_splits_for<SplitKSmem<WidenI8Rows<kGroup>, XN>>(
        reinterpret_cast<const void*>(gq_splitk_for<kGroup, XN>(32)), n, ceil_div(k, kSplitBK));
  });
}

template <int Mode>
cudaError_t launch_gq_splitk(const void* x, const void* q, const float* scale, void* out, int m,
                             int n, int k, int kp, int group, cudaStream_t stream) {
  const int splits = gq_splits(m, n, k);
  return with_splitk_cols(m, [&](auto xn) {
    constexpr int XN = decltype(xn)::value;
    return launch_splitk<WidenI8Rows<Mode>>(gq_splitk_for<Mode, XN>(group),
                                            SplitKSmem<WidenI8Rows<Mode>, XN>::kBytes, XN, x, q,
                                            scale, out, m, n, k, kp, splits, stream);
  });
}

// ------------------------------------------------------- M <= 8: GEMV

constexpr int kGqGemvMaxM = kGemvMaxM;  // bf16 calls with at most this many rows take the GEMV
constexpr int kGqGemvWarps = 4;         // warps per block, splitting K
constexpr int kGqGemvUnroll = 2;        // segments a batch: a warp's loads run a batch ahead

// weight_gemv's policy for int8: four weights (k .. k + 3, bytes 0-3 of w)
// -> the bf16x2 registers (k, k + 1) and (k + 2, k + 3).  Each q is exact in
// f32: the byte made offset binary (q + 128) and permuted under the exponent
// of 2^23, then 2^23 + 128 subtracted.  kGroup multiplies by the group's
// scale in f32 (__fmul_rn: no contraction), so the one bf16 rounding gives
// the plain version's weight; kRowScale's q is exact in bf16, and the f32
// sum is multiplied by scale[n].
template <int Mode>
struct WidenI8 {
  static_assert(Mode == kGroup || Mode == kRowScale, "gq gemv: the affine mode keeps mma.sync");
  static constexpr int kKPerByte = 1;
  static constexpr bool kGroupScale = Mode == kGroup, kSumScale = Mode == kRowScale;
  static constexpr uint32_t kZeroWord = 0;
  static __device__ __forceinline__ void widen(uint32_t w, float s, uint32_t (&r)[2]) {
    const uint32_t u = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)), 8388736.f);
      if constexpr (kGroupScale) f[i] = __fmul_rn(f[i], s);
    }
    r[0] = pack_bf16x2(f[0], f[1]);
    r[1] = pack_bf16x2(f[2], f[3]);
  }
};

// kGroup: scale f32 [n, kp / G]; kRowScale (G unused): scale f32 [n].
template <int Mode, int G>
__global__ void __launch_bounds__(kGqGemvWarps * 32)
gq_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int m, int n,
               int k, int kp) {
  weight_gemv<WidenI8<Mode>, G, kGqGemvWarps, kGqGemvUnroll>(
      x, reinterpret_cast<const uint8_t*>(q), scale, out, m, n, k, kp);
}

template <int Mode, int G>
cudaError_t launch_gq_gemv(const void* x, const void* q, const float* scale, void* out, int m,
                           int n, int k, int kp, cudaStream_t stream) {
  gq_gemv_kernel<Mode, G><<<ceil_div(n, kGemvRows), kGqGemvWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), scale,
      static_cast<__nv_bfloat16*>(out), m, n, k, kp);
  return cudaGetLastError();
}

// The form a call of m rows takes, by shape alone: 0 the GEMV (bf16, M <=
// kGqGemvMaxM, not affine), 1 the mma.sync form (bf16, affine, M <
// kGqMinM), 2 the wgmma kernel (bf16, M >= kGqMinM), 3 the float32 kernel
// (every mode and M), 4 the split-K form (bf16, not affine, between the
// GEMV and the wgmma kernel); -1 a dtype no kernel takes.
int gq_form(int dtype, int mode, int m) {
  if (dtype == kF32) return 3;
  if (dtype != kBF16) return -1;
  if (m >= kGqMinM) return 2;
  if (mode == kGroupZero) return 1;
  return m <= kGqGemvMaxM ? 0 : 4;
}

bool group_shape_ok(int m, int n, int k, int kp, int group) {
  return m > 0 && n > 0 && k > 0 && k % 8 == 0 && k <= kp && (group == 16 || group == 32) &&
         kp % group == 0;
}

// The form gq_form names, by shape only: a refused launch is returned,
// never retried on another kernel.
template <int Mode>
cudaError_t launch_group(int dtype, const void* x, const void* q, const void* scale,
                         const void* zero, void* out, int m, int n, int k, int kp, int group,
                         void* stream) {
  if (!group_shape_ok(m, n, k, kp, group)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* zr = static_cast<const float*>(zero);
  const int form = gq_form(dtype, Mode, m);
  if (form == 2) return launch_gq_wgmma<Mode>(x, q, sc, zr, out, m, n, k, kp, group, s);
  if (form == 3)
    return group == 16 ? launch_gq_f32<Mode, 16>(x, q, sc, zr, out, m, n, k, kp, s)
                       : launch_gq_f32<Mode, 32>(x, q, sc, zr, out, m, n, k, kp, s);
  if constexpr (Mode == kGroupZero) {
    if (form != 1) return cudaErrorInvalidValue;
    auto kernel = group == 16 ? gq_gemm_kernel<16> : gq_gemm_kernel<32>;
    kernel<<<dim3(ceil_div(n, kBN), ceil_div(m, kBM)), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), sc, zr,
        static_cast<__nv_bfloat16*>(out), m, n, k, kp);
    return cudaGetLastError();
  } else {
    if (form == 0)
      return group == 16 ? launch_gq_gemv<Mode, 16>(x, q, sc, out, m, n, k, kp, s)
                         : launch_gq_gemv<Mode, 32>(x, q, sc, out, m, n, k, kp, s);
    if (form == 4) return launch_gq_splitk<Mode>(x, q, sc, out, m, n, k, kp, group, s);
    return cudaErrorInvalidValue;
  }
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

// The weight-stationary entry (`_gq_matmul_ws_kernel`'s counterpart); bf16
// only.  Every wgmma block already reads each weight tile once per 256 x
// rows, so it launches the same kernels as sdtpu_gq_matmul.
extern "C" int sdtpu_gq_matmul_ws(int dtype, const void* x, const void* q, const void* scale,
                                  void* out, int m, int n, int k, int kp, int group,
                                  void* stream) {
  using namespace sdtpu;
  if (dtype != kBF16) return cudaErrorInvalidValue;
  return launch_group<kGroup>(dtype, x, q, scale, nullptr, out, m, n, k, kp, group, stream);
}

// W8A16: x [m, k] in `dtype` (bf16 or f32); q int8 [n, k]; scale f32 [n]
// -> out [m, n] in `dtype`, out = (sum_k x * q) * scale[n], the sum in
// float32.  Needs k % 16 == 0.  The form is gq_form's for kRowScale; a
// refused launch is returned, never retried on another form.
extern "C" int sdtpu_w8a16_matmul(int dtype, const void* x, const void* q, const void* scale,
                                  void* out, int m, int n, int k, void* stream) {
  using namespace sdtpu;
  if (m <= 0 || n <= 0 || k <= 0 || k % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int form = gq_form(dtype, kRowScale, m);
  if (form < 0) return cudaErrorInvalidValue;
  if (form == 3) return launch_gq_f32<kRowScale, 1>(x, q, sc, nullptr, out, m, n, k, k, s);
  if (form == 0) return launch_gq_gemv<kRowScale, 1>(x, q, sc, out, m, n, k, k, s);
  if (form == 2) return launch_gq_wgmma<kRowScale>(x, q, sc, nullptr, out, m, n, k, k, 32, s);
  return launch_gq_splitk<kRowScale>(x, q, sc, out, m, n, k, k, 32, s);
}

// The form a call takes: dtype (0 bf16, 1 f32), mode (0 group, 1 affine,
// 2 W8A16's row scale) and m rows -> 0 the GEMV, 1 the mma.sync form, 2 the
// wgmma kernel, 3 the float32 kernel, 4 the split-K form (-1: no kernel
// takes the dtype).
extern "C" long long sdtpu_gq_form(int dtype, int mode, int m) {
  return sdtpu::gq_form(dtype, mode, m);
}

// The splits of K the split-K form takes at m x k -> n of bf16 x in the
// group and W8A16 modes (1 to 8, the blocks of a cluster; 0 where another
// form runs).
extern "C" long long sdtpu_gq_splits(int m, int n, int k) {
  using namespace sdtpu;
  return m > kGqGemvMaxM && m < kGqMinM && n > 0 && k > 0 ? gq_splits(m, n, k) : 0;
}
