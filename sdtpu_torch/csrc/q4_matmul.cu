// Packed 4-bit weight matmul for Hopper: out[m, n] = sum_k x[m, k] * w[n, k]
// with w[n, k] = (nibble(n, k) - 8) * scale[n, k / G], each weight computed in
// f32 and rounded once to bf16, for scale groups G = 64 (the q4_0 class the
// bench synthesizes), 32 (a q4_0 GGUF's own blocks) and 16 (q3_k-class
// blocks).
//
// Replaces the TPU kernel `_q4_matmul_kernel` (sdtpu/ops/quant.py:845), which
// computes in x's dtype, through forms chosen by dtype and the row count M
// alone: for bf16 x `q4_gemv_kernel<G>` for M <= kQ4GemvMaxM,
// `q4_wgmma_kernel<G, BM>` for M >= kQ4MinM and `q4_splitk_kernel<G, XN>`
// between them; for float32 x (the default pipeline's T5-XXL)
// `q4_gemm_f32_kernel<G, BM>` at every M: common.cuh's split-x TF32 tile
// `f32_quant_gemm` on the tensor cores (x split into two tf32 terms, each
// nibble - 8 exact in tf32,
// the group's scale folded into a float32 master by an fma; bound by 2*M*N*K
// operations at 495 TFLOP/s TF32, its own floor 2 x that; x-row tile BM 16,
// 64 or 128 by shape).  The port stores 4-bit weights in its own
// layout, chosen for these kernels (the TPU's split-half layout served
// Mosaic's sublane tiling):
// packed uint8 [N, Kp/2] row-major, byte j of a row holding k = 2j in the low
// nibble and k = 2j + 1 in the high nibble, and f32 scales [N, Kp/G], Kp a
// multiple of 64.  x is bf16 or float32 [M, K] with K a multiple of 8; rows,
// columns and K past the edge are zero-filled.
//
// What bounds it on the card (NVIDIA H100 SXM data sheet, 700 W): 2*M*N*K
// operations at 989 TFLOP/s bf16, e.g. 0.332 ms at the FLUX DiT's
// 4352x3072->12288 and 0.0217 ms at T5-XXL's 256x4096->10240; at M = 1 it is
// the packed bytes and the f32 scales at 3.35 TB/s, 0.0106 ms for a
// 3072->18432 modulation linear at group 32.  So every M >= 128 call is
// compute bound and the design's job is to keep the tensor cores fed while
// the nibbles are widened.
//
// Large M: `q4_wgmma_kernel`, the structure of gq_matmul.cu's
// `gq_wgmma_kernel` (operands swapped as in CUTLASS's Hopper mixed-input
// GEMM), written on its own: that mainloop shared by both through one
// template, the widening its policy, timed W8A16 0.5-1.4 % and group 16
// 1.8 % slower at FLUX's large-M shapes in one chip call against this form
// (sdtpu_torch/tools/time_dequant.py; NVIDIA H100 80GB HBM3, 700.00 W).
// A block computes outT[n, m] for 128 weight rows x BM x rows.  A producer warp
// TMA-loads the packed tile ([128 rows x 32 bytes] = 64 k, unswizzled) and
// the bf16 x tile ([BM rows x 64 k], 128-byte swizzle) into a ring of stages
// under full/empty mbarriers, and cp.asyncs the stage's f32 scales beside
// them, counted on the same barrier (a scale row is Kp/G x 4 bytes, not
// always the 16-byte multiple a TMA map needs: 40 bytes at K = 640, G = 64).
// Each of two consumer warpgroups builds the wgmma register-A fragments of
// its 64 weight rows straight from the packed bytes: the pair (k, k + 1) of
// an A register is exactly one packed byte, so one byte widens into one
// bf16x2 register ((nibble - 8) exact in f32 via the 2^23 trick, __fmul_rn by
// the group's scale, one bf16x2 rounding: bit-equal to the plain version).
// A thread needs byte tq of each 4-byte word of its rows r0 and r0 + 8, and
// reads each row as two 16-byte loads; a 16-byte shared load is served an
// eighth of the warp at a time, and those eight lanes read two adjacent
// 32-byte rows, 64 contiguous bytes, so the unswizzled tile reads without
// bank conflicts.  wgmma.m64nBMk16 then runs with A from registers and B =
// the x tile K-major; the widened weight never goes to shared or device
// memory, and stage k + 1 is widened while stage k's wgmma are in flight (A
// fragments double-buffered and pinned with fence_regs).  The epilogue
// writes the transposed accumulator to out[m, n].
//
// Filling the card: T5's M = 256 at N = 4096 gives only 32 blocks of 128 x
// 256 on 132 SMs, so BM (the wgmma N) is a template parameter, 256, 128 or
// 64, and the launcher picks the tile whose grid costs least, counted as
// waves x (BM + 64): the 64 stands for the per-stage widening, which does not
// shrink with BM.  T5's 4096-wide outputs at M = 256 take BM = 64 (128
// blocks); its 10240-wide output and the DiT's large M take BM = 256.  This
// was chosen over split K, which needs a reduction pass and f32 scratch.
// Shared memory: 1 KB alignment + stages x (x tile BM x 128 B, packed 4 KB,
// scales 2 KB) + barriers: 4 stages at BM = 256 (156,736 B), 8 at BM = 128
// (181,376 B) and at BM = 64 (115,840 B), all under the 227 KB a block may use.
// Blocks raster the M tiles of one weight band before the next band, so the
// blocks in flight share a band of the weight and all of x in L2.
//
// Few rows (M <= kQ4GemvMaxM = 8): `q4_gemv_kernel`, common.cuh's
// weight-streaming `weight_gemv` with the nibble widening of the wgmma form
// (about four instructions a weight).  Its bound is the packed bytes and f32
// scales (0.625 bytes a weight at G = 32).  Eight warps of one-segment
// batches (80 registers, three blocks an SM) measured faster on the card
// than four warps of 2-6 segments, than segments taken in turn by the warps
// and than a shared-memory ring fed by bulk async copies from a producer
// warp: the widening costs about as much issue time as the stream takes, so
// warps that can hide it matter more than deep batches.

// Between them (8 < M < kQ4MinM; T5-XXL over SD3's 77 tokens):
// `q4_splitk_kernel<G, XN>`, common.cuh's split-K weight-streaming `wgmma`
// GEMM `splitk_gemm` with the register-A nibble widening of the wgmma form
// as its policy (`WidenQ4Rows`): operands swapped (128 weight rows a block
// as the wgmma M, every x row in one tile of XN = 32, 64, 80 or 128 as its
// N), a TMA ring under full / empty mbarriers, K split across the blocks of
// a cluster (1 to 8, by shape: `sdtpu_q4_splits` reports it) and reduced
// through distributed shared memory in split order, one launch and no
// workspace.
#include "common.cuh"

namespace sdtpu {
namespace {

// ------------------------------------------------------- large M: wgmma

constexpr int kQ4MinM = 128;     // calls with at least this many rows take the wgmma kernel
constexpr int kQ4BN = 128;       // weight rows per block: two consumer warpgroups x 64 (wgmma M)
constexpr int kQ4BK = 64;        // K per stage: 32 packed bytes a weight row, 128 bytes an x row
constexpr int kQ4Threads = 384;  // warpgroups 0-1: consumers; 2: producer (its first warp)
constexpr int kQ4WTile = kQ4BN * kQ4BK / 2;         // 4 KB, unswizzled 32-byte rows
constexpr int kQ4STile = kQ4BN * (kQ4BK / 16) * 4;  // f32 scales of one stage, G >= 16
__host__ __device__ constexpr int q4_stages(int bm) { return bm == 256 ? 4 : 8; }
__host__ __device__ constexpr int q4_x_tile(int bm) { return bm * kQ4BK * 2; }  // 128-byte swizzle
constexpr int q4_smem(int bm) {
  return 1024 + q4_stages(bm) * (q4_x_tile(bm) + kQ4WTile + kQ4STile) + 2 * q4_stages(bm) * 8;
}
static_assert(q4_smem(256) <= 232448 && q4_smem(128) <= 232448 && q4_smem(64) <= 232448,
              "q4 wgmma: shared memory over the 227 KB a block may use");

// acc += W_tile . x_tile^T for one k16 step, wgmma N = BM
template <int BM>
__device__ __forceinline__ void wgmma_q4_step(float (&acc)[BM / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  if constexpr (BM == 256) {
    wgmma_m64n256k16_bf16_rs<0>(acc, a, desc_b, 1);
  } else if constexpr (BM == 128) {
    wgmma_m64n128k16_bf16_rs<0>(acc, a, desc_b, 1);
  } else {
    wgmma_m64n64k16_bf16_rs<0>(acc, a, desc_b, 1);
  }
}

// (nibble - 8) as an exact f32: 2^23 + nibble has the nibble in its low
// mantissa bits, and subtracting 2^23 + 8 is exact.
__device__ __forceinline__ float nibble_f32(uint32_t nib) {
  return __fsub_rn(__uint_as_float(0x4B000000u | nib), 8388616.f);
}

// outT[n, m] = W[n, :] . x[m, :] for a kQ4BN x BM tile, W widened in
// registers from the packed nibbles (the wgmma A operand) and x read from
// shared memory (B, K-major).
template <int G, int BM>
__global__ void __launch_bounds__(kQ4Threads, 1)
q4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int m, int n,
                int kp) {
  constexpr int kStages = q4_stages(BM);
  constexpr int kXTile = q4_x_tile(BM);
  constexpr int GPS = kQ4BK / G;  // scale groups a row per stage: 4, 2 or 1
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t x_base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t w_base = x_base + kStages * kXTile;
  const uint32_t s_base = w_base + kStages * kQ4WTile;
  const uint32_t bars = s_base + kStages * kQ4STile;
  const uint8_t* smem = smem_raw - raw;  // generic pointer of shared address 0
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int num_m = (m + BM - 1) / BM;
  const int m0 = (blockIdx.x % num_m) * BM, n0 = (blockIdx.x / num_m) * kQ4BN;
  const int ktiles = kp / kQ4BK;
  const int groups = kp / G;

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA arrival, plus one cp.async arrival per producer lane
      mbar_init(empty(s), 8);      // the consumers' eight warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: the first warp; lane 0 issues the TMA loads of the x and
    // packed tiles, all lanes cp.async the stage's scales
    setmaxnreg_dec<40>();
    if (threadIdx.x < 256 + 32) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(s), kXTile + kQ4WTile);
          tma_load_2d(x_base + s * kXTile, &xmap, full(s), kt * kQ4BK, m0);
          tma_load_2d(w_base + s * kQ4WTile, &wmap, full(s), kt * (kQ4BK / 2), n0);
        }
        for (int idx = lane; idx < kQ4BN * GPS; idx += 32) {
          const int row = n0 + idx / GPS, grp = kt * GPS + idx % GPS;
          const bool valid = row < n && grp < groups;
          const size_t off = valid ? static_cast<size_t>(row) * groups + grp : 0;
          cp_async_4(s_base + s * kQ4STile + idx * 4, scale + off, valid);
        }
        cp_async_mbar_arrive(full(s));
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's weight rows in the tile: r0, r0 + 8

    // The stage's packed tile widened into the register-A layout of four k16
    // steps: a[kk] = {(r0, 2tq..+1), (r0+8, 2tq..+1), (r0, 2tq+8..+9),
    // (r0+8, 2tq+8..+9)} of K columns 16kk..; pair (2tq + 8h) of step kk is
    // byte tq of the row's word 2kk + h.
    auto widen = [&](uint32_t (&a)[4][4], int s) {
      const uint8_t* wt = smem + w_base + s * kQ4WTile;
      const float* sc = reinterpret_cast<const float*>(smem + s_base + s * kQ4STile);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r0 + 8 * rr;
        const uint4 c0 = *reinterpret_cast<const uint4*>(wt + row * (kQ4BK / 2));
        const uint4 c1 = *reinterpret_cast<const uint4*>(wt + row * (kQ4BK / 2) + 16);
        const uint32_t words[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float s = sc[row * GPS + (16 * kk) / G];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t b = (words[2 * kk + h] >> (8 * tq)) & 0xFF;
            a[kk][2 * h + rr] = pack_bf16x2(__fmul_rn(nibble_f32(b & 0xF), s),
                                            __fmul_rn(nibble_f32(b >> 4), s));
          }
        }
      }
    };

    // acc[4j + e]: weight row r0 (+8 for e >= 2), x row 8j + 2tq (+1 for odd e)
    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    uint32_t a0[4][4], a1[4][4];

    // One K stage: issue its four wgmma on `cur`, then, while they run,
    // free the stage before it and widen the next stage into `nxt` (whose
    // previous wgmma group is complete after wait<1>).
    auto step = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4], int kt) {
      const int s = kt % kStages;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_q4_step<BM>(acc, cur[kk], smem_desc_sw128(x_base + s * kXTile + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(nxt[kk]);
      if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % kStages));
      if (kt + 1 < ktiles) {
        const int s1 = (kt + 1) % kStages;
        mbar_wait(full(s1), ((kt + 1) / kStages) & 1);
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

    // epilogue: out[m, n] = acc
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nn = n0 + r0 + 8 * h;
      if (nn >= n) continue;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mm = m0 + 8 * j + 2 * tq + e;
          if (mm < m) out[static_cast<size_t>(mm) * n + nn] = __float2bfloat16_rn(acc[4 * j + 2 * h + e]);
        }
    }
  }
}

// x rows per wgmma block: of 256, 128 and 64, the tile whose grid costs
// least, counted as waves x (BM + 64); a tie keeps the larger tile.
int q4_tile_rows(int m, int n) {
  const long long sms = sm_count();
  const int tiles[3] = {256, 128, 64};
  int best = 256;
  long long best_cost = LLONG_MAX;
  for (int bm : tiles) {
    const long long blocks = static_cast<long long>(ceil_div(n, kQ4BN)) * ceil_div(m, bm);
    const long long cost = (blocks + sms - 1) / sms * (bm + 64);
    if (cost < best_cost) {
      best = bm;
      best_cost = cost;
    }
  }
  return best;
}

template <int BM>
cudaError_t launch_q4_tile(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* scale,
                           __nv_bfloat16* out, int m, int n, int kp, int group, cudaStream_t stream) {
  auto kernel = group == 16   ? q4_wgmma_kernel<16, BM>
                : group == 32 ? q4_wgmma_kernel<32, BM>
                              : q4_wgmma_kernel<64, BM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q4_smem(BM));
  if (err != cudaSuccess) return err;
  const int blocks = ceil_div(n, kQ4BN) * ceil_div(m, BM);
  kernel<<<blocks, kQ4Threads, q4_smem(BM), stream>>>(xmap, wmap, scale, out, m, n, kp);
  return cudaGetLastError();
}

cudaError_t launch_q4_wgmma(const void* x, const void* packed, const float* scale, void* out,
                            int m, int n, int k, int kp, int group, cudaStream_t stream) {
  const int bm = q4_tile_rows(m, n);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t xbox[2] = {kQ4BK, static_cast<cuuint32_t>(bm)};
  cudaError_t err = make_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(kp / 2), static_cast<cuuint64_t>(n)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(kp / 2)};
  const cuuint32_t wbox[2] = {kQ4BK / 2, kQ4BN};
  err = make_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, packed, wdims, wstrides, wbox,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (bm == 256) return launch_q4_tile<256>(xmap, wmap, scale, o, m, n, kp, group, stream);
  if (bm == 128) return launch_q4_tile<128>(xmap, wmap, scale, o, m, n, kp, group, stream);
  return launch_q4_tile<64>(xmap, wmap, scale, o, m, n, kp, group, stream);
}

// ------------------------------------------------------- M <= 8: GEMV

constexpr int kQ4GemvMaxM = kGemvMaxM;  // calls with at most this many rows take the GEMV
constexpr int kQ4GemvWarps = 8;         // warps per block, splitting K
constexpr int kQ4GemvUnroll = 1;        // segments a batch: a warp's loads run a batch ahead

// weight_gemv's policy for packed nibbles: one word, bytes b0..b3 (k = 2i in
// the low nibble of b_i), -> four bf16x2 registers, r[i] = ((low, high)
// nibble of b_i - 8) * s: each (nibble - 8) exact in f32 (the 2^23 trick of
// nibble_f32, one byte_perm a weight), __fmul_rn by the scale, one bf16
// rounding, as q4_wgmma_kernel.  Nibble 8 is q = 0.
struct WidenQ4 {
  static constexpr int kKPerByte = 2;
  static constexpr bool kGroupScale = true, kSumScale = false;
  static constexpr uint32_t kZeroWord = 0x88888888u;
  static __device__ __forceinline__ void widen(uint32_t w, float s, uint32_t (&r)[4]) {
    const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t sel = 0x7440u | i;  // byte i of the nibbles, two zero bytes, then 0x4B
      const float a = __fsub_rn(__uint_as_float(__byte_perm(lo, 0x4B000000u, sel)), 8388616.f);
      const float b = __fsub_rn(__uint_as_float(__byte_perm(hi, 0x4B000000u, sel)), 8388616.f);
      r[i] = pack_bf16x2(__fmul_rn(a, s), __fmul_rn(b, s));
    }
  }
};

template <int G>
__global__ void __launch_bounds__(kQ4GemvWarps * 32)
q4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int m, int n,
               int k, int kp) {
  weight_gemv<WidenQ4, G, kQ4GemvWarps, kQ4GemvUnroll>(x, packed, scale, out, m, n, k, kp);
}

cudaError_t launch_q4_gemv(const void* x, const void* packed, const float* scale, void* out,
                           int m, int n, int k, int kp, int group, cudaStream_t stream) {
  auto kernel = group == 16   ? q4_gemv_kernel<16>
                : group == 32 ? q4_gemv_kernel<32>
                              : q4_gemv_kernel<64>;
  kernel<<<ceil_div(n, kGemvRows), kQ4GemvWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed), scale,
      static_cast<__nv_bfloat16*>(out), m, n, k, kp);
  return cudaGetLastError();
}

// ------------------------------------------------------- 8 < M < 128: split K

// splitk_gemm's policy for packed nibbles, the widening of q4_wgmma_kernel:
// a thread's pair (2tq + 8h) of k16 step kk is byte tq of the row's stage
// word 2kk + h (k = 2j in the low nibble of byte j), each (nibble - 8) exact
// in f32 (nibble_f32), __fmul_rn by the group's scale, one bf16x2 rounding:
// bit-equal to the plain version's weight.  The row's 32 stage bytes are
// read as two 16-byte loads (eight lanes of a phase read two adjacent rows,
// 64 contiguous bytes: no bank conflict).
struct WidenQ4Rows {
  static constexpr int kKPerByte = 2, kRowBytes = kSplitBK / kKPerByte;
  static constexpr bool kSumScale = false;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_NONE;
  template <int G>
  static __device__ __forceinline__ void row_pairs(const uint8_t* tile, int r, const float* srow,
                                                   int tq, uint32_t (&f)[4][2]) {
    const uint8_t* row = tile + r * kRowBytes;
    const uint4 c0 = *reinterpret_cast<const uint4*>(row);
    const uint4 c1 = *reinterpret_cast<const uint4*>(row + 16);
    const uint32_t words[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float s = srow[(16 * kk) / G];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t b = (words[2 * kk + h] >> (8 * tq)) & 0xFF;
        f[kk][h] = pack_bf16x2(__fmul_rn(nibble_f32(b & 0xF), s), __fmul_rn(nibble_f32(b >> 4), s));
      }
    }
  }
};

template <int G, int XN>
__global__ void __launch_bounds__(kSplitThreads, 1)
q4_splitk_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int m, int n,
                 int k, int kp, int splits) {
  splitk_gemm<WidenQ4Rows, G, XN>(&xmap, &wmap, scale, out, m, n, k, kp, splits);
}

template <int XN>
SplitKKernel q4_splitk_for(int group) {
  return group == 16 ? q4_splitk_kernel<16, XN> : group == 32 ? q4_splitk_kernel<32, XN>
                                                             : q4_splitk_kernel<64, XN>;
}

// The split count a call of m rows takes at n x k: a function of the shape
// (and the card) alone (the groups' kernels share their shared memory and
// threads).
int q4_splits(int m, int n, int k) {
  return with_splitk_cols(m, [&](auto xn) {
    constexpr int XN = decltype(xn)::value;
    return splitk_splits_for<SplitKSmem<WidenQ4Rows, XN>>(
        reinterpret_cast<const void*>(q4_splitk_for<XN>(64)), n, ceil_div(k, kSplitBK));
  });
}

cudaError_t launch_q4_splitk(const void* x, const void* packed, const float* scale, void* out,
                             int m, int n, int k, int kp, int group, cudaStream_t stream) {
  const int splits = q4_splits(m, n, k);
  return with_splitk_cols(m, [&](auto xn) {
    constexpr int XN = decltype(xn)::value;
    return launch_splitk<WidenQ4Rows>(q4_splitk_for<XN>(group), SplitKSmem<WidenQ4Rows, XN>::kBytes,
                                      XN, x, packed, scale, out, m, n, k, kp, splits, stream);
  });
}

// ------------------------------------------------------- float32 x: split-x TF32

// common.cuh's split-x TF32 tile `f32_quant_gemm` with this widening: a
// lane's two packed bytes at 8p + 2tq of a stage row hold its four weights
// of the 16-k block p (k = 16p + 4tq .. + 3, low nibble first), each (nibble
// - 8) exact as a float (nibble_f32), which is a valid tf32; the group's
// scale multiplies the group's float32 sum.  Rows of 32 bytes a stage,
// padded to 48 so the eight rows one load reads start 12 banks apart.
template <int G>
struct WidenQ4F32 {
  static constexpr int kKPerByte = 2, kRowStride = 48, kG = G;
  static constexpr bool kGroupScale = true, kZero = false, kSumScale = false;
  static __device__ __forceinline__ void fragment(const uint8_t* row, int p, int tq, uint32_t (&b)[4]) {
    const uint32_t v = *reinterpret_cast<const uint16_t*>(row + 8 * p + 2 * tq);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = __float_as_uint(nibble_f32((v >> (4 * i)) & 0xF));
  }
};

template <int G, int BM>
__global__ void __launch_bounds__(F32QSmem<WidenQ4F32<G>, BM>::kThreads, 1)
q4_gemm_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale, const float* __restrict__ zero,
                   float* __restrict__ out, int m, int n, int k, int kp) {
  f32_quant_gemm<WidenQ4F32<G>, BM>(x, packed, scale, zero, out, m, n, k, kp);
}

template <int G>
cudaError_t launch_q4_f32_group(const void* x, const void* packed, const float* scale, void* out,
                                int m, int n, int k, int kp, cudaStream_t stream) {
  return launch_f32q<WidenQ4F32<G>>(q4_gemm_f32_kernel<G, 16>, q4_gemm_f32_kernel<G, 64>,
                                    q4_gemm_f32_kernel<G, 128>, x, packed, scale, nullptr, out, m, n,
                                    k, kp, stream);
}

cudaError_t launch_q4_f32(const void* x, const void* packed, const float* scale, void* out, int m,
                          int n, int k, int kp, int group, cudaStream_t stream) {
  if (group == 16) return launch_q4_f32_group<16>(x, packed, scale, out, m, n, k, kp, stream);
  if (group == 32) return launch_q4_f32_group<32>(x, packed, scale, out, m, n, k, kp, stream);
  return launch_q4_f32_group<64>(x, packed, scale, out, m, n, k, kp, stream);
}

// The form a call takes, by dtype and the row count alone: 0 the GEMV, 1 the
// split-K form, 2 the wgmma kernel (bf16), 3 the float32 kernel (every M);
// -1 a dtype no kernel takes.
int q4_form(int dtype, int m) {
  if (dtype == kF32) return 3;
  if (dtype != kBF16) return -1;
  return m <= kQ4GemvMaxM ? 0 : m < kQ4MinM ? 1 : 2;
}

}  // namespace
}  // namespace sdtpu

// x [m, k] in `dtype` (bf16 or f32); packed uint8 [n, kp/2]; scale f32
// [n, kp/group] -> out [m, n] in `dtype`.  Needs k <= kp, k % 8 == 0, kp % 64
// == 0 and group 16, 32 or 64.  float32 x takes the split-x TF32 form at every M;
// bf16 with M <= kQ4GemvMaxM the GEMV, M >= kQ4MinM the wgmma kernel, M
// between them the split-K form: the choice is by dtype and shape only, and
// a refused launch is returned, never retried on another form.
extern "C" int sdtpu_q4_matmul(int dtype, const void* x, const void* packed, const void* scale,
                               void* out, int m, int n, int k, int kp, int group,
                               void* stream) {
  using namespace sdtpu;
  if (m <= 0 || n <= 0 || k <= 0 || k > kp || k % 8 || kp % kQ4BK ||
      (group != 16 && group != 32 && group != 64))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (q4_form(dtype, m)) {
    case 0:
      return launch_q4_gemv(x, packed, sc, out, m, n, k, kp, group, s);
    case 1:
      return launch_q4_splitk(x, packed, sc, out, m, n, k, kp, group, s);
    case 2:
      return launch_q4_wgmma(x, packed, sc, out, m, n, k, kp, group, s);
    case 3:
      return launch_q4_f32(x, packed, sc, out, m, n, k, kp, group, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The x rows per block of the float32 form (common.cuh's f32_quant_gemm,
// in this library for the 4-bit and the int8 matmuls alike) at m x n.
extern "C" long long sdtpu_f32_tile_rows(int m, int n) {
  using namespace sdtpu;
  return m > 0 && n > 0 ? f32q_tile_rows(m, n) : 0;
}

// The x rows per block `sdtpu_q4_matmul` gives the wgmma kernel at this
// shape of bf16 x (0 below kQ4MinM, where the GEMV or the split-K form runs).
extern "C" long long sdtpu_q4_tile_rows(int m, int n) {
  using namespace sdtpu;
  return m >= kQ4MinM && n > 0 ? q4_tile_rows(m, n) : 0;
}

// The splits of K `sdtpu_q4_matmul` gives the split-K form at m x k -> n of
// bf16 x (1 to 8, the blocks of a cluster; 0 where another form runs).
extern "C" long long sdtpu_q4_splits(int m, int n, int k) {
  using namespace sdtpu;
  return m > kQ4GemvMaxM && m < kQ4MinM && n > 0 && k > 0 ? q4_splits(m, n, k) : 0;
}

// The form `sdtpu_q4_matmul` runs for m rows of x in `dtype`: 0 the GEMV,
// 1 the split-K form, 2 the wgmma kernel, 3 the float32 kernel (-1: no
// kernel takes the dtype).
extern "C" long long sdtpu_q4_form(int dtype, int m) { return sdtpu::q4_form(dtype, m); }
