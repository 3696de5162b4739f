// Flash attention for Hopper: softmax(q.k^T * scale + bias) . v
//
// Replaces the TPU kernels `_flash_kernel` (sdtpu/ops/flash_attention.py:51)
// and `_flash_kernel_whole_chunked` (:129).  On the TPU the two differ only
// in how much of K/V is held in VMEM; here one kernel covers both: a block
// owns (batch*head, 64 query rows, one slice of the output head dim) and
// walks the keys in 64-key tiles in a loop, which takes the place of the
// TPU's sequential KV grid axis.  The online softmax (running max m, sum l,
// accumulator acc) stays in registers in f32 and runs in exp2 with log2(e)
// folded into the score scale, as on the TPU.
//
// What bounds it on the card: at the FLUX shapes (L = 4352 or 1280, D = 128)
// attention is compute bound -- 4*L^2*D FLOPs against 4*L*D bytes per head.
// The bf16 kernel keeps both products on the tensor cores (mma.sync
// m16n8k16, f32 accumulate) and never writes the L x L scores to device
// memory.  It is the simple form: tiles are loaded synchronously, with no
// cp.async/TMA pipelining and no wgmma; those are later work.
//
// Head dims 64 and 128 keep the whole output row block in registers.  For
// D = 512 (the VAE mid-block) a register accumulator of 16 x 512 per warp
// does not fit, so the grid gains a third axis that tiles the output head
// dim into 128-wide slices: each block recomputes the scores over the full
// D and multiplies P by its own 128 columns of V.
//
// Rows past Lq and keys past Lk are handled in the kernel (zero-filled
// loads, keys masked to -inf); there are no padding copies.  The optional
// additive bias is a dense f32 [Lq, Lk] matrix shared by every batch*head.
//
// The f32 kernel is the parity variant: plain FMA arithmetic, one thread per
// query row, Q stored transposed in shared memory.  It is slow by design.
#include "common.cuh"

#include <math.h>

namespace sdtpu {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;

// ---------------------------------------------------------------- bf16

constexpr int kBQ = 64;    // query rows per block: 4 warps x 16 rows
constexpr int kBK = 64;    // keys per tile
constexpr int kPad = 8;    // bf16 row padding (16 bytes): conflict-free fragments
constexpr int kThreads = 128;

template <int D, int DV>
constexpr int bf16_smem_bytes() {
  return (kBQ * (D + kPad) + kBK * (D + kPad) + DV * (kBK + kPad)) * 2;
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ o, int lq, int lk,
                  float scale_log2) {
  static_assert(D % 16 == 0 && DV % 16 == 0 && D % DV == 0, "head dim tiling");
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

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const float* bias, void* o, int bh, int lq, int lk,
                        float scale_log2, cudaStream_t stream) {
  constexpr int DV = D < 128 ? D : 128;
  constexpr int smem = bf16_smem_bytes<D, DV>();
  auto kernel = flash_bf16_kernel<D, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(lq, kBQ), bh, D / DV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(o),
      lq, lk, scale_log2);
  return cudaGetLastError();
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
      case 64: return launch_bf16<64>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 128: return launch_bf16<128>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
      case 512: return launch_bf16<512>(q, k, v, bias, o, bh, lq, lk, scale_log2, s);
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
