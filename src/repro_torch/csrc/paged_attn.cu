// Fused GQA decode attention over a quantized KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_attn_pallas.
// One block per (slot b, kv head h) reads its own block-table row and walks
// the slot's pages in order (the TPU grid's sequential page axis becomes a
// loop in the block). The G = Hq / Hkv query heads of the kv head share every
// page read; query head h * G + g maps to kv head h.
//
// Numerics follow the reference twin step for step:
//   * dequantization is (int * scale) -> __float2bfloat16_rn -> f32, the
//     rounding of models/attention.py::kv_dequantize; kv4 unpacks the signed
//     little-endian nibbles; the bf16 cell reads the stored bf16 directly;
//   * scores are dot(q, k) * (1 / sqrt(D)), masked to kpos <= pos[b] and the
//     sliding window (window > 0), masked scores are BIG_NEG and their
//     probabilities are exactly 0.0;
//   * running softmax per page: m' = max(m, max s), p = exp(s - m'),
//     alpha = exp(m - m'), l = l * alpha + sum p, acc = acc * alpha + p . v;
//     expf (not __expf), no fast math; the output is acc / max(l, 1e-30).
//   * pages past the last valid position and pages the window has slid past
//     are skipped: a fully masked page leaves m, l and acc exactly unchanged.
//
// Bound on this card: decode attention reads each valid K/V page once
// (int8 rows plus one f32 scale per token and head) and does ~4 * G * D
// flops per token, far below the card's rate: it is bound by bytes, and at
// serving batch sizes by launch and per-page synchronisation latency. Design:
// a page is staged dequantized in shared memory once for all G heads; the
// work per page is split over the block's threads (scores by (g, token),
// the accumulator by (g, d)). Simple first version: one block per
// (slot, kv head), no split over pages, no asynchronous copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float BIG_NEG = -2.0e9f;

// BITS: 16 = bf16 storage, 8 = int8, 4 = packed int4.
template <int BITS>
__device__ __forceinline__ float dequant(const void* base, const float* scales,
                                         long long row, int D, int d) {
  if constexpr (BITS == 16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[row * D + d]);
  } else if constexpr (BITS == 8) {
    const float q = (float)static_cast<const int8_t*>(base)[row * D + d];
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(q, scales[row])));
  } else {
    const uint8_t byte = static_cast<const uint8_t*>(base)[row * (D / 2) + d / 2];
    const int u = (byte >> ((d & 1) * 4)) & 0xF;
    const float q = (float)((u ^ 8) - 8);
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(q, scales[row])));
  }
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const float* __restrict__ q, const void* __restrict__ k,
                  const float* __restrict__ ks, const void* __restrict__ v,
                  const float* __restrict__ vs, const int* __restrict__ pos,
                  const int* __restrict__ bt, float* __restrict__ out, int Hq, int Hkv,
                  int D, int ps, int nb, int window, float scale) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qs = smem;           // (G, D)
  float* acc = qs + G * D;    // (G, D)
  float* kf = acc + G * D;    // (ps, D) dequantized K page
  float* vf = kf + ps * D;    // (ps, D) dequantized V page
  float* sc = vf + ps * D;    // (G, ps) scores, then probabilities
  float* m = sc + G * ps;     // (G,)
  float* l = m + G;           // (G,)
  float* al = l + G;          // (G,) this page's alpha

  const float* qb = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = qb[i];
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m[g] = BIG_NEG;
    l[g] = 0.0f;
  }
  const int p_last = pos[b];

  for (int j = 0; j < nb; ++j) {
    const int k0 = j * ps;
    if (k0 > p_last) break;  // this and every later page is fully masked
    if (window > 0 && p_last - (k0 + ps - 1) >= window) continue;  // slid past
    const long long page = bt[(long long)b * nb + j];
    __syncthreads();  // previous page's readers are done with kf/vf/sc
    for (int i = tid; i < ps * D; i += THREADS) {
      const int t = i / D;
      const int d = i - t * D;
      const long long row = (page * ps + t) * Hkv + h;
      kf[i] = dequant<BITS>(k, ks, row, D, d);
      vf[i] = dequant<BITS>(v, vs, row, D, d);
    }
    __syncthreads();
    for (int i = tid; i < G * ps; i += THREADS) {
      const int g = i / ps;
      const int t = i - g * ps;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(qs[g * D + d], kf[t * D + d], s);
      s = __fmul_rn(s, scale);
      const int kpos = k0 + t;
      bool valid = kpos <= p_last;
      if (window > 0) valid = valid && (p_last - kpos) < window;
      sc[i] = valid ? s : BIG_NEG;
    }
    __syncthreads();
    for (int g = tid; g < G; g += THREADS) {
      float mx = m[g];
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[g * ps + t]);
      float sum = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const int kpos = k0 + t;
        bool valid = kpos <= p_last;
        if (window > 0) valid = valid && (p_last - kpos) < window;
        const float p = valid ? expf(sc[g * ps + t] - mx) : 0.0f;
        sc[g * ps + t] = p;
        sum = __fadd_rn(sum, p);
      }
      const float alpha = expf(m[g] - mx);
      l[g] = __fadd_rn(__fmul_rn(l[g], alpha), sum);
      al[g] = alpha;
      m[g] = mx;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      float pv = 0.0f;
      for (int t = 0; t < ps; ++t) pv = fmaf(sc[g * ps + t], vf[t * D + d], pv);
      acc[i] = __fadd_rn(__fmul_rn(acc[i], al[g]), pv);
    }
  }
  __syncthreads();
  float* ob = out + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS) ob[i] = acc[i] / fmaxf(l[i / D], 1e-30f);
}

template <int BITS>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* pos, const void* bt, void* out, int B, int Hq, int Hkv, int D,
           int ps, int nb, int window, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * (size_t)(2 * G * D + 2 * ps * D + G * ps + 3 * G);
  cudaError_t e = cudaFuncSetAttribute(paged_attn_kernel<BITS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  paged_attn_kernel<BITS><<<B * Hkv, THREADS, smem, stream>>>(
      static_cast<const float*>(q), k, static_cast<const float*>(ks), v,
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<const int*>(bt), static_cast<float*>(out), Hq, Hkv, D, ps, nb, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, D) f32; k, v (P, ps, Hkv, D * bits / 8) int8, or bf16 when
// bits == 16; ks, vs (P, ps, Hkv) f32 (ignored for bf16); pos (B,) int32;
// bt (B, nb) int32; out (B, Hq, D) f32. window <= 0 means no window.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_attn_launch(const void* q, const void* k, const void* ks, const void* v,
                                 const void* vs, const void* pos, const void* bt, void* out,
                                 int B, int Hq, int Hkv, int D, int ps, int nb, int bits,
                                 int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 16:
      return launch<16>(q, k, ks, v, vs, pos, bt, out, B, Hq, Hkv, D, ps, nb, window, scale, s);
    case 8:
      return launch<8>(q, k, ks, v, vs, pos, bt, out, B, Hq, Hkv, D, ps, nb, window, scale, s);
    case 4:
      return launch<4>(q, k, ks, v, vs, pos, bt, out, B, Hq, Hkv, D, ps, nb, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
