// Fused absorbed Multi-head Latent Attention (MLA) decode over a compressed
// latent page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_mla_attn_pallas.
// One query token per slot. Every head h scores its absorbed query q_lat[h]
// (q_nope . W_uk, C = kv_lora wide) against the slot's latent rows c and its
// rotary query q_rope[h] against the rope-key rows r, which all heads share
// (one latent row and one rope row per token), and accumulates the context
// in latent space: out (B, H, C), to which the caller applies W_uv.
//
// Numerics follow the reference twin (paged_mla_attn_ref) step for step:
//   * c is dequantized as (int * scale) -> __float2bfloat16_rn -> f32, the
//     rounding of models/attention.py::kv_dequantize; kv4 unpacks the signed
//     little-endian nibbles; the bf16 cell and r read the stored bf16;
//   * s = (q_lat . c + q_rope . r) * scale, masked to kpos <= pos[b]; masked
//     scores are BIG_NEG and their probabilities exactly 0.0;
//   * running softmax per page: m' = max(m, max s), p = exp(s - m'),
//     alpha = exp(m - m'), l = l * alpha + sum p, acc = acc * alpha + p . c;
//     expf (not __expf), __fmul_rn / __fadd_rn outside the dots, no fast
//     math; the output is acc / max(l, 1e-30). Kernel and twin differ only in
//     the order of the f32 sums inside a dot.
//   * pages past the last valid position are skipped: a fully masked page
//     leaves m, l and acc exactly unchanged.
//
// Bound on this card: per cached row and head the kernel does
// 2 * (C + dr) flops for the score and 2 * C for the context, in f32 (2176
// at DeepSeek-V3's widths), while the row it reads is C bytes of latent
// (kv8), a 4-byte scale and 2 * dr bytes of rope key (644 bytes). With 128
// heads that is ~430 flops per byte, far above the card's f32 rate over its
// memory rate (67 TFLOP/s / 3.35 TB/s = 20), so f32 work, not bytes, bounds
// it. The TPU kernel keeps one slot's whole (H, C) accumulator in VMEM; at
// H = 128, C = 512 that is 256 KB, more than a block's 227 KB of shared
// memory. So heads are split over blocks: one block per (slot, group of
// HB = 4 heads), 128 blocks for 4 slots of DeepSeek-V3, about one per SM.
// Each block re-reads its slot's pages (from L2 after the first group): a
// page is staged dequantized in shared memory with 16-byte loads (two per
// thread for a kv8 page), so the latent rows must be whole 16-byte vectors
// (C * bits % 128 == 0, dr % 8 == 0, 16-byte aligned pools; the wrapper
// checks). The kernel is bound by latency, not by its shared-memory
// traffic: with 16 heads per block (32 blocks) and one load per element,
// the three calls of a DeepSeek-V3 decode step took 2.74 ms against 1.11 ms
// now (chip_smoke.py's step breakdown, H100 80GB HBM3 at 700 W). Rows are
// padded in shared memory to an odd stride, so the score loop (one thread
// per (head, token)) is free of bank conflicts. No tensor cores, no
// asynchronous copies, no split over pages yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HB = 4;  // heads per block
constexpr int VMAX = 4;  // 16-byte loads in flight per thread
constexpr float BIG_NEG = -2.0e9f;
constexpr size_t MAX_SMEM = 232448;  // a block's opt-in shared memory on sm_90

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One 16-byte vector of a stored row -> 128 / BITS f32 values at dst:
// bf16 widens exactly; int8 and signed little-endian int4 scale, then round
// through bf16 (kv_dequantize's rounding).
template <int BITS>
__device__ __forceinline__ void store_dequant(uint4 raw, float scale, float* dst) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (BITS == 16) {
      dst[2 * k] = __uint_as_float(w[k] << 16);
      dst[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    } else if constexpr (BITS == 8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float q = (float)(int8_t)((w[k] >> (8 * e)) & 0xFF);
        dst[4 * k + e] = round_bf16(__fmul_rn(q, scale));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int u = (w[k] >> (4 * e)) & 0xF;
        dst[8 * k + e] = round_bf16(__fmul_rn((float)((u ^ 8) - 8), scale));
      }
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
paged_mla_attn_kernel(const float* __restrict__ ql, const float* __restrict__ qr,
                      const void* __restrict__ cq, const float* __restrict__ cs,
                      const __nv_bfloat16* __restrict__ r, const int* __restrict__ pos,
                      const int* __restrict__ bt, float* __restrict__ out, int H, int C,
                      int dr, int ps, int nb, float scale) {
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * HB;
  const int nh = min(HB, H - h0);
  const int tid = threadIdx.x;
  const int CP = C + 1;   // padded shared row strides (odd: no bank conflicts)
  const int RP = dr + 1;

  extern __shared__ float smem[];
  float* qls = smem;             // (HB, CP) absorbed queries
  float* acc = qls + HB * CP;    // (HB, C) latent context
  float* cf = acc + HB * C;      // (ps, CP) dequantized latent page
  float* qrs = cf + ps * CP;     // (HB, RP) rotary queries
  float* rf = qrs + HB * RP;     // (ps, RP) rope-key page
  float* sc = rf + ps * RP;      // (HB, ps) scores, then probabilities
  float* m = sc + HB * ps;       // (HB,)
  float* l = m + HB;             // (HB,)
  float* al = l + HB;            // (HB,) this page's alpha

  const long long q0 = (long long)b * H + h0;
  for (int i = tid; i < HB * C; i += THREADS) {
    const int g = i / C;
    const int c = i - g * C;
    qls[g * CP + c] = g < nh ? ql[(q0 + g) * C + c] : 0.0f;
    acc[i] = 0.0f;
  }
  for (int i = tid; i < HB * dr; i += THREADS) {
    const int g = i / dr;
    const int d = i - g * dr;
    qrs[g * RP + d] = g < nh ? qr[(q0 + g) * dr + d] : 0.0f;
  }
  for (int g = tid; g < HB; g += THREADS) {
    m[g] = BIG_NEG;
    l[g] = 0.0f;
  }
  const int p_last = pos[b];

  for (int j = 0; j < nb; ++j) {
    const int k0 = j * ps;
    if (k0 > p_last) break;  // this and every later page is fully masked
    const long long page = bt[(long long)b * nb + j];
    __syncthreads();  // previous page's readers are done with cf/rf/sc
    // 16-byte loads, up to VMAX per thread in flight before any is used
    const int vpr = C * BITS / 128;  // 16-byte vectors per latent row
    const uint4* src = static_cast<const uint4*>(cq) + page * ps * vpr;
    for (int v0 = 0; v0 < ps * vpr; v0 += VMAX * THREADS) {
      uint4 raw[VMAX];
      float scl[VMAX];
#pragma unroll
      for (int u = 0; u < VMAX; ++u) {
        const int v = v0 + u * THREADS + tid;
        if (v < ps * vpr) {
          raw[u] = __ldg(src + v);
          scl[u] = BITS == 16 ? 0.0f : __ldg(cs + page * ps + v / vpr);
        }
      }
#pragma unroll
      for (int u = 0; u < VMAX; ++u) {
        const int v = v0 + u * THREADS + tid;
        if (v < ps * vpr) {
          store_dequant<BITS>(raw[u], scl[u], cf + (v / vpr) * CP + (v % vpr) * (128 / BITS));
        }
      }
    }
    const int rpr = dr / 8;  // 16-byte vectors (8 bf16) per rope row
    const uint4* rsrc = reinterpret_cast<const uint4*>(r) + page * ps * rpr;
    for (int v = tid; v < ps * rpr; v += THREADS) {
      store_dequant<16>(__ldg(rsrc + v), 0.0f, rf + (v / rpr) * RP + (v % rpr) * 8);
    }
    __syncthreads();
    for (int i = tid; i < HB * ps; i += THREADS) {
      const int g = i / ps;
      const int t = i - g * ps;
      float s_lat = 0.0f;
      float s_rope = 0.0f;
      for (int c = 0; c < C; ++c) s_lat = fmaf(qls[g * CP + c], cf[t * CP + c], s_lat);
      for (int d = 0; d < dr; ++d) s_rope = fmaf(qrs[g * RP + d], rf[t * RP + d], s_rope);
      const float s = __fmul_rn(__fadd_rn(s_lat, s_rope), scale);
      sc[i] = (k0 + t <= p_last) ? s : BIG_NEG;
    }
    __syncthreads();
    for (int g = tid; g < nh; g += THREADS) {
      float mx = m[g];
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[g * ps + t]);
      float sum = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const float p = (k0 + t <= p_last) ? expf(sc[g * ps + t] - mx) : 0.0f;
        sc[g * ps + t] = p;
        sum = __fadd_rn(sum, p);
      }
      const float alpha = expf(m[g] - mx);
      l[g] = __fadd_rn(__fmul_rn(l[g], alpha), sum);
      al[g] = alpha;
      m[g] = mx;
    }
    __syncthreads();
    for (int i = tid; i < nh * C; i += THREADS) {
      const int g = i / C;
      const int c = i - g * C;
      float pc = 0.0f;
      for (int t = 0; t < ps; ++t) pc = fmaf(sc[g * ps + t], cf[t * CP + c], pc);
      acc[i] = __fadd_rn(__fmul_rn(acc[i], al[g]), pc);
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * C; i += THREADS) {
    out[q0 * C + i] = acc[i] / fmaxf(l[i / C], 1e-30f);
  }
}

template <int BITS>
int launch(const void* ql, const void* qr, const void* cq, const void* cs, const void* r,
           const void* pos, const void* bt, void* out, int B, int H, int C, int dr, int ps,
           int nb, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)HB * (C + 1) + (size_t)HB * C +
                                       (size_t)ps * (C + 1) + (size_t)HB * (dr + 1) +
                                       (size_t)ps * (dr + 1) + (size_t)HB * ps + 3 * HB);
  if (smem > MAX_SMEM || (C * BITS) % 128 || dr % 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(paged_mla_attn_kernel<BITS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B, (H + HB - 1) / HB);
  paged_mla_attn_kernel<BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(ql), static_cast<const float*>(qr), cq,
      static_cast<const float*>(cs), static_cast<const __nv_bfloat16*>(r),
      static_cast<const int*>(pos), static_cast<const int*>(bt), static_cast<float*>(out), H, C,
      dr, ps, nb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ql (B, H, C) f32; qr (B, H, dr) f32; cq (P, ps, 1, C * bits / 8) int8, or
// bf16 when bits == 16; cs (P, ps, 1) f32 (ignored for bf16); r (P, ps, 1, dr)
// bf16; pos (B,) int32; bt (B, nb) int32; out (B, H, C) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_mla_attn_launch(const void* ql, const void* qr, const void* cq,
                                     const void* cs, const void* r, const void* pos,
                                     const void* bt, void* out, int B, int H, int C, int dr,
                                     int ps, int nb, int bits, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 16:
      return launch<16>(ql, qr, cq, cs, r, pos, bt, out, B, H, C, dr, ps, nb, scale, s);
    case 8:
      return launch<8>(ql, qr, cq, cs, r, pos, bt, out, B, H, C, dr, ps, nb, scale, s);
    case 4:
      return launch<4>(ql, qr, cq, cs, r, pos, bt, out, B, H, C, dr, ps, nb, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
