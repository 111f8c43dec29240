// What the two split-page decode attention kernels share (paged_attn.cu,
// GQA; paged_mla_attn.cu, absorbed MLA): which pages of a slot hold a
// visible key, the staging copies, the dequantization of staged codes into
// bf16 rows, and the merge of the splits' partials. qkv_decode.cu (dense
// cache, split over runs of keys) takes the staging copies and the merge.
//
// Both kernels split a slot's page walk into runs of PPS pages (each file's
// own compile-time constant) and write one partial a (slot, head group,
// split): acc (G, D) f32, then m (G) and l (G), G * (D + 2) floats, at
// part + ((b * Hkv + h) * nsplit + split) * G * (D + 2). The merge combines
// the splits that hold a visible key in split order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged_split {

constexpr float BIG_NEG = -2.0e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MERGE_THREADS = 256;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Pages [lo, hi] of a slot that hold a visible key: keys 0..pos, and with a
// window only keys past pos - window. Empty (lo > hi) when pos < 0 or the
// window has slid past the table.
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span visible_pages(int pos, int window, int ps, int nb) {
  Span s{0, -1};
  if (pos < 0) return s;
  s.hi = min(nb - 1, pos / ps);
  if (window > 0 && pos - window + 1 > 0) s.lo = (pos - window + 1) / ps;
  return s;
}

__device__ __forceinline__ bool visible(int kpos, int pos, int window) {
  return kpos <= pos && (window <= 0 || pos - kpos < window);
}

// the 32-bit word w's low and high bf16 as f32
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// code e of a 32-bit word of int8 (e < 4) or signed little-endian int4
// (e < 8) codes as an exact f32, without the quarter-rate I2F: the biased
// code (code + 128, or + 8 for a nibble) in the low mantissa bits of 2^23,
// minus 2^23 + bias
template <int BITS>
__device__ __forceinline__ float code_f32(uint32_t w, int e) {
  if constexpr (BITS == 8) {
    const uint32_t biased = ((w >> (e * 8)) & 0xFFu) ^ 0x80u;
    return __fsub_rn(__uint_as_float(0x4B000000u | biased), 8388736.0f);
  } else {
    const uint32_t biased = ((w >> (e * 4)) & 0xFu) ^ 0x8u;
    return __fsub_rn(__uint_as_float(0x4B000000u | biased), 8388616.0f);
  }
}

// Dequantize one staged 16-byte vector of codes of a row with scale s,
// (code * s) -> bf16 (round to nearest even), into 16 * 8 / BITS bf16 at dst
// (16-byte aligned).
template <int BITS>
__device__ __forceinline__ void dequant_vec(const uint4& raw, float s, unsigned char* dst) {
  constexpr int EPV = 128 / BITS;
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  constexpr int EPW = 32 / BITS;  // codes a 32-bit word
  uint32_t o[EPV / 2];
#pragma unroll
  for (int e = 0; e < EPV; e += 2) {
    const __nv_bfloat162 h =
        __floats2bfloat162_rn(__fmul_rn(code_f32<BITS>(w[e / EPW], e % EPW), s),
                              __fmul_rn(code_f32<BITS>(w[(e + 1) / EPW], (e + 1) % EPW), s));
    o[e / 2] = *reinterpret_cast<const uint32_t*>(&h);
  }
#pragma unroll
  for (int u = 0; u < EPV / 8; ++u)
    reinterpret_cast<uint4*>(dst)[u] = make_uint4(o[4 * u], o[4 * u + 1], o[4 * u + 2],
                                                  o[4 * u + 3]);
}

// copy VB bytes global -> shared: cp.async for 16 / 8 / 4, a plain byte
// copy for 1
template <int VB>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (VB == 1) {
    *static_cast<unsigned char*>(dst) = *static_cast<const unsigned char*>(src);
  } else {
    const uint32_t sa = (uint32_t)__cvta_generic_to_shared(dst);
    if constexpr (VB == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa), "l"(src), "n"(VB));
  }
}

// The merge of one output value i (head g) of a group: its splits s0..s1,
// each a partial at pb + s * G * (D + 2), in split order: M = max m_i,
// l = sum l_i * exp(m_i - M), acc = sum acc_i * exp(m_i - M), out = acc /
// max(l, 1e-30). No atomics: the same bits on every call, whatever the grid.
__device__ __forceinline__ float merge_splits(const float* __restrict__ pb, int G, int D, int g,
                                              int i, int s0, int s1) {
  const long long stride = (long long)G * (D + 2);
  float M = BIG_NEG;
#pragma unroll 4
  for (int s = s0; s <= s1; ++s) M = fmaxf(M, pb[s * stride + G * D + g]);
  float l = 0.0f, acc = 0.0f;
#pragma unroll 4
  for (int s = s0; s <= s1; ++s) {
    const float* p = pb + s * stride;
    const float e = expf(__fsub_rn(p[G * D + g], M));
    l = __fadd_rn(l, __fmul_rn(p[G * D + G + g], e));
    acc = __fadd_rn(acc, __fmul_rn(p[i], e));
  }
  return acc / fmaxf(l, 1e-30f);
}

// Merge, one thread an output value: block (b * Hkv + h, y) takes values
// y * MERGE_THREADS.. of the group's G * D. Only the splits that hold a
// visible key (decided again from pos and window) take part, in split order
// (merge_splits). A slot with no visible key gives 0, as the plain versions
// do. out (B, H, D): group h's head g is out head h * G + g, written only
// below H (the MLA kernel pads its last group).
template <int PPS>
__global__ void __launch_bounds__(MERGE_THREADS)
paged_attn_merge_kernel(const float* __restrict__ part, const int* __restrict__ pos,
                        float* __restrict__ out, int H, int Hkv, int G, int D, int ps, int nb,
                        int nsplit, int window) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int i = blockIdx.y * MERGE_THREADS + threadIdx.x;
  if (i >= G * D) return;
  const int g = i / D;
  if (h * G + g >= H) return;
  const Span vis = visible_pages(pos[b], window, ps, nb);
  const int s0 = vis.lo <= vis.hi ? vis.lo / PPS : 0;
  const int s1 = vis.lo <= vis.hi ? vis.hi / PPS : -1;
  const float* pb = part + (long long)blockIdx.x * nsplit * G * (D + 2);
  out[((long long)b * H + (long long)h * G) * D + i] = merge_splits(pb, G, D, g, i, s0, s1);
}

// Launch the merge over B slots of Hkv groups of G heads of width D.
template <int PPS>
inline cudaError_t launch_merge(const float* part, const int* pos, float* out, int B, int H,
                                int Hkv, int G, int D, int ps, int nb, int nsplit, int window,
                                cudaStream_t stream) {
  const dim3 grid(B * Hkv, (G * D + MERGE_THREADS - 1) / MERGE_THREADS);
  paged_attn_merge_kernel<PPS><<<grid, MERGE_THREADS, 0, stream>>>(part, pos, out, H, Hkv, G, D,
                                                                   ps, nb, nsplit, window);
  return cudaGetLastError();
}

}  // namespace paged_split
