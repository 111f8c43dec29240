// Decode attention over a dense int8 / packed int4 KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/qkv_decode.py::qkv_decode_pallas.
// The TPU grid (B, Hq, ns) walks the key blocks of one query head in order,
// with the running softmax in VMEM scratch, and reads every K/V block once
// per query head. Here a block owns one (batch b, kv head h) and one run of
// keys, and serves all G = Hq / Hkv query heads of the group (query head
// h * G + g reads kv head h), so each K/V row leaves device memory once.
//
// Numerics follow the Pallas kernel:
//   * dequantization in f32: __fmul_rn((float)code, scale), one rounding
//     (no bf16 step, unlike paged_attn; the code's exact f32 by paged_split's
//     2^23 trick, not the quarter-rate I2F); kv4 unpacks the signed
//     little-endian nibbles (core/pack.py unpack(signed=True));
//   * s = dot(q, k) * scale; keys with index > pos score BIG_NEG (pos < 0
//     masks every key), keys past S are absent (probability 0);
//   * softmax from m = BIG_NEG, l = 0, acc = 0: m' = max(m, max s),
//     p = exp(s - m'), l = sum p, acc = sum p . v; expf (no fast math);
//     out = acc / max(l, 1e-30), f32. With pos < 0 every p is 1: the mean
//     of v over all S keys.
//
// Bound on this card: one decode step reads every visible K/V code once
// (B * S * Hkv * D * bits / 8 bytes each) plus two f32 scales a token and
// head, and does 4 * Hq * D flops a key: about G flops a byte at kv8, far
// below the card's ratio, so device-memory bytes bound it (2.6 us at
// internlm2's B 4, S 1024, kv8). What costs is latency: the first design
// (one block per (b, h) walking 16 tiles of 64 keys in order, one thread's
// serial FMA chain of 128 a score and of 64 an output; 32 blocks on 132
// SMs) took 0.05498 ms a call at kv8 on an H100 80GB HBM3 at 700 W
// (PERF.md row 11). Design:
//   1. The key walk is split over blocks, as paged_attn.cu's page walk: the
//      grid is B * Hkv * nsplit, nsplit = ceil(S / KPS), each split a run of
//      KPS keys (a compile-time constant, the fastest of a sweep at
//      internlm2's shapes: scripts/sweep_qkv_split.py; kernels/qkv_decode.py
//      KEYS_PER_SPLIT mirrors it for the scratch). Blocks are numbered
//      split-major. With pos >= 0 a split wholly past pos exits at once (its
//      first key is past pos); every other split holds key split * KPS <=
//      pos, so its m is a real score and a masked key's p is exactly 0.
//   2. A split's K and V codes and scales are staged whole with cp.async,
//      all copies in flight together (16-byte copies; 8 where a row is 8
//      bytes) in two groups, K's and V's: the scores and the softmax run
//      while V's land. Rows sit at their own stride: lanes read whole
//      vectors along a row, 8 lanes a row, so a shared-memory phase reads
//      consecutive bytes.
//   3. Scores: 8 lanes a key row, each an FMA chain over D / 8 of d (its
//      codes dequantized in registers once for all G heads), joined by a
//      fixed xor butterfly (4, 2, 1); a group of 8 lanes takes RP rows at
//      once, so its chains are independent; the query in shared memory in
//      chunks of D / 8 padded by 4 floats, so the 8 lanes' float4 reads hit
//      distinct banks. Softmax: one warp a head, keys lane + 32 i, a fixed
//      butterfly for the max and the sum. P . V: the split's keys in KQ
//      parts; a thread takes one (part, pair of heads, 32-bit word of a V
//      row: 4 or 8 d), dequantizes the word once for both heads and runs an
//      FMA chain a (head, d) over the part's keys in order; the parts' sums
//      are added in order. Every sum's order is fixed by the shapes alone:
//      the same bits on every call.
//   4. Each split writes its partial (acc G x D, m G, l G) to scratch that
//      the wrapper allocates; a second kernel merges the splits that hold a
//      visible key (every split when pos < 0) in split order, with the
//      merge of paged_split.cuh (no atomics): M = max m_i, l = sum l_i *
//      exp(m_i - M), acc = sum acc_i * exp(m_i - M), out = acc / max(l,
//      1e-30). With pos < 0 every m_i is BIG_NEG and the merge adds the
//      splits' counts and sums: the mean of v.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_split.cuh"

namespace {

using paged_split::BIG_NEG;
using paged_split::FULL;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KPS = 128;  // keys a split (mirrored by kernels/qkv_decode.py KEYS_PER_SPLIT)
constexpr int LPR = 8;    // lanes a key row in the scores
constexpr int RP = 4;     // key rows a group of LPR lanes takes at once in the scores
constexpr int KQ = 8;     // parts of the split's keys in P . V
static_assert(KPS % KQ == 0, "a part is a whole number of keys");

template <int D, int BITS>
struct Layout {
  static constexpr int RB = D * BITS / 8;         // bytes a cache row
  static constexpr int VB = RB % 16 == 0 ? 16 : 8;  // bytes a staging copy
  static constexpr int EPL = D / LPR;             // d a lane takes in the scores
  static constexpr int BPL = EPL * BITS / 8;      // code bytes a lane reads
  static constexpr int QC = EPL % 4 == 0 ? EPL + 4 : EPL;  // staged query chunk, floats
  static constexpr int NW = RB / 4;               // 32-bit words a row (P . V items)
  static constexpr int EPW = 32 / BITS;           // codes a word
  static constexpr int SCS = KPS + 1;             // score row stride, floats
  static_assert(RB % VB == 0 && RB % 4 == 0 && BPL >= 1, "rows of whole words and copies");
};

template <int D, int BITS>
struct Smem {
  using L = Layout<D, BITS>;
  // K codes, V codes (KPS x RB each), K and V scales, the query, the
  // scores (then p), the parts' sums, m and l
  static size_t bytes(int G) {
    return 2 * KPS * L::RB + sizeof(float) * (2 * KPS + G * LPR * L::QC + G * L::SCS +
                                              KQ * G * D + 2 * G);
  }
};

// BPL bytes of a lane's chunk of a staged row as 32-bit words, little
// endian (the last word's high bytes unused; w starts zeroed)
template <int BPL>
__device__ __forceinline__ void read_chunk(const unsigned char* p, uint32_t (&w)[(BPL + 3) / 4]) {
  if constexpr (BPL == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (BPL == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (BPL == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (BPL == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else if constexpr (BPL == 1) {
    w[0] = *p;
  } else {  // D 80: 10 bytes a lane at kv8, 5 at kv4, on no word boundary
#pragma unroll
    for (int i = 0; i < BPL; ++i) w[i / 4] |= (uint32_t)p[i] << (8 * (i % 4));
  }
}

template <int D, int BITS>
__global__ void __launch_bounds__(THREADS)
qkv_split_kernel(const float* __restrict__ q, const unsigned char* __restrict__ kq,
                 const float* __restrict__ ks, const unsigned char* __restrict__ vq,
                 const float* __restrict__ vs, float* __restrict__ part, int BH, int Hq,
                 int Hkv, int S, int nsplit, int pos, float scale) {
  using L = Layout<D, BITS>;
  const int split = blockIdx.x / BH;  // split-major: the low splits spread over the SMs
  const int bh = blockIdx.x - split * BH;
  const int k0 = split * KPS;
  if (pos >= 0 && k0 > pos) return;  // no visible key: the merge skips this split
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int G = Hq / Hkv;
  const int nk = min(KPS, S - k0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kt = smem;                                   // (KPS, RB) K codes
  unsigned char* vt = kt + KPS * L::RB;                       // (KPS, RB) V codes
  float* ksc = reinterpret_cast<float*>(vt + KPS * L::RB);    // (KPS,)
  float* vsc = ksc + KPS;                                     // (KPS,)
  float* qs = vsc + KPS;                                      // (G, LPR, QC)
  float* sc = qs + G * LPR * L::QC;                           // (G, SCS) scores, then p
  float* red = sc + G * L::SCS;                               // (KQ, G, D)
  float* ml = red + KQ * G * D;                               // m (G), l (G)

  // stage the split: every copy in flight together, K's and V's in two
  // groups (the scores need only K's), then the query
  const long long row0 = (long long)b * S * Hkv + h;  // cache row of key 0
  constexpr int CPR = L::RB / L::VB;                  // copies a row
  for (int v = 0; v < 2; ++v) {
    for (int i = tid; i < nk * CPR; i += THREADS) {
      const int j = i / CPR;
      const int o = (i - j * CPR) * L::VB;
      const long long src = (row0 + (long long)(k0 + j) * Hkv) * L::RB + o;
      paged_split::copy_async<L::VB>((v ? vt : kt) + j * L::RB + o, (v ? vq : kq) + src);
    }
    for (int j = tid; j < nk; j += THREADS)
      paged_split::copy_async<4>((v ? vsc : ksc) + j,
                                 (v ? vs : ks) + row0 + (long long)(k0 + j) * Hkv);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const float* qb = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    const int d = i - g * D;
    qs[(g * LPR + d / L::EPL) * L::QC + d % L::EPL] = qb[i];
  }
  asm volatile("cp.async.wait_group 1;\n" ::);  // K's group has landed
  __syncthreads();

  // scores: LPR lanes a key row, each an FMA chain over its EPL of d, then a
  // fixed butterfly. A group of LPR lanes takes RP rows at once (rows grp,
  // grp + 32, ...), their codes dequantized once for every head, their RP
  // chains independent. The loop's trips are the same for every lane (the
  // shuffles take the whole warp); a row past nk computes on zeros and
  // stores nothing.
  {
    const int sub = lane % LPR;
    const int grp = tid / LPR;
    constexpr int NG = THREADS / LPR;  // groups of lanes
    for (int j0 = 0; j0 < nk; j0 += RP * NG) {
      float kf[RP][L::EPL];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int j = j0 + grp + r * NG;
        uint32_t w[(L::BPL + 3) / 4] = {};
        if (j < nk) read_chunk<L::BPL>(kt + j * L::RB + sub * L::BPL, w);
        const float s_k = j < nk ? ksc[j] : 0.0f;
#pragma unroll
        for (int e = 0; e < L::EPL; ++e)
          kf[r][e] = __fmul_rn(paged_split::code_f32<BITS>(w[e / L::EPW], e % L::EPW), s_k);
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + (g * LPR + sub) * L::QC;
        float a[RP] = {};
        if constexpr (L::EPL % 4 == 0) {
#pragma unroll
          for (int e = 0; e < L::EPL; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + e);
#pragma unroll
            for (int r = 0; r < RP; ++r) {
              a[r] = fmaf(qv.x, kf[r][e], a[r]);
              a[r] = fmaf(qv.y, kf[r][e + 1], a[r]);
              a[r] = fmaf(qv.z, kf[r][e + 2], a[r]);
              a[r] = fmaf(qv.w, kf[r][e + 3], a[r]);
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < L::EPL; ++e) {
            const float qe = qg[e];
#pragma unroll
            for (int r = 0; r < RP; ++r) a[r] = fmaf(qe, kf[r][e], a[r]);
          }
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int r = 0; r < RP; ++r) a[r] = __fadd_rn(a[r], __shfl_xor_sync(FULL, a[r], o));
        }
        if (sub == 0) {
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const int j = j0 + grp + r * NG;
            if (j < nk) sc[g * L::SCS + j] = k0 + j <= pos ? __fmul_rn(a[r], scale) : BIG_NEG;
          }
        }
      }
    }
  }
  __syncthreads();

  // softmax over the split: one warp a head, keys lane + 32 i
  for (int g = warp; g < G; g += WARPS) {
    float* sg = sc + g * L::SCS;
    float mx = BIG_NEG;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, sg[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float sum = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const float p = expf(__fsub_rn(sg[j], mx));
      sg[j] = p;
      sum = __fadd_rn(sum, p);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
    if (lane == 0) {
      ml[g] = mx;
      ml[G + g] = sum;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // V's group has landed too
  __syncthreads();

  // P . V: a thread takes (part of the keys, pair of heads, word of a V
  // row) and runs, for each head of the pair and each of the word's EPW d,
  // an FMA chain over the part's keys in order; the word's codes are
  // dequantized once for both heads. The parts' sums are then added in order.
  constexpr int QK = KPS / KQ;  // keys a part
  const int GP = (G + 1) / 2;   // pairs of heads (the last one short when G is odd)
  for (int i = tid; i < KQ * GP * L::NW; i += THREADS) {
    const int wi = i % L::NW;
    const int g = (i / L::NW) % GP * 2;
    const int qq = i / (L::NW * GP);
    const bool two = g + 1 < G;
    const float* p0 = sc + g * L::SCS;
    const float* p1 = two ? p0 + L::SCS : p0;
    float a0[L::EPW], a1[L::EPW];
#pragma unroll
    for (int e = 0; e < L::EPW; ++e) a0[e] = a1[e] = 0.0f;
    const int j1 = min(nk, (qq + 1) * QK);
#pragma unroll 4
    for (int j = qq * QK; j < j1; ++j) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(vt + j * L::RB)[wi];
      const float s_v = vsc[j], pa = p0[j], pb = p1[j];
#pragma unroll
      for (int e = 0; e < L::EPW; ++e) {
        const float v = __fmul_rn(paged_split::code_f32<BITS>(w, e), s_v);
        a0[e] = fmaf(pa, v, a0[e]);
        a1[e] = fmaf(pb, v, a1[e]);
      }
    }
    float* r = red + (qq * G + g) * D + wi * L::EPW;
#pragma unroll
    for (int e = 0; e < L::EPW; ++e) {
      r[e] = a0[e];
      if (two) r[D + e] = a1[e];
    }
  }
  __syncthreads();

  // the partial: acc (G, D) the parts' sums in order, then m, l
  float* pm = part + ((long long)bh * nsplit + split) * G * (D + 2);
  for (int i = tid; i < G * D; i += THREADS) {
    float a = red[i];
#pragma unroll
    for (int qq = 1; qq < KQ; ++qq) a = __fadd_rn(a, red[qq * G * D + i]);
    pm[i] = a;
  }
  for (int i = tid; i < 2 * G; i += THREADS) pm[G * D + i] = ml[i];
}

// Merge, one thread an output value: the splits that hold a visible key
// (0..min(nsplit - 1, pos / KPS); every split when pos < 0) in split order.
__global__ void __launch_bounds__(paged_split::MERGE_THREADS)
qkv_merge_kernel(const float* __restrict__ part, float* __restrict__ out, int G, int D,
                 int nsplit, int pos) {
  const int i = blockIdx.y * paged_split::MERGE_THREADS + threadIdx.x;
  if (i >= G * D) return;
  const int s1 = pos >= 0 ? min(nsplit - 1, pos / KPS) : nsplit - 1;
  const float* pb = part + (long long)blockIdx.x * nsplit * G * (D + 2);
  out[(long long)blockIdx.x * G * D + i] = paged_split::merge_splits(pb, G, D, i / D, i, 0, s1);
}

template <int D, int BITS>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           void* out, void* part, int B, int Hq, int Hkv, int S, int pos, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int nsplit = (S + KPS - 1) / KPS;
  const size_t smem = Smem<D, BITS>::bytes(G);
  static size_t opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(qkv_split_kernel<D, BITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  qkv_split_kernel<D, BITS><<<B * Hkv * nsplit, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const unsigned char*>(kq),
      static_cast<const float*>(ks), static_cast<const unsigned char*>(vq),
      static_cast<const float*>(vs), static_cast<float*>(part), B * Hkv, Hq, Hkv, S, nsplit, pos,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hkv, (G * D + paged_split::MERGE_THREADS - 1) / paged_split::MERGE_THREADS);
  qkv_merge_kernel<<<grid, paged_split::MERGE_THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), G, D, nsplit, pos);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, D) f32; kq / vq (B, S, Hkv, D * bits / 8) int8 codes (bits 8, or
// 4: two signed nibbles a byte, element 2i low), 16-byte aligned; ks / vs
// (B, S, Hkv) f32; out (B, Hq, D) f32; all contiguous; part f32 scratch of
// B * Hkv * ceil(S / KPS) * (Hq / Hkv) * (D + 2) floats. D in {16, 64, 80, 128},
// bits in {8, 4}, Hq a multiple of Hkv, S >= 1; keys with index > pos are
// masked (pos < 0: all of them, the mean of v). Launches the split pass and
// the merge; returns cudaGetLastError() after them, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int qkv_decode_launch(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, void* out, void* part, int B, int Hq, int Hkv,
                                 int S, int D, int bits, int pos, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QKV_ARGS q, kq, ks, vq, vs, out, part, B, Hq, Hkv, S, pos, scale, st
  if (D == 16 && bits == 8) return launch<16, 8>(QKV_ARGS);
  if (D == 16 && bits == 4) return launch<16, 4>(QKV_ARGS);
  if (D == 64 && bits == 8) return launch<64, 8>(QKV_ARGS);  // granite-moe-1b-a400m
  if (D == 64 && bits == 4) return launch<64, 4>(QKV_ARGS);
  if (D == 80 && bits == 8) return launch<80, 8>(QKV_ARGS);  // h2o-danube-1.8b, stablelm-3b
  if (D == 80 && bits == 4) return launch<80, 4>(QKV_ARGS);
  if (D == 128 && bits == 8) return launch<128, 8>(QKV_ARGS);  // internlm2-1.8b
  if (D == 128 && bits == 4) return launch<128, 4>(QKV_ARGS);
#undef QKV_ARGS
  return (int)cudaErrorInvalidValue;
}
