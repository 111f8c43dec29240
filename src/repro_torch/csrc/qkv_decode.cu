// Decode attention over a dense int8 / packed int4 KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/qkv_decode.py::qkv_decode_pallas.
// The TPU grid (B, Hq, ns) walks the key blocks of one query head in order,
// with the running softmax in VMEM scratch, and reads every K/V block once
// per query head. Here one block owns one (batch b, kv head h) and serves
// all G = Hq / Hkv query heads of the group (query head h * G + g reads kv
// head h), so each K/V row leaves device memory once; the sequential key
// axis is a loop over tiles of TK keys inside the block, with the state in
// shared memory.
//
// Numerics follow the Pallas kernel:
//   * dequantization in f32: __fmul_rn((float)code, scale), one rounding
//     (no bf16 step, unlike paged_attn); kv4 unpacks the signed
//     little-endian nibbles (core/pack.py unpack(signed=True));
//   * s = dot(q, k) * scale, the dot one f32 FMA chain over d in order;
//     keys with index > pos score BIG_NEG (pos < 0 masks every key), keys
//     past S (a ragged last tile) are absent (-inf, probability 0);
//   * per tile: m' = max(m, max s), p = exp(s - m'), alpha = exp(m - m'),
//     l = l * alpha + sum p, acc = acc * alpha + p . v, from m = BIG_NEG,
//     l = 0, acc = 0; expf (no fast math); out = acc / max(l, 1e-30), f32.
//     With pos < 0 every p is 1: the mean of v over all S keys.
// Tiles wholly past pos are skipped when pos >= 0: the first tile holds
// key 0, which is visible, so m is a real score from then on and a skipped
// tile would add p = exp(BIG_NEG - m) = 0 with alpha = 1. With pos < 0 all
// tiles are walked. No atomics, no split over keys: one fixed order of sums,
// the same bits on every call.
//
// Bound on this card: one decode step reads every visible K/V code once
// (B * S * Hkv * D * bits / 8 bytes each) plus two f32 scales a token and
// head, and does 4 * Hq * D flops a key: about G flops a byte at kv8, far
// below the card's ratio, so device-memory bytes bound it. Design, a simple
// first version: 128 threads a block; each tile of 64 rows of K and of V is
// loaded with 16-byte vector loads (8-byte where a row is 8 bytes: D 16 at
// kv4) into registers one tile ahead, then stored to shared memory with a
// row stride of an odd number of 32-bit words, so the 32 score threads of a
// warp, one key each, hit 32 distinct banks. A thread computes one (head,
// key) score over the raw codes, unpacking in registers; a warp runs the
// running softmax of a head (shuffle reductions in a fixed butterfly); a
// thread owns (head, d) accumulators and sums p . v over the tile's keys
// in order. At internlm2's shapes the grid is B * Hkv = 32 blocks: far from
// filling 132 SMs, which is why a split over keys (with a fixed-order
// merge) is the first thing to try when this kernel is made fast.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 64;  // keys a tile: two per lane in the softmax
constexpr float BIG_NEG = -2.0e9f;
static_assert(THREADS == 2 * TK, "a tile's scales take one thread each for K and for V");

template <int D, int BITS>
struct Layout {
  static constexpr int RB = D * BITS / 8;                    // bytes a cache row
  static constexpr int VB = RB % 16 == 0 ? 16 : 8;           // bytes a vector load
  static constexpr int VPR = RB / VB;                        // vectors a row
  static constexpr int NV = TK * VPR;                        // vectors a tile (K or V)
  static constexpr int PER = (NV + THREADS - 1) / THREADS;   // vectors a thread
  static constexpr int LDW = RB / 4 + 1;                     // staged row stride, words (odd)
  using Vec = std::conditional_t<VB == 16, uint4, uint2>;
  static_assert(RB % VB == 0 && RB % 4 == 0, "row must be whole vectors and words");
};

__device__ __forceinline__ void put(uint32_t* dst, const uint4& v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void put(uint32_t* dst, const uint2& v) {
  dst[0] = v.x;
  dst[1] = v.y;
}

// value e of a staged row as its signed code
template <int BITS>
__device__ __forceinline__ int code_at(const uint32_t* row, int e) {
  if constexpr (BITS == 8) {
    return (int)(int8_t)(row[e >> 2] >> ((e & 3) * 8));
  } else {
    const int u = (int)((row[e >> 3] >> ((e & 7) * 4)) & 0xFu);
    return (u ^ 8) - 8;
  }
}

// One tile of K and V codes and scales, in registers: loaded one tile
// ahead, stored to shared memory when the tile before it is done.
template <int D, int BITS>
struct Tile {
  using L = Layout<D, BITS>;
  typename L::Vec k[L::PER], v[L::PER];
  float scale;  // thread t < TK: k_s of key t; TK <= t < 2 TK: v_s of key t - TK

  __device__ __forceinline__ void load(const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
                                       const float* __restrict__ ks, const float* __restrict__ vs,
                                       long long row0, int Hkv, int t0, int S, int tid) {
    // row of key s for this (b, h): (row0 + s * Hkv) rows of RB bytes
#pragma unroll
    for (int i = 0; i < L::PER; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / L::VPR;
      const int s = t0 + r;
      if (c < L::NV && s < S) {
        const long long off = (row0 + (long long)s * Hkv) * L::RB + (c % L::VPR) * L::VB;
        k[i] = *reinterpret_cast<const typename L::Vec*>(kq + off);
        v[i] = *reinterpret_cast<const typename L::Vec*>(vq + off);
      } else {
        k[i] = {};
        v[i] = {};
      }
    }
    const int j = tid % TK;
    const int s = t0 + j;
    scale = s < S ? (tid < TK ? ks : vs)[row0 + (long long)s * Hkv] : 0.0f;
  }

  __device__ __forceinline__ void store(uint32_t* kt, uint32_t* vt, float* ksc, float* vsc,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < L::PER; ++i) {
      const int c = tid + i * THREADS;
      if (c < L::NV) {
        const int w = (c / L::VPR) * L::LDW + (c % L::VPR) * (L::VB / 4);
        put(kt + w, k[i]);
        put(vt + w, v[i]);
      }
    }
    (tid < TK ? ksc : vsc)[tid % TK] = scale;
  }
};

template <int D, int BITS>
__global__ void __launch_bounds__(THREADS)
qkv_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                  const float* __restrict__ ks, const int8_t* __restrict__ vq,
                  const float* __restrict__ vs, float* __restrict__ out, int Hq, int Hkv, int S,
                  int pos, float scale) {
  using L = Layout<D, BITS>;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* kt = reinterpret_cast<uint32_t*>(smem);  // (TK, LDW) K codes
  uint32_t* vt = kt + TK * L::LDW;                    // (TK, LDW) V codes
  float* ksc = reinterpret_cast<float*>(vt + TK * L::LDW);  // (TK,)
  float* vsc = ksc + TK;                              // (TK,)
  float* qs = vsc + TK;                               // (G, D)
  float* sc = qs + G * D;                             // (G, TK) scores, then p
  float* acc = sc + G * TK;                           // (G, D)
  float* mrow = acc + G * D;                          // (G,)
  float* lrow = mrow + G;                             // (G,)
  float* alpha = lrow + G;                            // (G,)

  const float* qb = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = qb[i];
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = BIG_NEG;
    lrow[g] = 0.0f;
  }

  const long long row0 = (long long)b * S * Hkv + h;  // cache row of key 0
  const int nt_all = (S + TK - 1) / TK;
  const int nt = pos >= 0 ? min(nt_all, pos / TK + 1) : nt_all;

  Tile<D, BITS> tile;
  tile.load(kq, vq, ks, vs, row0, Hkv, 0, S, tid);
  for (int t = 0; t < nt; ++t) {
    const int t0 = t * TK;
    __syncthreads();  // the previous tile's readers are done; q, m, l, acc set
    tile.store(kt, vt, ksc, vsc, tid);
    __syncthreads();
    if (t + 1 < nt) tile.load(kq, vq, ks, vs, row0, Hkv, t0 + TK, S, tid);

    // scores: one (head, key) a thread, one FMA chain over d
    for (int i = tid; i < G * TK; i += THREADS) {
      const int g = i / TK;
      const int j = i - g * TK;
      const int s = t0 + j;
      float val = -INFINITY;  // a key past S is absent
      if (s < S) {
        const uint32_t* row = kt + j * L::LDW;
        const float* qg = qs + g * D;
        const float kscale = ksc[j];
        float a = 0.0f;
#pragma unroll 16
        for (int e = 0; e < D; ++e)
          a = fmaf(qg[e], __fmul_rn((float)code_at<BITS>(row, e), kscale), a);
        val = s <= pos ? __fmul_rn(a, scale) : BIG_NEG;
      }
      sc[i] = val;
    }
    __syncthreads();

    // running softmax: one warp a head, keys lane and lane + 32
    for (int g = warp; g < G; g += WARPS) {
      float* sg = sc + g * TK;
      const float x0 = sg[lane], x1 = sg[lane + 32];
      const float m_old = mrow[g];
      float mx = fmaxf(m_old, fmaxf(x0, x1));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float p0 = expf(__fsub_rn(x0, mx));
      const float p1 = expf(__fsub_rn(x1, mx));
      sg[lane] = p0;
      sg[lane + 32] = p1;
      float sum = __fadd_rn(p0, p1);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      if (lane == 0) {
        const float al = expf(__fsub_rn(m_old, mx));
        alpha[g] = al;
        lrow[g] = __fadd_rn(__fmul_rn(lrow[g], al), sum);
        mrow[g] = mx;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v over the tile's keys, in key order
    const int nk = min(TK, S - t0);
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = sc + g * TK;
      float a = 0.0f;
      for (int j = 0; j < nk; ++j)
        a = fmaf(pg[j], __fmul_rn((float)code_at<BITS>(vt + j * L::LDW, d), vsc[j]), a);
      acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha[g]), a);
    }
  }
  __syncthreads();

  float* ob = out + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS) ob[i] = acc[i] / fmaxf(lrow[i / D], 1e-30f);
}

template <int D, int BITS>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           void* out, int B, int Hq, int Hkv, int S, int pos, float scale, cudaStream_t stream) {
  using L = Layout<D, BITS>;
  const int G = Hq / Hkv;
  const size_t smem = sizeof(uint32_t) * 2 * TK * L::LDW +
                      sizeof(float) * (2 * TK + 2 * G * D + G * TK + 3 * G);
  cudaError_t e = cudaFuncSetAttribute(qkv_decode_kernel<D, BITS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  qkv_decode_kernel<D, BITS><<<B * Hkv, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<float*>(out), Hq, Hkv, S, pos, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, D) f32; kq / vq (B, S, Hkv, D * bits / 8) int8 codes (bits 8, or
// 4: two signed nibbles a byte, element 2i low), 16-byte aligned; ks / vs
// (B, S, Hkv) f32; out (B, Hq, D) f32; all contiguous. D in {16, 128}, bits
// in {8, 4}, Hq a multiple of Hkv, S >= 1; keys with index > pos are masked
// (pos < 0: all of them, the mean of v). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int qkv_decode_launch(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, void* out, int B, int Hq, int Hkv, int S, int D,
                                 int bits, int pos, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 16 && bits == 8)
    return launch<16, 8>(q, kq, ks, vq, vs, out, B, Hq, Hkv, S, pos, scale, st);
  if (D == 16 && bits == 4)
    return launch<16, 4>(q, kq, ks, vq, vs, out, B, Hq, Hkv, S, pos, scale, st);
  if (D == 128 && bits == 8)  // internlm2-1.8b
    return launch<128, 8>(q, kq, ks, vq, vs, out, B, Hq, Hkv, S, pos, scale, st);
  if (D == 128 && bits == 4)
    return launch<128, 4>(q, kq, ks, vq, vs, out, B, Hq, Hkv, S, pos, scale, st);
  return (int)cudaErrorInvalidValue;
}
