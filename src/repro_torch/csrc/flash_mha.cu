// Whole-sequence flash attention forward (causal / windowed, GQA), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash.py::flash_mha_pallas. The
// TPU grid (B, Hq, nq, nk) keeps its running-softmax state in VMEM across
// the sequential nk steps; here one block owns one (batch, query head, tile
// of BQ query rows) and walks its kv tiles in a loop, with the state in
// registers. GQA: query head h reads kv head h / (Hq / Hkv). Operands are
// read in the model's (B, S, H, D) layout through their strides (no
// transposes, no padding copies; each row must start on a 4-byte boundary);
// ragged Sq and Sk are masked here.
//
// Numerics follow the Pallas kernel and the reference's CPU path:
//   * q, k and v are read as f32 (bf16 widens exactly);
//   * s = dot(q, k) * scale, the dot one f32 FMA chain over d in order;
//   * keys past Sk, in the future (causal: kpos <= qpos, positions from 0 on
//     both sides) or outside the window (qpos - kpos < window) score BIG_NEG
//     and go through exp like any other score, as in the reference (a row
//     that has seen no visible key yet keeps m = BIG_NEG; its first visible
//     key's alpha = exp(BIG_NEG - m) = 0 clears what the masked ones added);
//   * per kv tile: m' = max(m, max s), p = exp(s - m'), alpha = exp(m - m'),
//     l = l * alpha + sum p, acc = acc * alpha + p . v; expf (no fast math);
//   * out = acc / max(l, 1e-30), f32, written (B, Sq, Hq, D) contiguous.
// Kv tiles that lie wholly in the future or outside the window of every row
// of the block are skipped, as the Pallas grid does with pl.when: for a row
// that has a visible key such a tile adds p = exp(BIG_NEG - m) = 0 with
// alpha = 1, so skipping it is exact. No atomics, no split over keys: every
// output has one fixed order of sums, the same bits on every call, and a
// row's bits do not depend on Sq.
//
// Bound on this card: causal attention at 4 x 512 tokens, 16 heads of 128,
// is 4.3 GFLOP a layer for 34 MB moved, so the work bounds it: q . k (bf16
// products summed in f32) at the bf16 tensor-core rate, 989 TFLOP/s, and
// P . V (f32 probabilities) at the f32 rate, 67 TFLOP/s, which dominates.
// Design, a simple first version on the CUDA cores: 128 threads a block as 16 row groups x 8 lanes; a thread owns 4
// query rows, 8 score columns (tx + 8 j) and 16 accumulator columns (pairs
// 2 tx + 16 j). The Q, K and V tiles are staged in shared memory in the
// input's type (bf16 read two at a time as one 32-bit word and widened with a
// shift), rows padded so that the row groups and the lanes hit distinct
// banks; probabilities pass through shared memory to the P . V product. Row
// max and row sum reduce over the 8 lanes of a row with shuffles. Staging
// runs asynchronously (cp.async) behind the other half of each tile's work,
// and the grid puts every head's longest causal q tile first, so the
// triangle's short tiles fill the last wave. Tensor cores, TMA and wgmma are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a kv tile
constexpr int THREADS = 128;  // 16 row groups (ty) x 8 lanes (tx)
constexpr int RT = 4;         // query rows a thread: 4 ty + i
constexpr int CT = BK / 8;    // score columns a thread: tx + 8 j
constexpr int PLD = BK + 1;   // row stride of the probability tile
constexpr float BIG_NEG = -2.0e9f;

// row padding of the Q and K tiles (elements): the row stride in 32-bit
// words is odd for every supported D, so rows 4 apart and rows 1 apart fall
// on distinct banks
template <typename T>
struct Pad;
template <>
struct Pad<float> {
  static constexpr int value = 1;
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int value = 2;
};

// elements d and d + 1 of a staged row as f32 (d even)
__device__ __forceinline__ float2 pair(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// Start copying rows [s0, s0 + n) of one head into a (n, ld) tile in
// shared memory, 32-bit words with cp.async (rows at or past S are filled
// with zeros); the caller commits the group and waits for it. Needs every
// row to start on a 4-byte boundary (the wrapper checks).
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, long long ss, int s0,
                                      int n, int S, int tid) {
  constexpr int EPW = 4 / sizeof(T);  // elements a word
  constexpr int W = D / EPW;          // words a row
  for (int i = tid; i < n * W; i += THREADS) {
    const int r = i / W;
    const int e = (i - r * W) * EPW;
    const int s = s0 + r;
    const T* g = s < S ? src + (long long)s * ss + e : src;
    const uint32_t sa = (uint32_t)__cvta_generic_to_shared(dst + r * ld + e);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa), "l"(g),
                 "r"(s < S ? 4 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 float* __restrict__ out, int Hq, int Hkv, int Sq, int Sk, long long qsb,
                 long long qss, long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh, int causal, int window,
                 float scale) {
  constexpr int LD = D + Pad<T>::value;  // Q and K tile row stride (elements)
  constexpr int DC = D / 16;             // accumulator column pairs a thread
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // every head's longest causal tile first
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                  // (BQ, LD)
  T* ks = qs + BQ * LD;                                 // (BK, LD)
  T* vs = ks + BK * LD;                                 // (BK, D)
  float* ps = reinterpret_cast<float*>(vs + BK * D);    // (BQ, PLD)

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  float m[RT], l[RT], acc[RT][2 * DC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = BIG_NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 2 * DC; ++c) acc[i][c] = 0.0f;
  }

  const int nk = (Sk + BK - 1) / BK;
  int jlo = 0;
  int jhi = nk;
  if (causal) jhi = min(nk, (q0 + BQ - 1) / BK + 1);  // tiles with k0 <= last row
  if (window > 0 && q0 - window + 1 > 0) jlo = (q0 - window + 1) / BK;

  // Each kv tile is staged while the other half of the previous tile's work
  // runs: K(j + 1) is copied during the P . V product of tile j, V(j + 1)
  // during the scores of tile j + 1. Groups in flight at the top of tile j:
  // {Q and K(j)} or {K(j)}, then {V(j)}.
  stage<T, D>(qs, LD, q + b * qsb + h * qsh, qss, q0, BQ, Sq, tid);
  stage<T, D>(ks, LD, kb, kss, jlo * BK, BK, Sk, tid);
  stage<T, D>(vs, D, vb, vss, jlo * BK, BK, Sk, tid);
  for (int j = jlo; j < jhi; ++j) {
    const int k0 = j * BK;
    wait_async<1>();  // Q and K(j) have landed (V(j) may not have)
    __syncthreads();

    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float2 qa[RT], kc[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qa[i] = pair(qs + (ty * RT + i) * LD + d);
#pragma unroll
      for (int c = 0; c < CT; ++c) kc[c] = pair(ks + (tx + 8 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          s[i][c] = fmaf(qa[i].x, kc[c].x, s[i][c]);
          s[i][c] = fmaf(qa[i].y, kc[c].y, s[i][c]);
        }
    }

    float alpha[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q0 + ty * RT + i;
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int kpos = k0 + tx + 8 * c;
        bool valid = kpos < Sk;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && qpos - kpos < window;
        s[i][c] = valid ? __fmul_rn(s[i][c], scale) : BIG_NEG;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float p = expf(__fsub_rn(s[i][c], mx));
        ps[(ty * RT + i) * PLD + tx + 8 * c] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      alpha[i] = expf(__fsub_rn(m[i], mx));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum);
      m[i] = mx;
    }
    __syncthreads();  // P is written; every reader of K(j) is done
    if (j + 1 < jhi) {
      stage<T, D>(ks, LD, kb, kss, k0 + BK, BK, Sk, tid);
      wait_async<1>();  // V(j) has landed (K(j + 1) may not have)
    } else {
      wait_async<0>();
    }
    __syncthreads();

    float pv[RT][2 * DC];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < 2 * DC; ++c) pv[i][c] = 0.0f;
#pragma unroll 2
    for (int t = 0; t < BK; ++t) {
      float p[RT];
      float2 vv[DC];
#pragma unroll
      for (int i = 0; i < RT; ++i) p[i] = ps[(ty * RT + i) * PLD + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = pair(vs + t * D + 2 * tx + 16 * c);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          pv[i][2 * c] = fmaf(p[i], vv[c].x, pv[i][2 * c]);
          pv[i][2 * c + 1] = fmaf(p[i], vv[c].y, pv[i][2 * c + 1]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < 2 * DC; ++c)
        acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha[i]), pv[i][c]);
    __syncthreads();  // every reader of V(j) and P is done
    if (j + 1 < jhi) stage<T, D>(vs, D, vb, vss, k0 + BK, BK, Sk, tid);
  }
  wait_async<0>();  // nothing in flight at exit (a block with no kv tile)

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int sq = q0 + ty * RT + i;
    if (sq >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + (((long long)b * Sq + sq) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = 2 * tx + 16 * c;
      o[col] = acc[i][2 * c] / den;
      o[col + 1] = acc[i][2 * c + 1] / den;
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int Sq, int Sk, const long long* st, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int LD = D + Pad<T>::value;
  const size_t smem = sizeof(T) * (size_t)(2 * BQ * LD + BK * D) + sizeof(float) * BQ * PLD;
  cudaError_t e = cudaFuncSetAttribute(flash_mha_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  flash_mha_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(out), Hq, Hkv, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
             int Sq, int Sk, int D, const long long* st, int causal, int window, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16:  // the reduced configs
      return launch<T, 16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, s);
    case 128:  // internlm2-1.8b
      return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), bf16 (is_f32 == 0) or f32, each
// addressed through its batch, sequence and head strides in elements
// (strides: q's three, then k's, then v's; d contiguous); out (B, Sq, Hq, D)
// f32 contiguous. D in {16, 128}; Hq a multiple of Hkv; Sq, Sk >= 1.
// causal != 0 masks kpos > qpos; window <= 0 means no window. Every query
// row must see a key (a window needs Sq < Sk + window; the wrapper checks):
// a row with none gets 0 or a mean of v depending on its tile. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_mha_launch(const void* q, const void* k, const void* v, void* out, int B,
                                int Hq, int Hkv, int Sq, int Sk, int D, const long long* strides,
                                int causal, int window, float scale, int is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return launch_d<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, strides, causal, window, scale,
                           s);
  return launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, strides, causal, window,
                                 scale, s);
}
