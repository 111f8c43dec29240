// Whole-sequence flash attention forward (causal / windowed, GQA), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash.py::flash_mha_pallas
// (:79). The TPU grid (B, Hq, nq, nk) keeps its running-softmax state in
// VMEM across the sequential nk steps; here one block owns one (query head,
// batch, tile of BQ = 64 query rows) and walks its kv tiles of BK = 64 keys
// in a loop, with the state in registers. GQA: query head h reads kv head
// h / (Hq / Hkv). Operands are read in the model's (B, S, H, D) layout
// through their strides (no transposes, no padding copies; each row must
// start on a 4-byte boundary); ragged Sq and Sk are masked here.
//
// Numerics follow the Pallas kernel and the reference's CPU path, and are
// the same for both instantiations below:
//   * q, k and v are read as f32 (bf16 widens exactly);
//   * s = dot(q, k) * scale: the dot one f32 FMA chain over d in order (the
//     plain version's einsum sums in that order, on the CPU and on the card,
//     so the scores are its scores bit for bit), then __fmul_rn by scale;
//   * keys past Sk, in the future (causal: kpos <= qpos, positions from 0 on
//     both sides) or outside the window (qpos - kpos < window) score BIG_NEG
//     and go through exp like any other score, as in the reference (a row
//     that has seen no visible key yet keeps m = BIG_NEG; its first visible
//     key's alpha = exp(BIG_NEG - m) = 0 clears what the masked ones added);
//   * per kv tile: m' = max(m, max s), p = exp(s - m'), alpha = exp(m - m'),
//     l = l * alpha + sum p, acc = acc * alpha + p . v; expf (no fast math);
//     row max and row sum reduce over the 8 lanes of a row with shuffles in
//     a fixed order;
//   * out = acc / max(l, 1e-30), f32, written (B, Sq, Hq, D) contiguous.
// Kv tiles that lie wholly in the future or outside the window of every row
// of the block are skipped, as the Pallas grid does with pl.when: for a row
// that has a visible key such a tile adds p = exp(BIG_NEG - m) = 0 with
// alpha = 1, so skipping it is exact. No atomics, no split over keys: every
// output has one fixed order of sums, the same bits on every call, and a
// row's bits do not depend on Sq (tiles are fixed, rows independent).
//
// Bound on this card: causal attention at 4 x 512 tokens, 16 / 8 heads of
// 128, moves 34 MB a layer (bf16 q, k, v read once, f32 out written once:
// 0.0100 ms at 3.35 TB/s) and does 2.15 GFLOP of q . k and as much of P . V.
// q . k multiplies bf16 by bf16 and sums in f32, which a bf16 tensor-core
// product does; P . V at f32 precision is three bf16 tensor-core products
// (below), so the operations take 4 x 2.15 GFLOP / 989 TFLOP/s = 0.0087 ms
// and the bytes bound it: 0.2404 ms for the 24 calls of one prefill_step.
//
// bf16 operands (what the model passes), flash_mha_kernel:
//   * 128 threads: 4 warps, 64 query rows, 16 rows a warp in P . V.
//   * q . k stays an f32 FMA chain on the CUDA cores, one chain a score, in
//     d order. At the model's scores (|s| ~ 20, |v| ~ 14) an ulp of a score
//     moves an output by about TOL, so a kernel within TOL of the plain
//     version has to round the scores as it does: scores summed 16 products
//     at a time, as a bf16 tensor-core q . k takes them (even rounded to
//     nearest), put the output beyond TOL from the plain version, the
//     chain's scores within a third of it (tests/test_torch_flash.py, on
//     the CPU).
//     Each thread owns 4 rows x 8 keys (rows ty + 16 i, keys tx + 8 c: the
//     rows a warp reads, and the keys, fall on distinct banks). Q stays bf16
//     in shared memory and widens in registers (4 rows x 4 d a step); each
//     K tile is widened to f32 in shared memory once, so the loop reads it
//     as float4: 12 loads a step for 128 FMAs.
//   * P . V runs on the tensor cores at f32 precision. Each f32 p splits
//     into hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid): hi
//     holds p's top 8 significant bits, mid the next 8 (|p - hi| has at
//     most 16), lo the last 8, so hi + mid + lo == p exactly (only a p below
//     ~2^-110 can lose bits to underflow) and every product with a bf16 v is
//     exact in f32. Two parts would drop up to 2^-16 of each term, far above
//     the f32 sums' own rounding; at the model's scale that moves the output
//     past TOL (tests/test_torch_flash.py). The warp takes its A
//     fragments of the m16n8k16 product from the f32 P tile in shared memory
//     (split in registers) and its B fragments from the bf16 V tile with
//     ldmatrix.trans; per (k16, n8) step three mma.sync bf16 products, lo
//     then mid then hi, into one per-tile f32 accumulator pv; then acc =
//     acc * alpha + pv (__fmul_rn, __fadd_rn), the reference's structure.
//   * Staging: Q, K and V tiles land with cp.async, 16 bytes a copy when
//     every row of q, k and v starts on a 16-byte boundary (the model's rows
//     do: strides of 4096 and 2048 bytes at D 128), else 4 bytes a copy;
//     the wrapper picks (vec), both paths leave the same bytes. K(j + 1)
//     lands during the scores of tile j, V(j + 1) during the scores of tile
//     j + 1 (a second V buffer would cost the SM its second block). Rows of
//     bf16 tiles are padded by 16 bytes (a 4-bank shift a row: ldmatrix's 8
//     rows and the score loop's rows hit distinct banks), f32 K rows by 16,
//     P rows by 32 (the fragment reads of a half-warp fall on distinct
//     banks). 105 KB of shared memory at D 128: two blocks an SM. The grid
//     puts every head's longest causal q tile first, so the triangle's
//     short tiles fill the last wave.
//   * The score loop sets the time: P . V on the tensor cores hides behind
//     it. Scores in the A-fragment layout, P kept in registers (2 rows x 16
//     keys a thread), read more shared memory per FMA and ran slower.
// f32 operands (only the tests pass them, at the reference test's shapes):
// flash_mha_f32_kernel, the CUDA-core kernel of the first design, unchanged
// (a bf16 tensor-core product would round f32 q and k; 16 row groups x 8
// lanes, 4 rows x 8 score columns and 16 accumulator columns a thread, P
// through shared memory, FMA chains for both products).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_pipe.cuh"

namespace {

using mma_pipe::split3;

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a kv tile
constexpr int THREADS = 128;  // 16 row groups (ty) x 8 lanes (tx); 4 warps
constexpr int RT = 4;         // query rows a thread in the scores
constexpr int CT = BK / 8;    // score columns a thread: tx + 8 j
constexpr float BIG_NEG = -2.0e9f;
constexpr unsigned FULL = 0xffffffffu;

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --------------------------------------------------------------- f32 path

constexpr int PLD = BK + 1;   // row stride of the f32 kernel's probability tile
constexpr int PAD = 1;        // f32 Q and K tile row padding (elements)

// elements d and d + 1 of a staged row as f32 (d even)
__device__ __forceinline__ float2 pair(const float* p) { return make_float2(p[0], p[1]); }

// Start copying rows [s0, s0 + n) of one head into a (n, ld) f32 tile in
// shared memory, one 4-byte cp.async an element (rows at or past S are
// filled with zeros); commits one group.
template <int D>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, long long ss, int s0,
                                      int n, int S, int tid) {
  for (int i = tid; i < n * D; i += THREADS) {
    const int r = i / D;
    const int e = i - r * D;
    const int s = s0 + r;
    const float* g = s < S ? src + (long long)s * ss + e : src;
    const uint32_t sa = (uint32_t)__cvta_generic_to_shared(dst + r * ld + e);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa), "l"(g),
                 "r"(s < S ? 4 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int Hq, int Hkv,
                     int Sq, int Sk, long long qsb, long long qss, long long qsh, long long ksb,
                     long long kss, long long ksh, long long vsb, long long vss, long long vsh,
                     int causal, int window, float scale) {
  constexpr int LD = D + PAD;  // Q and K tile row stride (elements)
  constexpr int DC = D / 16;   // accumulator column pairs a thread
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // every head's longest causal tile first
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // (BQ, LD)
  float* ks = qs + BQ * LD;                     // (BK, LD)
  float* vs = ks + BK * LD;                     // (BK, D)
  float* ps = vs + BK * D;                      // (BQ, PLD)

  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

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
  stage<D>(qs, LD, q + b * qsb + h * qsh, qss, q0, BQ, Sq, tid);
  stage<D>(ks, LD, kb, kss, jlo * BK, BK, Sk, tid);
  stage<D>(vs, D, vb, vss, jlo * BK, BK, Sk, tid);
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
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float p = expf(__fsub_rn(s[i][c], mx));
        ps[(ty * RT + i) * PLD + tx + 8 * c] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
      alpha[i] = expf(__fsub_rn(m[i], mx));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum);
      m[i] = mx;
    }
    __syncthreads();  // P is written; every reader of K(j) is done
    if (j + 1 < jhi) {
      stage<D>(ks, LD, kb, kss, k0 + BK, BK, Sk, tid);
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
    if (j + 1 < jhi) stage<D>(vs, D, vb, vss, k0 + BK, BK, Sk, tid);
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

// -------------------------------------------------------------- bf16 path

// Shared-memory layout of the bf16 kernel (host and device agree): bf16
// tiles of Q, K (staging) and V, the f32 K tile the scores read, the f32 P
// tile, and alpha and l a row. Every offset and row stride is a multiple of
// 16 bytes.
template <int D>
struct Tiles {
  static constexpr int LD = D + 8;    // bf16 rows: 16 bytes of padding
  static constexpr int LDF = D + 4;   // f32 K rows: 16 bytes of padding
  static constexpr int PLD = BK + 8;  // f32 P rows: 32 bytes of padding
  static constexpr size_t q = 0;
  static constexpr size_t kb = q + sizeof(__nv_bfloat16) * BQ * LD;
  static constexpr size_t vb = kb + sizeof(__nv_bfloat16) * BK * LD;
  static constexpr size_t kf = vb + sizeof(__nv_bfloat16) * BK * LD;
  static constexpr size_t p = kf + sizeof(float) * BK * LDF;
  static constexpr size_t alpha = p + sizeof(float) * BQ * PLD;
  static constexpr size_t l = alpha + sizeof(float) * BQ;
  static constexpr size_t bytes = l + sizeof(float) * BQ;
};

// the 32-bit word w's low and high bf16 as f32
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Start copying rows [s0, s0 + 64) of one head into a (64, D + 8) bf16 tile
// in shared memory (rows at or past S are filled with zeros): 16-byte
// cp.async copies when vec (every row starts on a 16-byte boundary), 4-byte
// ones otherwise; the same bytes either way. Commits one group.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ss, int s0, int S, int vec, int tid) {
  constexpr int LD = Tiles<D>::LD;
  static_assert(BQ == BK, "one staging routine for the Q, K and V tiles");
  if (vec) {
    constexpr int C = D / 8;  // 16-byte copies a row
    for (int i = tid; i < BK * C; i += THREADS) {
      const int r = i / C;
      const int e = (i - r * C) * 8;
      const int s = s0 + r;
      const __nv_bfloat16* g = s < S ? src + (long long)s * ss + e : src;
      const uint32_t sa = (uint32_t)__cvta_generic_to_shared(dst + r * LD + e);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(g),
                   "r"(s < S ? 16 : 0));
    }
  } else {
    constexpr int C = D / 2;  // 4-byte copies a row
    for (int i = tid; i < BK * C; i += THREADS) {
      const int r = i / C;
      const int e = (i - r * C) * 2;
      const int s = s0 + r;
      const __nv_bfloat16* g = s < S ? src + (long long)s * ss + e : src;
      const uint32_t sa = (uint32_t)__cvta_generic_to_shared(dst + r * LD + e);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa), "l"(g),
                   "r"(s < S ? 4 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// c += a . b on the tensor cores: one m16n8k16 product, bf16 operands, f32
// accumulator (a: the four A registers, b0 / b1: the two B registers)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_mha_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int Hq, int Hkv,
                 int Sq, int Sk, long long qsb, long long qss, long long qsh, long long ksb,
                 long long kss, long long ksh, long long vsb, long long vss, long long vsh,
                 int causal, int window, float scale, int vec) {
  using L = Tiles<D>;
  constexpr int LD = L::LD;
  constexpr int LDF = L::LDF;
  constexpr int PL = L::PLD;
  constexpr int NT = D / 8;  // n8 tiles of a warp's output rows
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // every head's longest causal tile first
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  // scores and softmax: rows ty + 16 i, keys tx + 8 c
  const int tx = tid & 7;
  const int ty = tid >> 3;
  // P . V: warp w's rows 16 w + g and 16 w + g + 8 (the m16n8k16 fragments)
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * (tid >> 5) + g;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q);   // (BQ, LD)
  __nv_bfloat16* kbs = reinterpret_cast<__nv_bfloat16*>(smem + L::kb); // (BK, LD)
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::vb);  // (BK, LD)
  float* kf = reinterpret_cast<float*>(smem + L::kf);                  // (BK, LDF)
  float* ps = reinterpret_cast<float*>(smem + L::p);                   // (BQ, PL)
  float* as = reinterpret_cast<float*>(smem + L::alpha);               // (BQ,)
  float* ls = reinterpret_cast<float*>(smem + L::l);                   // (BQ,)

  const __nv_bfloat16* kg = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vg = v + b * vsb + hk * vsh;

  float m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = BIG_NEG;
    l[i] = 0.0f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int nk = (Sk + BK - 1) / BK;
  int jlo = 0;
  int jhi = nk;
  if (causal) jhi = min(nk, (q0 + BQ - 1) / BK + 1);  // tiles with k0 <= last row
  if (window > 0 && q0 - window + 1 > 0) jlo = (q0 - window + 1) / BK;

  // Groups in flight at the top of tile j: {Q}, {K(j)} or {K(j)}, then
  // {V(j)}. K(j + 1) is copied once K(j) is widened, V(j + 1) once P . V(j)
  // is done.
  stage_bf16<D>(qs, q + b * qsb + h * qsh, qss, q0, Sq, vec, tid);
  stage_bf16<D>(kbs, kg, kss, jlo * BK, Sk, vec, tid);
  stage_bf16<D>(vs, vg, vss, jlo * BK, Sk, vec, tid);
  for (int j = jlo; j < jhi; ++j) {
    const int k0 = j * BK;
    wait_async<1>();  // Q and K(j) have landed (V(j) may not have)
    __syncthreads();
    for (int i = tid; i < BK * D / 8; i += THREADS) {  // widen K(j) to f32 once
      const int r = i / (D / 8);
      const int e = (i - r * (D / 8)) * 8;
      const uint4 w = *reinterpret_cast<const uint4*>(kbs + r * LD + e);
      float4* o = reinterpret_cast<float4*>(kf + r * LDF + e);
      o[0] = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
      o[1] = make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
    }
    __syncthreads();  // the f32 K tile is written; K's staging tile is free
    if (j + 1 < jhi) stage_bf16<D>(kbs, kg, kss, k0 + BK, Sk, vec, tid);

    // scores: one f32 FMA chain over d in order for each (row, key)
    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qa[RT], kc[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const uint2 w = *reinterpret_cast<const uint2*>(qs + (ty + 16 * i) * LD + d);
        qa[i] = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
      }
#pragma unroll
      for (int c = 0; c < CT; ++c)
        kc[c] = *reinterpret_cast<const float4*>(kf + (tx + 8 * c) * LDF + d);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          s[i][c] = fmaf(qa[i].x, kc[c].x, s[i][c]);
          s[i][c] = fmaf(qa[i].y, kc[c].y, s[i][c]);
          s[i][c] = fmaf(qa[i].z, kc[c].z, s[i][c]);
          s[i][c] = fmaf(qa[i].w, kc[c].w, s[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row;
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
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float p = expf(__fsub_rn(s[i][c], mx));
        ps[row * PL + tx + 8 * c] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
      const float alpha = expf(__fsub_rn(m[i], mx));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), sum);
      m[i] = mx;
      if (tx == 0) as[row] = alpha;
    }
    if (j + 1 < jhi)
      wait_async<1>();  // V(j) has landed (K(j + 1) may not have)
    else
      wait_async<0>();
    __syncthreads();  // P, alpha and V(j) are visible

    // P . V: per 16 keys, the A fragments of lo, mid and hi from P; per 16
    // output columns, two n8 B fragments of V with one ldmatrix.trans
    float pv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
    const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // this lane's ldmatrix row
    const int vcol = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], mid[4], lo[4];
      const float* p = ps + r0 * PL + 16 * kk + 2 * t;
      split3(*reinterpret_cast<const float2*>(p), hi[0], mid[0], lo[0]);
      split3(*reinterpret_cast<const float2*>(p + 8 * PL), hi[1], mid[1], lo[1]);
      split3(*reinterpret_cast<const float2*>(p + 8), hi[2], mid[2], lo[2]);
      split3(*reinterpret_cast<const float2*>(p + 8 * PL + 8), hi[3], mid[3], lo[3]);
      const uint32_t va =
          (uint32_t)__cvta_generic_to_shared(vs + (16 * kk + vrow) * LD + vcol);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(va + 32 * np));
        mma_bf16(pv[2 * np], lo, b0, b1);
        mma_bf16(pv[2 * np], mid, b0, b1);
        mma_bf16(pv[2 * np], hi, b0, b1);
        mma_bf16(pv[2 * np + 1], lo, b2, b3);
        mma_bf16(pv[2 * np + 1], mid, b2, b3);
        mma_bf16(pv[2 * np + 1], hi, b2, b3);
      }
    }
    const float a0 = as[r0];
    const float a1 = as[r0 + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] = __fadd_rn(__fmul_rn(acc[n][0], a0), pv[n][0]);
      acc[n][1] = __fadd_rn(__fmul_rn(acc[n][1], a0), pv[n][1]);
      acc[n][2] = __fadd_rn(__fmul_rn(acc[n][2], a1), pv[n][2]);
      acc[n][3] = __fadd_rn(__fmul_rn(acc[n][3], a1), pv[n][3]);
    }
    __syncthreads();  // every reader of V(j), P and alpha is done
    if (j + 1 < jhi) stage_bf16<D>(vs, vg, vss, k0 + BK, Sk, vec, tid);
  }
  wait_async<0>();  // nothing in flight at exit (a block with no kv tile)

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RT; ++i) ls[ty + 16 * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    const int sq = q0 + row;
    if (sq >= Sq) continue;
    const float den = fmaxf(ls[row], 1e-30f);
    float* o = out + (((long long)b * Sq + sq) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * half] / den, acc[n][2 * half + 1] / den);
  }
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
               int Sq, int Sk, const long long* st, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int LD = D + PAD;
  const size_t smem = sizeof(float) * (size_t)(2 * BQ * LD + BK * D + BQ * PLD);
  cudaError_t e = cudaFuncSetAttribute(flash_mha_f32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  flash_mha_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Hq, Hkv, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
                int Sq, int Sk, const long long* st, int causal, int window, float scale,
                int vec, cudaStream_t stream) {
  constexpr size_t smem = Tiles<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(flash_mha_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)  // as much shared memory as the SM has: two blocks at D 128
    e = cudaFuncSetAttribute(flash_mha_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  flash_mha_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), Hq, Hkv, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), bf16 (is_f32 == 0) or f32, each
// addressed through its batch, sequence and head strides in elements
// (strides: q's three, then k's, then v's; d contiguous); out (B, Sq, Hq, D)
// f32 contiguous. D in {16, 64, 80, 128}; Hq a multiple of Hkv; Sq, Sk >= 1.
// causal != 0 masks kpos > qpos; window <= 0 means no window. Every query
// row must see a key (a window needs Sq < Sk + window; the wrapper checks):
// a row with none gets 0 or a mean of v depending on its tile. vec != 0
// (bf16 only) says every row of q, k and v starts on a 16-byte boundary.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_mha_launch(const void* q, const void* k, const void* v, void* out, int B,
                                int Hq, int Hkv, int Sq, int Sk, int D, const long long* strides,
                                int causal, int window, float scale, int is_f32, int vec,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  switch (D * 2 + (is_f32 != 0)) {
    case 16 * 2:  // the reduced configs
      return launch_bf16<16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, vec, s);
    case 64 * 2:  // granite-moe-1b-a400m
      return launch_bf16<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, vec, s);
    case 80 * 2:  // h2o-danube-1.8b, stablelm-3b
      return launch_bf16<80>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, vec, s);
    case 128 * 2:  // internlm2-1.8b, qwen1.5-4b
      return launch_bf16<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, vec,
                              s);
    case 16 * 2 + 1:
      return launch_f32<16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, s);
    case 64 * 2 + 1:
      return launch_f32<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, s);
    case 80 * 2 + 1:
      return launch_f32<80>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, s);
    case 128 * 2 + 1:
      return launch_f32<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, causal, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
