// Fused GQA decode attention over a quantized KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_attn_pallas
// (:142). One query token per slot attends over the slot's pages, read
// through its block-table row; the G = Hq / Hkv query heads of a kv head
// share every page read (query head h * G + g reads kv head h).
//
// Numerics follow the reference twin step for step:
//   * dequantization is (int * scale) -> __float2bfloat16_rn -> f32, the
//     rounding of models/attention.py::kv_dequantize; kv4 unpacks the signed
//     little-endian nibbles; the bf16 cell reads the stored bf16 directly;
//   * scores are dot(q, k), then __fmul_rn(., 1 / sqrt(D)), masked to
//     kpos <= pos[b] and the sliding window (window > 0); masked scores are
//     BIG_NEG and their probabilities exactly 0.0;
//   * running softmax per page: m' = max(m, max s), p = exp(s - m'),
//     alpha = exp(m - m'), l = l * alpha + sum p, acc = acc * alpha + p . v;
//     expf (not __expf), no fast math; the output is acc / max(l, 1e-30).
//
// Bound on this card: bytes. A decode step reads each visible K/V row once
// (D * bits / 8 bytes plus an f32 scale per token and head) and does
// ~4 * G * D flops a row, far below the card's ratio of flops to bytes. At
// serving batch sizes the bytes take ~1 us a call; what costs is the launch,
// the dependent trips to device memory, and the instructions of the busiest
// SM (timed phase by phase on the card, L2-warm pages ran no faster than
// cold ones; PERF.md, paged_attn's findings).
//
// Design (the first design, one block per (slot, kv head) walking its pages
// one at a time with four barriers and one-byte loads per page, took
// 7.469 ms per internlm2 decode step at kv8 and 6.152 ms on the bf16 cell on
// an H100 80GB HBM3 at 700 W; PERF.md row 2):
//   1. The page walk is split over blocks: the grid is B * Hkv * n_split,
//      n_split = ceil(NB / PPS), PPS pages a split. PPS is a compile-time
//      constant (4, the fastest of 1, 2, 4, 8 and 16 at internlm2's kv8
//      decode shapes; PERF.md row 2; kernels/paged_attn.py PAGES_PER_SPLIT
//      mirrors it for the scratch): it never depends on B, the SM count or
//      pos, so a slot's output is a function of its own logical rows, the
//      same bits for the slot view and the pool at the same page size, in any
//      batch, on every call. Visibility is decided on the device: a split with no visible
//      key (past pos[b], or slid past by the window) exits at once, and the
//      host never reads pos. Blocks are numbered split-major, so the low
//      splits, which hold visible keys, spread over the SMs.
//   2. A split's visible pages are staged whole, K and V codes and scales,
//      with cp.async, every copy of the split in flight together (16-byte
//      copies; 8, 4 or 1 where a row or the pool is not a whole number of
//      16-byte vectors: the wrapper picks VB, and every path leaves the same
//      bytes in shared memory, so all give the same bits). Rows sit in
//      shared memory at a stride rounded up to 16 bytes: lanes read whole
//      16-byte vectors along a row, 8 lanes a row, so the 8 lanes of a
//      shared-memory phase read 8 consecutive vectors (no bank conflict), and
//      cp.async's 16-byte destinations stay aligned (an odd word stride, as
//      in qkv_decode.cu, would break both).
//   3. kv8 / kv4: every staged code is dequantized once a block, (code *
//      scale) -> bf16, into bf16 rows in shared memory (the int -> float step
//      by the 2^23 trick, the rounding two values at a time), so the G heads
//      share it and the score and P . V loops are a shift and an FMA an
//      element. (The first version dequantized in those loops, once a head:
//      quarter-rate conversions took most of its time, and a block's time did
//      not move with L2-warm pages.) The bf16 cell reads its staged rows.
//   4. 256 threads a block. pos, the split's table entries and the query
//      load together (one trip, not three). Scores: 8 lanes split each row's
//      dot (two bf16 a 32-bit word, 8 a 16-byte vector), each lane a chain of
//      FMAs over its elements, joined by a fixed xor butterfly of shuffles;
//      the query sits in shared memory padded by four floats a vector of 8,
//      read as float4 from distinct banks. Softmax: the running max at page
//      jj is the max of the page maxima up to jj, so one warp a (head, page)
//      takes the page's max and then its probabilities and sum (butterflies,
//      one lane a row), all pages at once; l = l * alpha + sum then runs over
//      the pages in order. P . V: one thread a (head, d), an FMA chain over
//      the page's rows. Six barriers a split (four a page before).
//   5. Each split writes its partial (m, l, acc[G, D]) to scratch the wrapper
//      allocates; a second kernel (csrc/paged_split.cuh, shared with the
//      MLA kernel; one thread an output value) merges the splits that hold a
//      visible key (decided again from pos and window) in split order:
//      M = max m_i, l = sum l_i * exp(m_i - M), acc = sum acc_i
//      * exp(m_i - M), out = acc / max(l, 1e-30). No atomics: the same bits
//      on every call. A slot with no visible key gives 0, as the plain
//      version does. A second kernel rather than a cluster: n_split varies
//      with NB (16 at 1024 rows) and can pass a cluster's 8 or 16 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split.cuh"

namespace {

using namespace paged_split;

constexpr int PPS = 4;  // pages a split (kernels/paged_attn.py PAGES_PER_SPLIT)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LPR = 8;             // lanes a row in the score dots
constexpr int RPW = 32 / LPR;      // rows a warp scores at once

// Shared-memory layout of a split block (host and device agree). Staged
// rows of codes (LDB bytes) and, for kv8 / kv4, their dequantized bf16 rows
// (LDH bytes); the bf16 cell's staged rows are already bf16.
struct Smem {
  int RS, LDB, LDH, QLD;
  size_t k, v, ks, vs, kd, vd, q, sc, pmx, psum, al, pg, bytes;
  __host__ __device__ Smem(int bits, int D, int G, int ps) {
    RS = PPS * ps;                          // rows a split
    LDB = round16(D * bits / 8);            // bytes a staged row
    LDH = LDB * 16 / bits;                  // bytes a bf16 row
    QLD = (LDH / 16) * 12;                  // floats a head's query, 8 + 4 a vector
    const size_t deq = bits == 16 ? 0 : (size_t)RS * LDH;
    const size_t scl = bits == 16 ? 0 : sizeof(float) * RS;
    k = 0;
    v = k + (size_t)RS * LDB;
    kd = v + (size_t)RS * LDB;
    vd = kd + deq;
    ks = vd + deq;
    vs = ks + scl;
    q = round16((int)(vs + scl));
    sc = q + sizeof(float) * G * QLD;
    pmx = sc + sizeof(float) * G * RS;
    psum = pmx + sizeof(float) * G * PPS;
    al = psum + sizeof(float) * G * PPS;
    pg = al + sizeof(float) * G * PPS;
    bytes = pg + sizeof(int) * PPS;
  }
};

template <int BITS, int VB>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const float* __restrict__ q, const unsigned char* __restrict__ k,
                  const float* __restrict__ ks, const unsigned char* __restrict__ v,
                  const float* __restrict__ vs, const int* __restrict__ pos,
                  const int* __restrict__ bt, float* __restrict__ part, int Hq, int Hkv, int D,
                  int ps, int nb, int nsplit, int window, float scale) {
  // split-major: the blocks that hold visible keys (low splits) come first
  // and spread over the SMs
  const int nbh = gridDim.x / nsplit;
  const int split = blockIdx.x / nbh;
  const int bh = blockIdx.x - split * nbh;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const Smem L(BITS, D, G, ps);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kt = smem + L.k;
  unsigned char* vt = smem + L.v;
  float* ksc = reinterpret_cast<float*>(smem + L.ks);
  float* vsc = reinterpret_cast<float*>(smem + L.vs);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* pmx = reinterpret_cast<float*>(smem + L.pmx);
  float* psum = reinterpret_cast<float*>(smem + L.psum);
  float* al = reinterpret_cast<float*>(smem + L.al);
  int* pg = reinterpret_cast<int*>(smem + L.pg);
  // the rows the scores and P . V read: dequantized bf16, or the bf16 cell's
  const unsigned char* kh = BITS == 16 ? kt : smem + L.kd;
  const unsigned char* vh = BITS == 16 ? vt : smem + L.vd;

  // pos, the split's table entries and the query in one trip; the query
  // padded by four floats a vector of 8, so the 8 lanes of a row read it as
  // float4 from distinct banks
  const int s0 = split * PPS;
  const int p_last = pos[b];
  for (int i = tid; i < PPS; i += THREADS)
    pg[i] = s0 + i < nb ? bt[(long long)b * nb + s0 + i] : 0;
  const float* qb = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    const int d = i - g * D;
    qs[g * L.QLD + (d >> 3) * 12 + (d & 7)] = qb[i];
  }
  const Span vis = visible_pages(p_last, window, ps, nb);
  const int j0 = max(vis.lo, s0);
  const int j1 = min(vis.hi, s0 + PPS - 1);
  if (j0 > j1) return;  // no visible key in this split: the merge skips it
  const int npg = j1 - j0 + 1;
  const int R = npg * ps;  // staged rows; row r holds key j0 * ps + r
  __syncthreads();

  // stage: every copy of the split's visible pages in flight together
  const int RB = D * BITS / 8;  // bytes a cache row
  const int VPR = RB / VB;      // copies a row
  for (int i = tid; i < R * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = i - r * VPR;
    const int jj = r / ps;
    const long long row = ((long long)pg[j0 - s0 + jj] * ps + (r - jj * ps)) * Hkv + h;
    copy_async<VB>(kt + r * L.LDB + c * VB, k + row * RB + c * VB);
    copy_async<VB>(vt + r * L.LDB + c * VB, v + row * RB + c * VB);
  }
  if constexpr (BITS != 16) {
    for (int r = tid; r < R; r += THREADS) {
      const int jj = r / ps;
      const long long row = ((long long)pg[j0 - s0 + jj] * ps + (r - jj * ps)) * Hkv + h;
      copy_async<4>(ksc + r, ks + row);
      copy_async<4>(vsc + r, vs + row);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // kv8 / kv4: dequantize every staged code once, (code * scale) -> bf16
  if constexpr (BITS != 16) {
    const int VPB = L.LDB / 16;  // staged vectors a row
    for (int i = tid; i < 2 * R * VPB; i += THREADS) {
      const int is_v = i >= R * VPB;
      const int j = i - is_v * R * VPB;
      const int r = j / VPB;
      const int c = j - r * VPB;
      const uint4 raw = *reinterpret_cast<const uint4*>((is_v ? vt : kt) + r * L.LDB + c * 16);
      dequant_vec<BITS>(raw, (is_v ? vsc : ksc)[r],
                        smem + (is_v ? L.vd : L.kd) + r * L.LDH + c * (256 / BITS));
    }
    __syncthreads();
  }

  // scores: LPR lanes a row, each over whole 16-byte vectors of 8 bf16
  const int lig = lane & (LPR - 1);
  const int VPH = L.LDH / 16;
  for (int r0 = warp * RPW; r0 < R; r0 += WARPS * RPW) {
    const int r = r0 + lane / LPR;
    const bool in = r < R;
    const unsigned char* krow = kh + r * L.LDH;
    for (int g = 0; g < G; ++g) {
      const float* qg = qs + g * L.QLD;
      float s = 0.0f;
      if (in) {
        for (int c = lig; c < VPH; c += LPR) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 16);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
          const float* qv = qg + c * 12;
          if ((c + 1) * 8 <= D) {
            const float4 qa = *reinterpret_cast<const float4*>(qv);
            const float4 qb4 = *reinterpret_cast<const float4*>(qv + 4);
            s = fmaf(qa.x, bf16_lo(w[0]), s);
            s = fmaf(qa.y, bf16_hi(w[0]), s);
            s = fmaf(qa.z, bf16_lo(w[1]), s);
            s = fmaf(qa.w, bf16_hi(w[1]), s);
            s = fmaf(qb4.x, bf16_lo(w[2]), s);
            s = fmaf(qb4.y, bf16_hi(w[2]), s);
            s = fmaf(qb4.z, bf16_lo(w[3]), s);
            s = fmaf(qb4.w, bf16_hi(w[3]), s);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (c * 8 + e < D)
                s = fmaf(qv[e], (e & 1) ? bf16_hi(w[e >> 1]) : bf16_lo(w[e >> 1]), s);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL, s, o));
      if (in && lig == 0)
        sc[g * L.RS + r] = visible(j0 * ps + r, p_last, window) ? __fmul_rn(s, scale) : BIG_NEG;
    }
  }
  __syncthreads();

  // running softmax, page by page, its pages in parallel: the running max at
  // page jj is the max of the page maxima up to jj. One warp a (head, page),
  // one lane a row.
  for (int task = warp; task < G * npg; task += WARPS) {
    const int g = task / npg;
    const int jj = task - g * npg;
    const float* sg = sc + g * L.RS + jj * ps;
    float mx = BIG_NEG;
    for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    if (lane == 0) pmx[g * PPS + jj] = mx;
  }
  __syncthreads();
  for (int task = warp; task < G * npg; task += WARPS) {
    const int g = task / npg;
    const int jj = task - g * npg;
    float* sg = sc + g * L.RS + jj * ps;
    float m = BIG_NEG;  // the running max before this page
    for (int i = 0; i < jj; ++i) m = fmaxf(m, pmx[g * PPS + i]);
    const float mx = fmaxf(m, pmx[g * PPS + jj]);
    float sum = 0.0f;
    for (int t = lane; t < ps; t += 32) {
      const float p =
          visible((j0 + jj) * ps + t, p_last, window) ? expf(__fsub_rn(sg[t], mx)) : 0.0f;
      sg[t] = p;
      sum = __fadd_rn(sum, p);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
    if (lane == 0) {
      psum[g * PPS + jj] = sum;
      al[g * PPS + jj] = expf(__fsub_rn(m, mx));
    }
  }
  __syncthreads();

  // l = l * alpha + sum p over the pages in order: the partial's (m, l)
  float* pm = part + ((long long)bh * nsplit + split) * G * (D + 2);
  for (int g = tid; g < G; g += THREADS) {
    float m = BIG_NEG, l = 0.0f;
    for (int jj = 0; jj < npg; ++jj) {
      m = fmaxf(m, pmx[g * PPS + jj]);
      l = __fadd_rn(__fmul_rn(l, al[g * PPS + jj]), psum[g * PPS + jj]);
    }
    pm[G * D + g] = m;
    pm[G * D + G + g] = l;
  }
  // acc = acc * alpha + p . v, page by page; one thread a head and a pair of
  // d (one bf16 word), each d its own FMA chain over the page's rows
  const int DW = (D + 1) >> 1;
  const int ldw = L.LDH / 4;
  for (int i = tid; i < G * DW; i += THREADS) {
    const int g = i / DW;
    const int d = (i - g * DW) * 2;
    const float* pr = sc + g * L.RS;
    const uint32_t* vw = reinterpret_cast<const uint32_t*>(vh) + (d >> 1);
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int jj = 0; jj < npg; ++jj) {
      float pv0 = 0.0f, pv1 = 0.0f;
#pragma unroll 4
      for (int t = 0; t < ps; ++t) {
        const int r = jj * ps + t;
        const uint32_t w = vw[r * ldw];
        const float p = pr[r];
        pv0 = fmaf(p, bf16_lo(w), pv0);
        pv1 = fmaf(p, bf16_hi(w), pv1);
      }
      const float a = al[g * PPS + jj];
      acc0 = __fadd_rn(__fmul_rn(acc0, a), pv0);
      acc1 = __fadd_rn(__fmul_rn(acc1, a), pv1);
    }
    pm[g * D + d] = acc0;
    if (d + 1 < D) pm[g * D + d + 1] = acc1;
  }
}

template <int BITS, int VB>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* pos, const void* bt, void* out, void* part, int B, int Hq, int Hkv,
           int D, int ps, int nb, int window, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int nsplit = (nb + PPS - 1) / PPS;
  if (nsplit > 0) {
    const Smem L(BITS, D, G, ps);
    static size_t opted = 48 * 1024;  // dynamic shared memory allowed so far
    if (L.bytes > opted) {
      cudaError_t e = cudaFuncSetAttribute(paged_attn_kernel<BITS, VB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L.bytes);
      if (e != cudaSuccess) return (int)e;
      opted = L.bytes;
    }
    paged_attn_kernel<BITS, VB><<<B * Hkv * nsplit, THREADS, L.bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const unsigned char*>(k),
        static_cast<const float*>(ks), static_cast<const unsigned char*>(v),
        static_cast<const float*>(vs), static_cast<const int*>(pos),
        static_cast<const int*>(bt), static_cast<float*>(part), Hq, Hkv, D, ps, nb, nsplit,
        window, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_merge<PPS>(static_cast<const float*>(part), static_cast<const int*>(pos),
                                static_cast<float*>(out), B, Hq, Hkv, Hq / Hkv, D, ps, nb, nsplit,
                                window, stream);
}

template <int BITS>
int launch_vb(int vb, const void* q, const void* k, const void* ks, const void* v,
              const void* vs, const void* pos, const void* bt, void* out, void* part, int B,
              int Hq, int Hkv, int D, int ps, int nb, int window, float scale,
              cudaStream_t s) {
  switch (vb) {
    case 16:
      return launch<BITS, 16>(q, k, ks, v, vs, pos, bt, out, part, B, Hq, Hkv, D, ps, nb, window,
                              scale, s);
    case 8:
      return launch<BITS, 8>(q, k, ks, v, vs, pos, bt, out, part, B, Hq, Hkv, D, ps, nb, window,
                             scale, s);
    case 4:
      return launch<BITS, 4>(q, k, ks, v, vs, pos, bt, out, part, B, Hq, Hkv, D, ps, nb, window,
                             scale, s);
    case 1:
      return launch<BITS, 1>(q, k, ks, v, vs, pos, bt, out, part, B, Hq, Hkv, D, ps, nb, window,
                             scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, D) f32; k, v (P, ps, Hkv, D * bits / 8) int8, or bf16 when
// bits == 16; ks, vs (P, ps, Hkv) f32 (ignored for bf16); pos (B,) int32;
// bt (B, nb) int32; out (B, Hq, D) f32; part f32 scratch of
// B * Hkv * ceil(nb / PPS) * G * (D + 2) floats. window <= 0 means no
// window. vb in {16, 8, 4, 1} is the staging copy's width: it must divide
// the row's bytes and the alignment of k and v (the wrapper picks it).
// Launches the split pass and the merge; returns cudaGetLastError() after
// them, or cudaErrorInvalidValue for an argument it does not take.
extern "C" int paged_attn_launch(const void* q, const void* k, const void* ks, const void* v,
                                 const void* vs, const void* pos, const void* bt, void* out,
                                 void* part, int B, int Hq, int Hkv, int D, int ps, int nb,
                                 int bits, int window, int vb, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || D < 1 || ps < 1 || nb < 0 || vb < 1)
    return (int)cudaErrorInvalidValue;
  if ((D * (bits == 16 ? 16 : bits) / 8) % vb) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 16:
      return launch_vb<16>(vb, q, k, ks, v, vs, pos, bt, out, part, B, Hq, Hkv, D, ps, nb, window,
                           scale, s);
    case 8:
      return launch_vb<8>(vb, q, k, ks, v, vs, pos, bt, out, part, B, Hq, Hkv, D, ps, nb, window,
                          scale, s);
    case 4:
      return launch_vb<4>(vb, q, k, ks, v, vs, pos, bt, out, part, B, Hq, Hkv, D, ps, nb, window,
                          scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
