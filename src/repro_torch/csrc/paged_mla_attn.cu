// Fused absorbed Multi-head Latent Attention (MLA) decode over a compressed
// latent page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_mla_attn_pallas
// (:299). One query token per slot. Every head h scores its absorbed query
// q_lat[h] (q_nope . W_uk, C = kv_lora wide) against the slot's latent rows
// c and its rotary query q_rope[h] against the rope-key rows r, which all
// heads share (one latent row and one rope row per token), and accumulates
// the context in latent space: out (B, H, C), to which the caller applies
// W_uv.
//
// Numerics follow the reference twin (paged_mla_attn_ref) page by page:
//   * c is dequantized as (int * scale) -> __float2bfloat16_rn, the rounding
//     of models/attention.py::kv_dequantize; kv4 unpacks the signed
//     little-endian nibbles; the bf16 cell and r are read as stored. So the
//     latent and rope rows are exact bf16 values;
//   * s = (q_lat . c + q_rope . r) * scale, masked to kpos <= pos[b]; masked
//     scores are BIG_NEG and their probabilities exactly 0.0;
//   * running softmax per page: m' = max(m, max s), p = exp(s - m'),
//     alpha = exp(m - m'), l = l * alpha + sum p, acc = acc * alpha + p . c;
//     expf (not __expf), __fmul_rn / __fadd_rn outside the products, no fast
//     math. Pages past the last position are skipped: a fully masked page
//     leaves m, l and acc exactly unchanged.
//   * Both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate) at f32 precision: the f32 operand (q for the score,
//     p for the context) splits exactly into bf16 hi + mid + lo
//     (mma_pipe::split3), so every product of a part with a bf16 row is
//     exact, and each k16 step takes three products, lo, mid, hi, into an
//     accumulator that starts from zero. The tensor cores may truncate
//     inside that sum; the steps then add with __fadd_rn in k order (the
//     score over [q_lat | q_rope] . [c | r], its two parts zero-padded to
//     multiples of 16; the context over a page's rows in groups of 16, the
//     first added to acc * alpha). At DeepSeek-V3's widths and scores up to
//     ~20, where two f32 orders of sums part by about 1e-5, this keeps the
//     output within a third of 1e-5 of the exact (f64) attention on the
//     card (the plain version's f32 sums: 1.2 times 1e-5; chip_smoke.py),
//     and within 1e-5 of the plain version and the reference twin where one
//     f32 FMA chain a score, this kernel's first design, is not
//     (tests/test_torch_mla_split.py repeats this arithmetic on the CPU with
//     every product's sum rounded toward zero).
//
// Bound on this card, DeepSeek-V3 (H 128, C 512, dr 64) at kv8: a cached
// row is C bytes of latent, a 4-byte scale and 2 * dr bytes of rope key (644
// bytes), and a slot reads and writes (C + dr + C) * 4 bytes of query and
// output a head. Per row and head the products take 2 * (C + dr) + 2 * C
// flops, each three bf16 tensor-core products: ~1.2 GFLOP a decode call at
// the serving positions, ~1.3 us at 989 TFLOP/s, about what its ~3.5 MB of
// bytes take at 3.35 TB/s. The first design did that work on the CUDA
// cores (one block per (slot, 4 heads), every page staged 32 times, one FMA
// chain a score) in 1.108 ms a decode step; this one takes ~0.08 ms, the
// split pass ~70% of it (PERF.md row 9; a block's time is spread over its
// staging, the three-part products and the softmax, none of them
// dominant).
//
// Design (the split of csrc/paged_attn.cu, with heads batched for the
// tensor cores):
//   1. The page walk is split over blocks: a block takes a run of PPS pages
//      of one slot for HB heads (the grid is n_split * B * ceil(H / HB),
//      split-major, so the low splits, which hold visible keys, spread over
//      the SMs). PPS and HB are compile-time constants, never from B, the SM
//      count or pos: a slot's output is a function of its own logical rows,
//      the same bits through the dense slot view and the pool, in any batch,
//      on every call. A split with no visible key exits at once, decided on
//      the device; the host never reads pos.
//   2. A split's visible pages are staged once a block with cp.async, every
//      copy in flight together: the latent codes and their f32 scales (the
//      bf16 cell's rows straight into their bf16 rows) and the bf16 rope rows
//      (into the rope columns of the same rows), 16 bytes a copy, or 8, 4 or
//      1 where a row or a pool is not a whole number of 16-byte vectors (a
//      kv4 row of C = 16 is 8 bytes): the wrapper picks VB, and every width
//      leaves the same bytes, so the same bits. kv8 / kv4 codes are then
//      dequantized once into bf16 rows [c | 0 | r | 0] that all HB heads
//      read. Each page takes round16(ps) rows (the tail zeros).
//   3. The queries split once a block into bf16 hi / mid / lo rows [q_lat |
//      0 | q_rope | 0] in shared memory. Scores: rows of tokens as the MMA's
//      M (A: the bf16 rows, ldmatrix), heads as N (B: the three parts,
//      ldmatrix); a warp takes 16 rows x 16 heads over all of K. Softmax:
//      one thread a (head, page), the running max at page jj the max of the
//      page maxima up to jj, as in paged_attn.cu. Context: heads as M (A: p
//      split in registers from the f32 tile), latent columns as N (B: the
//      same bf16 rows, ldmatrix.trans); a warp holds 16 heads x CMAX / WARPS
//      x MT columns of acc in registers across the split's pages.
//      The queries load 16 bytes at a time, every load of a block in flight
//      together; the codes dequantize 16 bytes of codes a step
//      (paged_split.cuh's dequant_vec, as in paged_attn.cu).
//   4. Each split writes its partial (acc[HB, C], m[HB], l[HB]) in the
//      layout of csrc/paged_split.cuh (acc through shared memory, so the
//      stores are whole 16-byte vectors), and that file's merge (paged_attn's,
//      with Hkv = ceil(H / HB) groups of G = HB heads, D = C) combines the
//      splits that hold a visible key in split order. No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_pipe.cuh"
#include "paged_split.cuh"

namespace {

using namespace paged_split;

// pages a split (kernels/paged_attn.py MLA_PAGES_PER_SPLIT) and heads a
// block (MLA_HEADS_PER_BLOCK, a multiple of 16): (32, 4) was the fastest of
// HB in {16, 32} x PPS in {1, 2, 4} at DeepSeek-V3's kv8 decode shapes on an
// H100 (scripts/sweep_mla_split.py; PERF.md row 9). (32, 8) would not fit a
// block's shared memory at C 512.
constexpr int PPS = 4;
constexpr int HB = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MT = HB / 16;                 // m16 head tiles of the context
constexpr int CMAX = 512;                   // widest latent row the context holds
constexpr int NI = CMAX / 16 * MT / WARPS;  // n16 column tiles of acc a warp
static_assert(HB % 16 == 0 && WARPS % MT == 0 && NI % 4 == 0,
              "head tiles must share the warps evenly");
// groups of 8 query values a thread loads before splitting any: all of a
// block's at DeepSeek-V3's widths (C 512 + dr 64)
constexpr int QU = (HB * (512 + 64) / 8 + THREADS - 1) / THREADS;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// z = a . b + (first ? 0 : z): the first of a k16 step's three products
// starts from zero
__device__ __forceinline__ void mma_part(float (&z)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, bool first) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (first)
    mma_pipe::mma_bf16(z, a, b0, b1, zero);
  else
    mma_pipe::mma_bf16(z, a, b0, b1, z);
}

// Shared-memory layout of a split block (host and device agree). bf16 rows
// of K = round16(C) + round16(dr) values at a stride of K + 8 (16 bytes of
// padding: the 8 rows of an ldmatrix phase fall on distinct banks): the
// query's three parts (HB rows each) and the split's latent rows (R). Then
// the raw codes and scales of kv8 / kv4, which the score tile and the
// softmax's per-page values reuse once the codes are dequantized.
struct Smem {
  int PR, R, K, LD, RB, PLD;
  size_t q, c, raw, scl, p, pmx, psum, al, pg, bytes;
  __host__ __device__ Smem(int bits, int C, int dr, int ps) {
    PR = round16(ps);                            // rows a page
    R = PPS * PR;                                // rows a split
    K = round16(C) + round16(dr);
    LD = K + 8;                                  // bf16 a row
    RB = bits == 16 ? 0 : round16(C * bits / 8);  // bytes a raw row
    PLD = R + (40 - R % 32) % 32;                // floats a score row: 8 mod 32
    q = 0;
    c = q + sizeof(__nv_bfloat16) * 3 * HB * LD;
    raw = c + sizeof(__nv_bfloat16) * R * LD;
    scl = raw + (size_t)R * RB;
    const size_t raw_end = scl + (bits == 16 ? 0 : sizeof(float) * R);
    p = raw;
    pmx = p + sizeof(float) * HB * PLD;
    psum = pmx + sizeof(float) * HB * PPS;
    al = psum + sizeof(float) * HB * PPS;
    const size_t p_end = al + sizeof(float) * HB * PPS;
    pg = round16((int)(raw_end > p_end ? raw_end : p_end));
    bytes = pg + sizeof(int) * PPS;
  }
};

template <int BITS, int VB>
__global__ void __launch_bounds__(THREADS, 1)
paged_mla_split_kernel(const float* __restrict__ ql, const float* __restrict__ qr,
                       const unsigned char* __restrict__ cq, const float* __restrict__ cs,
                       const unsigned char* __restrict__ r, const int* __restrict__ pos,
                       const int* __restrict__ bt, float* __restrict__ part, int H, int C,
                       int dr, int ps, int nb, int nsplit, float scale) {
  const int HG = (H + HB - 1) / HB;
  const int nbh = gridDim.x / nsplit;  // B * HG
  const int split = blockIdx.x / nbh;
  const int bh = blockIdx.x - split * nbh;
  const int b = bh / HG;
  const int h0 = (bh - b * HG) * HB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const Smem L(BITS, C, dr, ps);
  const int C16 = round16(C);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);  // hi, mid, lo
  __nv_bfloat16* cf = reinterpret_cast<__nv_bfloat16*>(smem + L.c);
  unsigned char* raw = smem + L.raw;
  float* scl = reinterpret_cast<float*>(smem + L.scl);
  float* sc = reinterpret_cast<float*>(smem + L.p);  // (HB, PLD) scores, then p
  float* pmx = reinterpret_cast<float*>(smem + L.pmx);
  float* psum = reinterpret_cast<float*>(smem + L.psum);
  float* al = reinterpret_cast<float*>(smem + L.al);
  int* pg = reinterpret_cast<int*>(smem + L.pg);

  const int s0 = split * PPS;
  const int p_last = pos[b];
  for (int i = tid; i < PPS; i += THREADS)
    pg[i] = s0 + i < nb ? bt[(long long)b * nb + s0 + i] : 0;
  const Span vis = visible_pages(p_last, 0, ps, nb);  // pages 0..vis.hi
  const int npg = min(vis.hi, s0 + PPS - 1) - s0 + 1;
  if (npg <= 0) return;  // no visible key in this split: the merge skips it
  const int RA = npg * L.PR;  // rows the products take
  __syncthreads();

  // stage every copy of the split's visible pages, then zero what no copy
  // writes: the tail rows of each page and the padding columns
  const int CB = C * BITS / 8;  // bytes a stored latent row (bf16: 2 C)
  const int CV = CB / VB, DV = 2 * dr / VB;
  for (int i = tid; i < npg * ps * (CV + DV); i += THREADS) {
    const int row = i / (CV + DV);
    const int v = i - row * (CV + DV);
    const int jj = row / ps;
    const int srow = jj * L.PR + row - jj * ps;
    const long long grow = (long long)pg[jj] * ps + row - jj * ps;
    unsigned char* dst = reinterpret_cast<unsigned char*>(cf + (long long)srow * L.LD);
    if (v < CV) {
      if constexpr (BITS != 16) dst = raw + srow * L.RB;
      copy_async<VB>(dst + v * VB, cq + grow * CB + v * VB);
    } else {
      copy_async<VB>(dst + C16 * 2 + (v - CV) * VB, r + grow * 2 * dr + (v - CV) * VB);
    }
  }
  if constexpr (BITS != 16) {
    for (int row = tid; row < npg * ps; row += THREADS) {
      const int jj = row / ps;
      copy_async<4>(scl + jj * L.PR + row - jj * ps, cs + (long long)pg[jj] * ps + row - jj * ps);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int K8 = L.K / 8;
  for (int i = tid; i < npg * (L.PR - ps) * K8; i += THREADS) {  // tail rows
    const int row = i / K8;
    const int jj = row / (L.PR - ps);
    const int srow = jj * L.PR + ps + row - jj * (L.PR - ps);
    *reinterpret_cast<uint4*>(cf + srow * L.LD + (i - row * K8) * 8) = make_uint4(0, 0, 0, 0);
  }
  const int ZC = BITS == 16 ? C16 - C : 0;  // kv8 / kv4: the dequantization zeroes them
  const int NZ = ZC + L.K - C16 - dr;       // padding columns a staged row
  for (int i = tid; i < npg * ps * NZ; i += THREADS) {
    const int row = i / NZ;
    const int z = i - row * NZ;
    const int jj = row / ps;
    cf[(jj * L.PR + row - jj * ps) * L.LD + (z < ZC ? C + z : C16 + dr + z - ZC)] =
        __float2bfloat16_rn(0.0f);
  }

  // the queries, split into bf16 hi, mid and lo rows; heads past H and the
  // padding columns are zeros. QU groups of 8 values a thread are loaded
  // before any is split, so their trips to memory overlap (one trip at
  // DeepSeek-V3's widths), two 16-byte loads a group where it can
  const bool qv = C % 4 == 0 && dr % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(ql) | reinterpret_cast<uintptr_t>(qr)) & 15) == 0;
  for (int i0 = tid; i0 < HB * K8; i0 += QU * THREADS) {
    float x[QU][8];
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const int i = i0 + u * THREADS;
      const int hh = i / K8;
      const int k0 = (i - hh * K8) * 8;
      const long long h = (long long)b * H + h0 + hh;
      const bool in = i < HB * K8 && h0 + hh < H;
      const float* src = nullptr;  // 8 values in one part, 16-byte aligned
      if (qv && k0 + 8 <= C) src = ql + h * C + k0;
      if (qv && k0 >= C16 && k0 + 8 <= C16 + dr) src = qr + h * dr + k0 - C16;
      if (in && src) {
        const float4 x0 = *reinterpret_cast<const float4*>(src);
        const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
        x[u][0] = x0.x, x[u][1] = x0.y, x[u][2] = x0.z, x[u][3] = x0.w;
        x[u][4] = x1.x, x[u][5] = x1.y, x[u][6] = x1.z, x[u][7] = x1.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = k0 + e;
          x[u][e] = 0.0f;
          if (in) {
            if (k < C)
              x[u][e] = ql[h * C + k];
            else if (k >= C16 && k < C16 + dr)
              x[u][e] = qr[h * dr + k - C16];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const int i = i0 + u * THREADS;
      if (i < HB * K8) {
        const int hh = i / K8;
        const int k0 = (i - hh * K8) * 8;
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mma_pipe::split3(make_float2(x[u][2 * e], x[u][2 * e + 1]), hi[e], mid[e], lo[e]);
        __nv_bfloat16* dst = qs + hh * L.LD + k0;
        *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(dst + HB * L.LD) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
        *reinterpret_cast<uint4*>(dst + 2 * HB * L.LD) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // kv8 / kv4: dequantize every staged code once, (code * scale) -> bf16: a
  // 16-byte vector of codes a step where all its columns lie below C, a
  // 32-bit word a step past that; columns past C become zeros
  if constexpr (BITS != 16) {
    constexpr int EPV = 128 / BITS;  // codes a vector
    constexpr int EPW = 32 / BITS;   // codes a word
    const int FV = C / EPV;          // whole vectors a row
#pragma unroll 2
    for (int i = tid; i < npg * ps * FV; i += THREADS) {
      const int row = i / FV;
      const int v = i - row * FV;
      const int jj = row / ps;
      const int srow = jj * L.PR + row - jj * ps;
      dequant_vec<BITS>(*reinterpret_cast<const uint4*>(raw + srow * L.RB + v * 16), scl[srow],
                        reinterpret_cast<unsigned char*>(cf + srow * L.LD + v * EPV));
    }
    const int W0 = FV * EPV / EPW;  // the first word past the whole vectors
    const int WT = C16 / EPW - W0;  // words a row from there to round16(C)
    for (int i = tid; i < npg * ps * WT; i += THREADS) {
      const int row = i / WT;
      const int w = W0 + i - row * WT;
      const int jj = row / ps;
      const int srow = jj * L.PR + row - jj * ps;
      const int c0 = w * EPW;
      const uint32_t word = *reinterpret_cast<const uint32_t*>(raw + srow * L.RB + w * 4);
      const float s = scl[srow];
      uint32_t o[EPW / 2];
#pragma unroll
      for (int e = 0; e < EPW; e += 2) {
        const float x0 = c0 + e < C ? __fmul_rn(code_f32<BITS>(word, e), s) : 0.0f;
        const float x1 = c0 + e + 1 < C ? __fmul_rn(code_f32<BITS>(word, e + 1), s) : 0.0f;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
        o[e / 2] = *reinterpret_cast<const uint32_t*>(&hv);
      }
      __nv_bfloat16* dst = cf + srow * L.LD + c0;
      if constexpr (BITS == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t qbase = (uint32_t)__cvta_generic_to_shared(qs);
  const uint32_t cbase = (uint32_t)__cvta_generic_to_shared(cf);
  const uint32_t part_bytes = 2u * HB * L.LD;  // one query part

  // scores: a warp takes 16 rows (M, the A operand: the bf16 rows) x 16
  // heads (N, two n8 tiles of B: the query's parts) over all of K; each k16
  // step from zero, lo then mid then hi, added to the sum with __fadd_rn
  const int RT = RA / 16;
  for (int it = warp; it < RT * MT; it += WARPS) {
    const int rt = it % RT;
    const int ht = it / RT;
    const uint32_t aa =
        cbase + 2u * ((rt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.LD + (lane >> 4) * 8);
    const uint32_t ba =
        qbase + 2u * ((ht * 16 + (lane & 7) + (lane >> 4) * 8) * L.LD + ((lane >> 3) & 1) * 8);
    float run[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    // two k16 steps an iteration, their four product chains issued part by
    // part, so that no product waits on the one before it
    for (int k0 = 0; k0 < L.K; k0 += 32) {
      const bool two = k0 + 16 < L.K;
      uint32_t a[2][4], bq[2][3][4];  // bq: the query's hi, mid, lo
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        if (st == 0 || two) {
          const uint32_t k = 2u * (k0 + 16 * st);
          ldsm_x4(a[st], aa + k);
#pragma unroll
          for (int pt = 0; pt < 3; ++pt) ldsm_x4(bq[st][pt], ba + pt * part_bytes + k);
        }
      }
      float z[2][2][4];
#pragma unroll
      for (int pt = 2; pt >= 0; --pt)  // lo, mid, hi
#pragma unroll
        for (int st = 0; st < 2; ++st)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            if (st == 0 || two)
              mma_part(z[st][nt], a[st], bq[st][pt][2 * nt], bq[st][pt][2 * nt + 1], pt == 2);
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (st == 0 || two) run[nt][e] = __fadd_rn(run[nt][e], z[st][nt][e]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rt * 16 + g + (e >> 1) * 8;
        const int hh = ht * 16 + nt * 8 + 2 * t + (e & 1);
        const int jj = row / L.PR;
        const int tt = row - jj * L.PR;
        const bool vis_key = tt < ps && (s0 + jj) * ps + tt <= p_last;
        sc[hh * L.PLD + row] = vis_key ? __fmul_rn(run[nt][e], scale) : BIG_NEG;
      }
  }
  __syncthreads();

  // running softmax, page by page, its pages in parallel: one thread a
  // (head, page). The running max at page jj is the max of the page maxima
  // up to jj; a page's p sum runs over its rows in order
  for (int task = tid; task < HB * npg; task += THREADS) {
    const int hh = task / npg;
    const int jj = task - hh * npg;
    const float4* sg = reinterpret_cast<const float4*>(sc + hh * L.PLD + jj * L.PR);
    float mx = BIG_NEG;
    for (int v = 0; v < L.PR / 4; ++v) {
      const float4 x = sg[v];
      mx = fmaxf(fmaxf(mx, x.x), fmaxf(fmaxf(x.y, x.z), x.w));
    }
    pmx[hh * PPS + jj] = mx;
  }
  __syncthreads();
  for (int task = tid; task < HB * npg; task += THREADS) {
    const int hh = task / npg;
    const int jj = task - hh * npg;
    float4* sg = reinterpret_cast<float4*>(sc + hh * L.PLD + jj * L.PR);
    float m = BIG_NEG;  // the running max before this page
    for (int i = 0; i < jj; ++i) m = fmaxf(m, pmx[hh * PPS + i]);
    const float mx = fmaxf(m, pmx[hh * PPS + jj]);
    const int k0 = (s0 + jj) * ps;
    float sum = 0.0f;
    for (int v = 0; v < L.PR / 4; ++v) {
      float x[4] = {sg[v].x, sg[v].y, sg[v].z, sg[v].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = 4 * v + e;
        x[e] = tt < ps && k0 + tt <= p_last ? expf(__fsub_rn(x[e], mx)) : 0.0f;
        sum = __fadd_rn(sum, x[e]);
      }
      sg[v] = make_float4(x[0], x[1], x[2], x[3]);
    }
    psum[hh * PPS + jj] = sum;
    al[hh * PPS + jj] = expf(__fsub_rn(m, mx));
  }
  __syncthreads();

  // the partial's (m, l): l = l * alpha + sum p over the pages in order
  float* pm = part + ((long long)bh * nsplit + split) * HB * (C + 2);
  for (int hh = tid; hh < HB; hh += THREADS) {
    float m = BIG_NEG, l = 0.0f;
    for (int jj = 0; jj < npg; ++jj) {
      m = fmaxf(m, pmx[hh * PPS + jj]);
      l = __fadd_rn(__fmul_rn(l, al[hh * PPS + jj]), psum[hh * PPS + jj]);
    }
    pm[HB * C + hh] = m;
    pm[HB * C + HB + hh] = l;
  }

  // context: a warp takes heads mt * 16.. (M, A: p split in registers) and
  // the n16 column tiles nc = warp / MT + i * WARPS / MT (N, B: the bf16
  // rows through ldmatrix.trans); acc = acc * alpha + (the page's first 16
  // rows), then + each later 16
  const int mt = warp % MT;
  const int r0 = mt * 16 + g;
  const int NC = C16 / 16;
  float acc[NI][2][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // this lane's ldmatrix row
  const int vcol = (lane >> 4) * 8;
  for (int jj = 0; jj < npg; ++jj) {
    const float a0 = al[r0 * PPS + jj];
    const float a1 = al[(r0 + 8) * PPS + jj];
    for (int kk = 0; kk < L.PR / 16; ++kk) {
      const int k0 = jj * L.PR + 16 * kk;
      uint32_t pp[3][4];  // p's hi, mid, lo: the A fragments of rows r0, r0 + 8
      const float* p = sc + r0 * L.PLD + k0 + 2 * t;
#pragma unroll
      for (int f = 0; f < 4; ++f)
        mma_pipe::split3(*reinterpret_cast<const float2*>(p + (f & 1) * 8 * L.PLD + (f >> 1) * 8),
                         pp[0][f], pp[1][f], pp[2][f]);
      const uint32_t va = cbase + 2u * ((k0 + vrow) * L.LD + vcol);
      // four column tiles at a time, their eight product chains issued part
      // by part
#pragma unroll
      for (int i = 0; i < NI; i += 4) {
        bool ok[4];
        uint32_t bv[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int nc = warp / MT + (i + u) * (WARPS / MT);
          ok[u] = nc < NC;
          if (ok[u]) ldsm_x4_trans(bv[u], va + 32u * nc);
        }
        float z[4][2][4];
#pragma unroll
        for (int pt = 2; pt >= 0; --pt)  // lo, mid, hi
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int n = 0; n < 2; ++n)
              if (ok[u])
                mma_part(z[u][n], pp[pt], bv[u][2 * n], bv[u][2 * n + 1], pt == 2);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (ok[u]) {
                float& x = acc[i + u][n][e];
                x = __fadd_rn(kk == 0 ? __fmul_rn(x, e < 2 ? a0 : a1) : x, z[u][n][e]);
              }
      }
    }
  }
  // acc through shared memory (the query's rows, read by no one since the
  // scores; rows of OLD = round16(C) + 8 floats, so the fragments' float2
  // stores fall on distinct banks), then to the partial in whole rows
  float* ot = reinterpret_cast<float*>(smem + L.q);
  const int OLD = C16 + 8;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int nc = warp / MT + i * (WARPS / MT);
    if (nc < NC) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(ot + (r0 + 8 * hf) * OLD + nc * 16 + n * 8 + 2 * t) =
              make_float2(acc[i][n][2 * hf], acc[i][n][2 * hf + 1]);
    }
  }
  __syncthreads();
  if (C % 4 == 0) {
    const int C4 = C / 4;
    for (int i = tid; i < HB * C4; i += THREADS) {
      const int hh = i / C4;
      const int v = i - hh * C4;
      *reinterpret_cast<float4*>(pm + hh * C + 4 * v) =
          *reinterpret_cast<const float4*>(ot + hh * OLD + 4 * v);
    }
  } else {
    for (int i = tid; i < HB * C; i += THREADS) {
      const int hh = i / C;
      pm[i] = ot[hh * OLD + i - hh * C];
    }
  }
}

template <int BITS, int VB>
int launch(const void* ql, const void* qr, const void* cq, const void* cs, const void* r,
           const void* pos, const void* bt, void* out, void* part, int B, int H, int C, int dr,
           int ps, int nb, float scale, cudaStream_t stream) {
  const int HG = (H + HB - 1) / HB;
  const int nsplit = (nb + PPS - 1) / PPS;
  if (nsplit > 0) {
    const Smem L(BITS, C, dr, ps);
    if (L.bytes > (size_t)mma_pipe::MAX_SMEM) return (int)cudaErrorInvalidValue;
    static size_t opted = 48 * 1024;  // dynamic shared memory allowed so far
    if (L.bytes > opted) {
      cudaError_t e = mma_pipe::allow_smem(paged_mla_split_kernel<BITS, VB>, (int)L.bytes);
      if (e != cudaSuccess) return (int)e;
      opted = L.bytes;
    }
    paged_mla_split_kernel<BITS, VB><<<nsplit * B * HG, THREADS, L.bytes, stream>>>(
        static_cast<const float*>(ql), static_cast<const float*>(qr),
        static_cast<const unsigned char*>(cq), static_cast<const float*>(cs),
        static_cast<const unsigned char*>(r), static_cast<const int*>(pos),
        static_cast<const int*>(bt), static_cast<float*>(part), H, C, dr, ps, nb, nsplit, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_merge<PPS>(static_cast<const float*>(part), static_cast<const int*>(pos),
                                static_cast<float*>(out), B, H, HG, HB, C, ps, nb, nsplit, 0,
                                stream);
}

template <int BITS>
int launch_vb(int vb, const void* ql, const void* qr, const void* cq, const void* cs,
              const void* r, const void* pos, const void* bt, void* out, void* part, int B, int H,
              int C, int dr, int ps, int nb, float scale, cudaStream_t s) {
  switch (vb) {
    case 16:
      return launch<BITS, 16>(ql, qr, cq, cs, r, pos, bt, out, part, B, H, C, dr, ps, nb, scale,
                              s);
    case 8:
      return launch<BITS, 8>(ql, qr, cq, cs, r, pos, bt, out, part, B, H, C, dr, ps, nb, scale,
                             s);
    case 4:
      return launch<BITS, 4>(ql, qr, cq, cs, r, pos, bt, out, part, B, H, C, dr, ps, nb, scale,
                             s);
    case 1:
      return launch<BITS, 1>(ql, qr, cq, cs, r, pos, bt, out, part, B, H, C, dr, ps, nb, scale,
                             s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ql (B, H, C) f32; qr (B, H, dr) f32; cq (P, ps, 1, C * bits / 8) int8, or
// bf16 when bits == 16; cs (P, ps, 1) f32 (ignored for bf16); r (P, ps, 1,
// dr) bf16; pos (B,) int32; bt (B, nb) int32; out (B, H, C) f32; part f32
// scratch of B * ceil(H / HB) * ceil(nb / PPS) * HB * (C + 2) floats. vb in
// {16, 8, 4, 1} is the staging copy's width: it must divide a latent row's
// and a rope row's bytes and the alignment of cq and r (the wrapper picks
// it). C <= CMAX. Launches the split pass and the merge; returns
// cudaGetLastError() after them, or cudaErrorInvalidValue for an argument it
// does not take (also when the block's shared memory would pass the card's).
extern "C" int paged_mla_attn_launch(const void* ql, const void* qr, const void* cq,
                                     const void* cs, const void* r, const void* pos,
                                     const void* bt, void* out, void* part, int B, int H, int C,
                                     int dr, int ps, int nb, int bits, int vb, float scale,
                                     void* stream) {
  if (B < 1 || H < 1 || C < 1 || C > CMAX || dr < 1 || ps < 1 || nb < 0 || vb < 1)
    return (int)cudaErrorInvalidValue;
  if ((bits == 4 && C % 2) || (C * (bits == 16 ? 16 : bits) / 8) % vb || (2 * dr) % vb)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 16:
      return launch_vb<16>(vb, ql, qr, cq, cs, r, pos, bt, out, part, B, H, C, dr, ps, nb, scale,
                           s);
    case 8:
      return launch_vb<8>(vb, ql, qr, cq, cs, r, pos, bt, out, part, B, H, C, dr, ps, nb, scale,
                          s);
    case 4:
      return launch_vb<4>(vb, ql, qr, cq, cs, r, pos, bt, out, part, B, H, C, dr, ps, nb, scale,
                          s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
