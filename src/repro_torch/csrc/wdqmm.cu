// Weight-only dequant matmul for Hopper (sm_90a):
//   y[m, n] = sum_k x[m, k] * (eps_w * w[n, k])        (M, N) f32
// x (M, K) bf16 or f32, w (N, K * w_bits / 8) packed signed (w_bits 8, 4, 2),
// eps_w one f32 on the device.
//
// Replaces the TPU kernel src/repro/kernels/wdqmm.py::wdqmm_pallas (its grid's
// sequential K axis becomes a loop inside the block). The Pallas kernel rounds
// w * eps_w and x through bf16 before a bf16 dot; this kernel stays within
// c * sum_k |x[m, k] w[n, k]| (c = 2^-20, kernels/wdqmm.py TOL) of the f32
// twin instead (wdqmm.py::wdqmm_ref, kernels/ref.py::wdqmm_ref here), which
// is what the reference runs wherever its tests look (impl="auto" resolves to
// it off the TPU). Two kernels, by the activations' type:
//
// bf16 activations (every model path; core/linear.py): the tensor cores,
// mma.sync m16n8k16 bf16 x bf16 -> f32, in the shared skeleton of
// mma_pipe.cuh (a cp.async ring of operand tiles in shared memory):
//   * the weights are unpacked on chip to exact bf16 integers: the field with
//     its top bit flipped (the sign extension of quant.cuh's field_s,
//     little-endian in-byte fields, as core/pack.py lays them out) goes under
//     the exponent of 128 (w 4, 2; one LOP3 for two values) or of 1.5 * 2^23
//     in f32 (w 8), and the constant is subtracted. Every product of a bf16
//     activation and such a weight is exact in f32, and eps_w scales the sum
//     once (__fmul_rn); that differs from the twin's sum of x * (w * eps_w)
//     by about 2^-23 * sum |x w|;
//   * the tensor cores do not round their f32 sums to nearest, so the sum
//     restarts every KP = 64 values: each chunk's 4 k16 steps go into a zero
//     accumulator, and the chunks' partials are added with __fadd_rn in
//     increasing k (tests/test_torch_wdqmm_mma.py emulates it at K = 18432);
//   * one order for every M: the chunks, the k slots of their steps (fixed
//     by the unpacking's pairs) and the fold depend on K alone, never on M,
//     the tile or the alignment. At M <= 16 (one m16 row tile) the warps of a
//     block take the chunks of a stage side by side and exchange their
//     partials through shared memory, folded in chunk order; at M > 16
//     (64 x 128 block tiles, each weight tile serving 64 rows) a warp folds
//     its chunks itself. So a row has the same bits at M = 1, 4, 16 and
//     2048; no atomics;
//   * bound at decode (M <= 16) by the packed weights' bytes, read once a
//     call; the launcher picks narrow tiles (8 or 16 columns) below N = 8192
//     so that the 1 MB projections still spread over the SMs, 32 above.
//
// f32 activations (the wrapper takes them; no model path passes them): the
// first design's CUDA-core kernel, unchanged. Each weight is dequantized as
// __fmul_rn((float)w_int, eps_w), exactly the twin's f32 array w, and the
// products accumulate in f32 with FMAs in a fixed order: lane l of a warp
// sums, in increasing k, the values of its own K groups (group g of R values
// when g % 32 == l on the vector path, value k when k % 32 == l on the
// scalar path), then the 32 lane sums meet in a butterfly of shuffles.
// Nothing depends on M, the row tile or the staging. One load of R values a
// lane and column a step (16 bytes at w 8 and 4, 8 at w 2), the next step's
// loads in flight; the fields go under the exponent of 1.5 * 2^23; the M <=
// 16 activation rows are staged as f32, KC values at a time, XOR-swizzled.
// The vector path needs K % R == 0 and 16-byte aligned w; any other shape
// takes the scalar path (the same arithmetic).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda_bf16.h>

#include "mma_pipe.cuh"
#include "quant.cuh"

namespace {

constexpr int WARPS = 8;              // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int KC = 1024;              // K values per staged chunk, a multiple of 32 * R
constexpr int SB = 8;                 // staging loads a thread issues before storing
constexpr uint32_t MAGIC = 0x4B400000u;  // 1.5 * 2^23: float(MAGIC | u) = 12582912 + u

template <int WB>
struct Fields {
  static constexpr int R = WB == 2 ? 32 : 128 / WB;  // values a lane loads per step
  static constexpr int WORDS = R * WB / 32;          // 32-bit words of one load
  static constexpr int PER_WORD = 32 / WB;
  // flips the top bit of every field: u' = v + 2^(WB-1) for the signed value v
  static constexpr uint32_t FLIP = WB == 8 ? 0x80808080u : WB == 4 ? 0x88888888u : 0xAAAAAAAAu;
  static constexpr float BIAS = 12582912.0f + (float)(1 << (WB - 1));
};

// One lane's packed weights of a step: 16 bytes (w 8, 4) or 8 bytes (w 2).
struct Packed {
  uint32_t w[4];
};

template <int WB>
__device__ __forceinline__ Packed load_packed(const int8_t* p) {
  Packed r;
  if constexpr (Fields<WB>::WORDS == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = 0u; r.w[3] = 0u;
  }
  return r;
}

// Signed field i of a packed word whose fields' top bits are flipped, as an
// exact f32.
template <int WB>
__device__ __forceinline__ float field_f(uint32_t wx, int i) {
  uint32_t u;
  if constexpr (WB == 8) {
    u = __byte_perm(wx, MAGIC, 0x7650 + i);  // byte i under the exponent bytes
  } else {
    u = ((wx >> (i * WB)) & ((1u << WB) - 1u)) | MAGIC;
  }
  return __fadd_rn(__uint_as_float(u), -Fields<WB>::BIAS);
}

// Four consecutive f32 activations from element offset i (16-byte aligned).
__device__ __forceinline__ float4 load4(const float* x, long long i) {
  return __ldg(reinterpret_cast<const float4*>(x + i));
}

template <int WB, int MT, int CPW>
__global__ void __launch_bounds__(THREADS)
wdqmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ eps_p, float* __restrict__ y, int M, int N, int K,
             int vec, int x_al) {
  extern __shared__ __align__(16) float xs[];  // (rows, KC) f32
  constexpr int R = Fields<WB>::R;
  constexpr int STRIPE = 32 * R;  // values of one step of the warp's 32 lanes
  constexpr int COLS = WARPS * CPW;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * COLS + warp * CPW;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const long long Kw = (long long)K * WB / 8;  // packed bytes per weight row
  const float eps = __ldg(eps_p);
  float4* xs4 = reinterpret_cast<float4*>(xs);

  const int8_t* wrow[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) wrow[c] = w + (long long)min(n0 + c, N - 1) * Kw;

  float acc[CPW][MT];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.0f;
  }

  // vector path: this lane's groups are g = lane + 32 i over the whole K; the
  // loads of the next one are in flight while the current one is summed
  const int ng = vec ? K / R : 0;
  int g = lane;
  Packed cur[CPW], nxt[CPW];
  auto fetch = [&](Packed (&dst)[CPW], int gi) {
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      if (n0 + c < N) {
        dst[c] = load_packed<WB>(wrow[c] + (long long)gi * (R * WB / 8));
      } else {
        dst[c].w[0] = dst[c].w[1] = dst[c].w[2] = dst[c].w[3] = 0u;
      }
    }
  };
  if (n0 < N && g < ng) fetch(cur, g);

  for (int kc0 = 0; kc0 < K; kc0 += KC) {
    const int kc = min(KC, K - kc0);
    __syncthreads();  // the previous chunk's readers are done
    if (vec) {
      // the unit of 4 values at chunk offset k goes to float4 slot
      // s * 8R + j * 32 + (G ^ j): stripe s, step j, lane G
      constexpr int UNITS = KC / 4;  // per row; past kc they are zeros
      const int total = mt * UNITS;
      for (int base = threadIdx.x; base < total; base += THREADS * SB) {
        float4 v[SB];
#pragma unroll
        for (int t = 0; t < SB; ++t) {
          const int i = base + t * THREADS;
          const int m = i / UNITS;
          const int k = 4 * (i % UNITS);
          v[t] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < total && k < kc) {
            const long long at = (long long)(m0 + m) * K + kc0 + k;
            v[t] = x_al ? load4(x, at)
                        : make_float4(__ldg(x + at), __ldg(x + at + 1), __ldg(x + at + 2),
                                      __ldg(x + at + 3));
          }
        }
#pragma unroll
        for (int t = 0; t < SB; ++t) {
          const int i = base + t * THREADS;
          if (i < total) {
            const int m = i / UNITS;
            const int k = 4 * (i % UNITS);
            const int s = k / STRIPE;
            const int G = (k % STRIPE) / R;
            const int j = (k % R) >> 2;
            xs4[m * (KC / 4) + s * (STRIPE / 4) + j * 32 + (G ^ j)] = v[t];
          }
        }
      }
    } else {
      for (int m = 0; m < mt; ++m) {
        for (int k = threadIdx.x; k < kc; k += THREADS) {
          xs[m * KC + k] = __ldg(x + (long long)(m0 + m) * K + kc0 + k);
        }
      }
    }
    __syncthreads();
    if (n0 >= N) continue;

    if (vec) {  // K % R == 0 and w 16-byte aligned
      for (; g < ng && g * R < kc0 + kc; g += 32) {
        if (g + 32 < ng) fetch(nxt, g + 32);
        const float4* xg = xs4 + ((g * R - kc0) / STRIPE) * (STRIPE / 4);
#pragma unroll
        for (int q = 0; q < Fields<WB>::WORDS; ++q) {
          uint32_t wx[CPW];
#pragma unroll
          for (int c = 0; c < CPW; ++c) wx[c] = cur[c].w[q] ^ Fields<WB>::FLIP;
#pragma unroll
          for (int i = 0; i < Fields<WB>::PER_WORD; i += 4) {
            const int j = (q * Fields<WB>::PER_WORD + i) >> 2;
            float wf[CPW][4];
#pragma unroll
            for (int c = 0; c < CPW; ++c) {
#pragma unroll
              for (int e = 0; e < 4; ++e) wf[c][e] = __fmul_rn(field_f<WB>(wx[c], i + e), eps);
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if (m < mt) {
                const float4 xv = xg[m * (KC / 4) + j * 32 + (lane ^ j)];
#pragma unroll
                for (int c = 0; c < CPW; ++c) {
                  float a = acc[c][m];
                  a = __fmaf_rn(xv.x, wf[c][0], a);
                  a = __fmaf_rn(xv.y, wf[c][1], a);
                  a = __fmaf_rn(xv.z, wf[c][2], a);
                  a = __fmaf_rn(xv.w, wf[c][3], a);
                  acc[c][m] = a;
                }
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < CPW; ++c) cur[c] = nxt[c];
      }
    } else {  // any K, any alignment: one value per lane and step
      for (int k = lane; k < kc; k += 32) {
        float wf[CPW];
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          wf[c] = (n0 + c < N)
                      ? __fmul_rn(__int2float_rn(field_s<WB>(wrow[c], kc0 + k)), eps)
                      : 0.0f;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < mt) {
            const float xv = xs[m * KC + k];
#pragma unroll
            for (int c = 0; c < CPW; ++c) acc[c][m] = __fmaf_rn(xv, wf[c], acc[c][m]);
          }
        }
      }
    }
  }
  if (n0 >= N) return;

  // the 32 lane sums of each output, in a fixed butterfly
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mt) {
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
          acc[c][m] = __fadd_rn(acc[c][m], __shfl_xor_sync(0xffffffffu, acc[c][m], s));
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      // lane (m * CPW + c) % 32 stores: the stores spread over the warp
      if (m < mt && n0 + c < N && lane == ((m * CPW + c) & 31)) {
        y[(long long)(m0 + m) * N + n0 + c] = acc[c][m];
      }
    }
  }
}

template <int WB, int MT, int CPW>
int launch(const void* x, const void* w, const void* eps, void* y, int M, int N, int K,
           int vec, int x_al, cudaStream_t stream) {
  const size_t smem = (size_t)(M < MT ? M : MT) * KC * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wdqmm_kernel<WB, MT, CPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + WARPS * CPW - 1) / (WARPS * CPW), (M + MT - 1) / MT);
  wdqmm_kernel<WB, MT, CPW><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(eps), static_cast<float*>(y), M, N, K, vec, x_al);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16 activations: tensor cores

constexpr int KP = 64;  // K values a chunk: summed by MMAs into a fresh accumulator

template <int WB, class T>
struct MmaCfg {
  static constexpr int CPS = T::WK * T::CPW;  // chunks a stage
  static constexpr int SK = KP * CPS;         // K values a stage
  static constexpr int XROW = SK * 2;
  static constexpr int WROW = SK * WB / 8;
  // a lane reads 16 values of a chunk: 32 bytes of x, 2 * WB bytes of w
  static constexpr int XS = mma_pipe::stride(XROW, 32);
  static constexpr int WS = mma_pipe::stride(WROW, 2 * WB);
  static constexpr int STAGE = T::AR * XS + T::BN * WS;
  static constexpr int ELEMS = T::MT * T::NT * 4;  // accumulator values a lane holds
  // a K split's chunk partials, two stages' worth, exchanged to be folded in order
  static constexpr int PART = CPS > 1 ? 2 * T::WM * T::WN * CPS * ELEMS * 32 * 4 : 0;
  static constexpr int SMEM = T::STAGES * STAGE + PART;
  static_assert(SMEM <= mma_pipe::MAX_SMEM, "the tile does not fit in shared memory");
};

// a + c on two bf16 (low half first): a bf16 FMA by 1.0, exact for the
// small integers it meets here.
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(c));
  return d;
}

// A lane's 16 weights of a chunk (2 * WB bytes at p) -> 8 words of two bf16
// holding the signed integers exactly, paired as pair_x pairs the
// activations: w 8 (k, k + 1) pairs, w 4 (k, k + 4) within each 8, w 2
// (k, k + 8). Each field with its top bit flipped (u = v + 2^(WB-1)) goes
// under the exponent of 128 (bf16 0x4300 | u = 128 + u) for w 4 and 2, of
// 1.5 * 2^23 in f32 for w 8, and the constant is subtracted (bf16 -136 =
// 0xC308, -130 = 0xC302).
template <int WB>
__device__ __forceinline__ void unpack_w(const uint8_t* p, uint32_t (&u)[8]) {
  if constexpr (WB == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t q[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                           v.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t wq = q[i >> 1];
      const int b = 2 * (i & 1);
      const float lo = __fadd_rn(__uint_as_float(__byte_perm(wq, MAGIC, 0x7650 + b)),
                                 -Fields<8>::BIAS);
      const float hi = __fadd_rn(__uint_as_float(__byte_perm(wq, MAGIC, 0x7650 + b + 1)),
                                 -Fields<8>::BIAS);
      const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  } else if constexpr (WB == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const uint32_t q[2] = {v.x ^ 0x88888888u, v.y ^ 0x88888888u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u[4 * h + e] = bf16x2_add(((q[h] >> (4 * e)) & 0x000F000Fu) | 0x43004300u, 0xC308C308u);
      }
    }
  } else {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(p) ^ 0xAAAAAAAAu;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      u[e] = bf16x2_add(((q >> (2 * e)) & 0x00030003u) | 0x43004300u, 0xC302C302u);
    }
  }
}

// A lane's 16 activations of a chunk (32 bytes of bf16 at p) -> the 8 pairs
// unpack_w<WB> makes of the weights.
template <int WB>
__device__ __forceinline__ void pair_x(const uint8_t* p, uint32_t (&u)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
  const uint32_t n[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};  // (k, k + 1) pairs
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if constexpr (WB == 8) {
      u[q] = n[q];
    } else if constexpr (WB == 4) {
      const int k = 8 * (q >> 2) + (q & 3);  // pair (k, k + 4)
      u[q] = __byte_perm(n[k >> 1], n[(k >> 1) + 2], (k & 1) ? 0x7632 : 0x5410);
    } else {
      u[q] = __byte_perm(n[q >> 1], n[(q >> 1) + 4], (q & 1) ? 0x7632 : 0x5410);  // (q, q + 8)
    }
  }
}

template <int WB, class T>
__global__ void __launch_bounds__(T::THREADS)
wdqmm_mma_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ eps_p, float* __restrict__ y, int M, int N, int K,
                 int vec_x, int vec_w) {
  using C = MmaCfg<WB, T>;
  constexpr int MT = T::MT, NT = T::NT, WK = T::WK, CPW = T::CPW, STAGES = T::STAGES;
  constexpr int CPS = C::CPS, ELEMS = C::ELEMS;
  extern __shared__ __align__(16) uint8_t smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wk = warp % WK;
  const int wn = (warp / WK) % T::WN;
  const int wm = warp / (WK * T::WN);
  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * T::BN;
  const long long xpitch = (long long)K * 2;
  const long long wpitch = (long long)K * WB / 8;
  const int nchunks = (K + KP - 1) / KP;
  const int nst = (K + C::SK - 1) / C::SK;
  // this warp group's partials: [stage parity][chunk of the stage][value][lane]
  float* part = reinterpret_cast<float*>(smem + STAGES * C::STAGE) +
                (warp / WK) * 2 * CPS * ELEMS * 32;

  auto load = [&](int st) {
    uint8_t* s = smem + (st % STAGES) * C::STAGE;
    mma_pipe::stage_rows<T::AR, C::XROW, T::THREADS>(s, C::XS, x, xpitch, M, m0,
                                                     (long long)st * C::XROW, vec_x);
    mma_pipe::stage_rows<T::BN, C::WROW, T::THREADS>(s + T::AR * C::XS, C::WS, w, wpitch, N,
                                                     n0, (long long)st * C::WROW, vec_w);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    mma_pipe::cp_commit();
  }

  float tot[ELEMS];
#pragma unroll
  for (int f = 0; f < ELEMS; ++f) tot[f] = 0.0f;

  // the chunks of stage s, in increasing k: value f of the tile is folded by
  // warp f % WK of the split
  auto fold = [&](int s) {
    const float* p = part + (s & 1) * CPS * ELEMS * 32;
    for (int q = 0; q < CPS && s * CPS + q < nchunks; ++q) {
#pragma unroll
      for (int f = 0; f < ELEMS; ++f) {
        if (f % WK == wk) tot[f] = __fadd_rn(tot[f], p[(q * ELEMS + f) * 32 + lane]);
      }
    }
  };

  for (int st = 0; st < nst; ++st) {
    mma_pipe::cp_wait<STAGES - 2>();
    __syncthreads();  // stage st has landed, every warp is done with st - 1
    if constexpr (WK > 1 || CPW > 1) {
      if (st > 0) fold(st - 1);
    }
    if (st + STAGES - 1 < nst) load(st + STAGES - 1);
    mma_pipe::cp_commit();

    const uint8_t* stage = smem + (st % STAGES) * C::STAGE;
#pragma unroll
    for (int cc = 0; cc < CPW; ++cc) {
      // chunk st * CPS + q of K: 4 k16 steps from a zero accumulator
      const int q = wk * CPW + cc;
      const uint8_t* xs = stage + q * (KP * 2) + t * 32;
      const uint8_t* ws = stage + T::AR * C::XS + q * (KP * WB / 8) + t * (2 * WB);
      uint32_t bw[NT][8];
#pragma unroll
      for (int j = 0; j < NT; ++j) unpack_w<WB>(ws + (wn * 8 * NT + 8 * j + g) * C::WS, bw[j]);
      float c[MT][NT][4];
      const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * 16 * MT + 16 * i + g;
        uint32_t a0[8] = {}, a1[8] = {};  // rows past the staged ones are zeros
        if (T::AR == T::BM || r < T::AR) pair_x<WB>(xs + r * C::XS, a0);
        if (T::AR == T::BM || r + 8 < T::AR) pair_x<WB>(xs + (r + 8) * C::XS, a1);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t a[4] = {a0[2 * s], a1[2 * s], a0[2 * s + 1], a1[2 * s + 1]};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (s == 0) {
              mma_pipe::mma_bf16(c[i][j], a, bw[j][0], bw[j][1], zero);
            } else {
              mma_pipe::mma_bf16(c[i][j], a, bw[j][2 * s], bw[j][2 * s + 1], c[i][j]);
            }
          }
        }
      }
      if constexpr (WK == 1 && CPW == 1) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[(i * NT + j) * 4 + e] = __fadd_rn(tot[(i * NT + j) * 4 + e], c[i][j][e]);
            }
          }
        }
      } else {
        float* p = part + (st & 1) * CPS * ELEMS * 32 + q * ELEMS * 32;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) p[((i * NT + j) * 4 + e) * 32 + lane] = c[i][j][e];
          }
        }
      }
    }
  }
  mma_pipe::cp_wait<0>();
  if constexpr (WK > 1 || CPW > 1) {
    __syncthreads();
    if (nst > 0) fold(nst - 1);
  }

  // lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each tile
  const float eps = __ldg(eps_p);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = (i * NT + j) * 4 + e;
        const int row = m0 + wm * 16 * MT + 16 * i + g + 8 * (e >> 1);
        const int col = n0 + wn * 8 * NT + 8 * j + 2 * t + (e & 1);
        if (f % WK == wk && row < M && col < N) {
          y[(long long)row * N + col] = __fmul_rn(tot[f], eps);
        }
      }
    }
  }
}

template <int WB, class T>
int launch_mma(const void* x, const void* w, const void* eps, void* y, int M, int N, int K,
               int vec_x, int vec_w, cudaStream_t stream) {
  using C = MmaCfg<WB, T>;
  auto kernel = wdqmm_mma_kernel<WB, T>;
  static const cudaError_t attr = mma_pipe::allow_smem(kernel, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, C::SMEM, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(eps), static_cast<float*>(y), M, N, K, vec_x, vec_w);
  return (int)cudaGetLastError();
}

// Decode tiles (M <= 16), picked by N (as mpmm.cu's): one m16 row tile, the
// chunks of each stage split over the block's warps. Chosen from a sweep of
// NT, WK, CPW and STAGES on the card; none changes a row's bits.
//                                     MT NT WM WN WK CPW AR STAGES
using MmaNarrow4 = mma_pipe::Tile<1, 1, 1, 1, 8, 2, 4, 6>;   // M <= 4, N < 8192
template <int WB>  // M <= 16, N < 8192; three stages fit 227 KB at w 8
using MmaNarrow16 = mma_pipe::Tile<1, 2, 1, 1, 8, 2, 16, WB == 8 ? 3 : 4>;
template <int AR>
using MmaWide = mma_pipe::Tile<1, 4, 1, 1, 4, 1, AR, 6>;      // N >= 8192
using MmaPrefill = mma_pipe::Tile<2, 4, 2, 4, 1, 1, 64, 4>;   // 64 x 128 block tiles

template <int WB>
int launch_shape(const void* x, const void* w, const void* eps, void* y, int M, int N, int K,
                 int x_f32, cudaStream_t stream) {
  if (!x_f32) {
    // bf16: the tensor-core kernel at every shape and alignment (16-byte
    // copies where every row of an operand starts on a 16-byte boundary,
    // byte loads into the same shared-memory image otherwise). The tiles
    // follow M and N; the chunks, their order and the fold do not.
    const int vec_x = (long long)K * 2 % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int vec_w =
        (long long)K * WB / 8 % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
#define WDQMM_ARGS x, w, eps, y, M, N, K, vec_x, vec_w, stream
    if (M <= 4) {
      if (N < 8192) return launch_mma<WB, MmaNarrow4>(WDQMM_ARGS);
      return launch_mma<WB, MmaWide<4>>(WDQMM_ARGS);
    }
    if (M <= 16) {
      if (N < 8192) return launch_mma<WB, MmaNarrow16<WB>>(WDQMM_ARGS);
      return launch_mma<WB, MmaWide<16>>(WDQMM_ARGS);
    }
    return launch_mma<WB, MmaPrefill>(WDQMM_ARGS);
#undef WDQMM_ARGS
  }
  // f32: the CUDA-core kernel.
  // The path follows from K and the weights' address; x_al only picks how
  // the activations are staged (16-byte loads when x is 16-byte aligned).
  const int vec = K % Fields<WB>::R == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int x_al = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // The row tile and the columns per warp only size the registers, the
  // staging and the grid: a row's sum is the same bits under any of them.
  // Decode (M <= 4): one column a warp below N = 4096 and two below 16384,
  // so that narrow projections still put ~2000 warps in flight; prefill
  // (M <= 16 a tile): two or four, the activations' reads shared by more
  // columns.
  if (M <= 4) {
    if (N < 4096) return launch<WB, 4, 1>(x, w, eps, y, M, N, K, vec, x_al, stream);
    if (N < 16384) return launch<WB, 4, 2>(x, w, eps, y, M, N, K, vec, x_al, stream);
    return launch<WB, 4, 4>(x, w, eps, y, M, N, K, vec, x_al, stream);
  }
  if (N < 4096) return launch<WB, 16, 2>(x, w, eps, y, M, N, K, vec, x_al, stream);
  return launch<WB, 16, 4>(x, w, eps, y, M, N, K, vec, x_al, stream);
}

}  // namespace

// x (M, K) bf16 (x_f32 = 0) or f32 (x_f32 = 1); w (N, K * w_bits / 8) packed
// int8; eps one f32; y (M, N) f32. Any shape and alignment: bf16 takes the
// tensor-core kernel (16-byte or byte staging by the pointers and pitches),
// f32 the CUDA-core kernel (its vector path when K % R == 0, R = 16 at w 8
// and 32 at w 4 and 2, and w is 16-byte aligned, its scalar path otherwise).
// Returns cudaGetLastError() after the launch.
extern "C" int wdqmm_launch(const void* x, const void* w, const void* eps, void* y, int M, int N,
                            int K, int w_bits, int x_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_bits) {
    case 8: return launch_shape<8>(x, w, eps, y, M, N, K, x_f32, s);
    case 4: return launch_shape<4>(x, w, eps, y, M, N, K, x_f32, s);
    case 2: return launch_shape<2>(x, w, eps, y, M, N, K, x_f32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
