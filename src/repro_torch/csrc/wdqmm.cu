// Weight-only dequant matmul for Hopper (sm_90a):
//   y[m, n] = sum_k x[m, k] * (eps_w * w[n, k])        (M, N) f32
// x (M, K) bf16 or f32, w (N, K * w_bits / 8) packed signed (w_bits 8, 4, 2),
// eps_w one f32 on the device.
//
// Replaces the TPU kernel src/repro/kernels/wdqmm.py::wdqmm_pallas (its grid's
// sequential K axis becomes a loop inside the block). The Pallas kernel rounds
// w * eps_w and x through bf16 before a bf16 dot; this kernel computes the f32
// twin instead (wdqmm.py::wdqmm_ref, kernels/ref.py::wdqmm_ref here), which
// is what the reference runs wherever its tests look (impl="auto" resolves to
// it off the TPU):
//   * each weight is dequantized as __fmul_rn((float)w_int, eps_w), exactly
//     the twin's f32 array w, and the products accumulate in f32 with FMAs;
//     nothing is scaled after the sum. Only the order of the sum differs from
//     the plain version, so |kernel - plain| <= c * sum_k |x[m, k] w[n, k]|
//     (c = 2^-20, kernels/wdqmm.py TOL);
//   * the order is fixed: lane l of a warp sums, in increasing k, the values
//     of its own K groups (group g of R values when g % 32 == l on the vector
//     path, value k when k % 32 == l on the scalar path), then the 32 lane
//     sums meet in a butterfly of shuffles. No atomics, no split over warps
//     or blocks, and nothing depends on M, on the row tile, on the columns
//     per warp or on the staging, so a row gives the same bits in a decode
//     step (M = 4) and in a prefill chunk (M = 16), call after call.
//
// Bound on this card: at decode (M = 4..16) the kernel is bound by the bytes
// of packed weights, read once (N * K * w_bits / 8); the f32 work (2 M N K)
// is below them at the H100's 67 TFLOP/s. Design for that: every weight byte
// is read once, one load of R values per lane and column per step (16 bytes
// at w 8 and 4, 8 at w 2), the next step's loads in flight during the current
// step's arithmetic and the first ones issued before the activations are
// staged. The fields are unpacked in registers without an int-to-float
// conversion: the field with its top bit flipped is OR-ed under the exponent
// of 1.5 * 2^23 and the constant subtracted, an exact f32 of the signed value
// (the sign extension of quant.cuh's field_s, little-endian in-byte fields,
// as core/pack.py lays them out), then multiplied by eps_w once for all rows.
// The M <= 16 activation rows are staged in shared memory as f32, KC values
// at a time (a whole 16 x 8192 f32 tile would not fit), in a layout that puts
// lane l's four values of step j next to lane l + 1's, XOR-swizzled, so that
// neither the staging stores nor the readers' 16-byte loads meet bank
// conflicts; a thread issues SB staging loads before it stores any. Each
// warp owns CPW adjacent output columns and all rows of its tile; a block's
// 8 warps share one staged tile. The launcher picks CPW from the shape: 1 or
// 2 for the narrow projections, so that ~2000 warps are in flight, 4 for the
// wide ones, where each activation read from shared memory serves more
// columns. The vector path needs K % R == 0 and 16-byte aligned w; any other
// shape takes the scalar path (one value per lane and step, the same
// arithmetic). The path follows from K and the weights' address alone: the
// activations' alignment only picks how they are staged, so a row sums in
// the same order whatever buffer it arrives in. No tensor cores: the twin's
// f32 products are not a bf16 or TF32 product.

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

// Four consecutive activations from element offset i (16-byte aligned).
__device__ __forceinline__ float4 load4(const void* x, long long i, int x_f32) {
  if (x_f32) return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(x) + i));
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(x) + i));
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xFFFF0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xFFFF0000u));
}

__device__ __forceinline__ float load1(const void* x, long long i, int x_f32) {
  return x_f32 ? __ldg(static_cast<const float*>(x) + i)
               : bf16_to_f32(__ldg(static_cast<const uint16_t*>(x) + i));
}

template <int WB, int MT, int CPW>
__global__ void __launch_bounds__(THREADS)
wdqmm_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ eps_p, float* __restrict__ y, int M, int N, int K,
             int x_f32, int vec, int x_al) {
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
            v[t] = x_al ? load4(x, at, x_f32)
                        : make_float4(load1(x, at, x_f32), load1(x, at + 1, x_f32),
                                      load1(x, at + 2, x_f32), load1(x, at + 3, x_f32));
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
          xs[m * KC + k] = load1(x, (long long)(m0 + m) * K + kc0 + k, x_f32);
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
           int x_f32, int vec, int x_al, cudaStream_t stream) {
  const size_t smem = (size_t)(M < MT ? M : MT) * KC * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wdqmm_kernel<WB, MT, CPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + WARPS * CPW - 1) / (WARPS * CPW), (M + MT - 1) / MT);
  wdqmm_kernel<WB, MT, CPW><<<grid, THREADS, smem, stream>>>(
      x, static_cast<const int8_t*>(w), static_cast<const float*>(eps), static_cast<float*>(y),
      M, N, K, x_f32, vec, x_al);
  return (int)cudaGetLastError();
}

template <int WB>
int launch_shape(const void* x, const void* w, const void* eps, void* y, int M, int N, int K,
                 int x_f32, cudaStream_t stream) {
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
    if (N < 4096) return launch<WB, 4, 1>(x, w, eps, y, M, N, K, x_f32, vec, x_al, stream);
    if (N < 16384) return launch<WB, 4, 2>(x, w, eps, y, M, N, K, x_f32, vec, x_al, stream);
    return launch<WB, 4, 4>(x, w, eps, y, M, N, K, x_f32, vec, x_al, stream);
  }
  if (N < 4096) return launch<WB, 16, 2>(x, w, eps, y, M, N, K, x_f32, vec, x_al, stream);
  return launch<WB, 16, 4>(x, w, eps, y, M, N, K, x_f32, vec, x_al, stream);
}

}  // namespace

// x (M, K) bf16 (x_f32 = 0) or f32 (x_f32 = 1); w (N, K * w_bits / 8) packed
// int8; eps one f32; y (M, N) f32. Any K and any alignment: the launcher
// takes the vector path when K % R == 0 (R = 16 at w 8, 32 at w 4 and 2) and
// w is 16-byte aligned, the scalar path otherwise. Returns
// cudaGetLastError() after the launch.
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
