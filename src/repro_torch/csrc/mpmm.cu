// Packed mixed-precision matmul for Hopper (sm_90a): y[m, n] = sum_k x[m, k] w[n, k].
//
// Replaces the TPU kernel src/repro/kernels/mpmm.py::mpmm_pallas (its grid's
// sequential K axis becomes a loop inside the block). Covers all 27 (x, w, y)
// bit-width cells: x_bits and w_bits are template parameters, y_bits and the
// output kind (f32 = acc * scale, int32, or packed with the fused requant) are
// runtime arguments. The kernel masks its own ragged M/N/K edges, so callers
// pass unpadded operands.
//
// Arithmetic (bit-exact with kernels/ref.py::mpmm_ref):
//   * operands are unpacked to s8 (little-endian in-byte fields, weights
//     sign-extended), 8-bit unsigned ifmaps are offset-folded (x - 128, then
//     +128 * sum_k w[n, k]) and signed ifmaps are stored offset-binary, so the
//     stored field minus 2^(b-1) is already the value;
//   * products accumulate in int32 with __dp4a (4-way s8 dot, the counterpart
//     of PULP-NN's sumdotp). Integer sums are exact in any order;
//   * f32 output is __fmul_rn((float)acc, scale): no FMA contraction;
//   * packed output is shift-and-clamp (8-bit) or the threshold ladder (4/2-bit)
//     on the int32 accumulator, then the little-endian in-byte pack, with
//     the device code of quant.cuh that conv2d.cu and qntpack.cu share.
//
// Bound on this card: at decode (M = 4..16) the kernel is bound by the bytes
// of packed weights it reads once (K * N * w_bits / 8); the int8 work is tiny
// against the H100's int8 rate. Design for that: every weight byte is read
// once, as 16 values per lane per step (16/8/4 bytes), while the small
// activation tile is unpacked once per block into shared memory and reused by
// all columns of the block. Each warp owns 4 adjacent output columns (so a
// packed output byte is formed inside one warp) and a 16-row M tile. This is
// the simple first version: no tensor cores (mma/wgmma), no TMA, no split-K.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int WARPS = 4;                 // warps per block
constexpr int CPW = 4;                   // output columns per warp
constexpr int MT = 16;                   // M rows per block
constexpr int KC = 2048;                 // K values staged per shared-memory chunk
constexpr int THREADS = WARPS * 32;
constexpr int COLS = WARPS * CPW;        // output columns per block

// Four BITS-wide fields in the low bits of f -> four sign-extended s8 bytes.
template <int BITS>
__device__ __forceinline__ uint32_t expand4(uint32_t f) {
  if constexpr (BITS == 8) {
    return f;
  } else {
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int v = (int)((f >> (i * BITS)) & ((1u << BITS) - 1u));
      v = (v ^ (1 << (BITS - 1))) - (1 << (BITS - 1));
      r |= ((uint32_t)v & 0xFFu) << (8 * i);
    }
    return r;
  }
}

// 16 consecutive packed signed values at p (aligned to 2 * BITS bytes) ->
// four words of four s8 each, value order preserved.
template <int BITS>
__device__ __forceinline__ void load16(const int8_t* p, uint32_t w[4]) {
  if constexpr (BITS == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (BITS == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = expand4<4>(v.x & 0xFFFFu);
    w[1] = expand4<4>(v.x >> 16);
    w[2] = expand4<4>(v.y & 0xFFFFu);
    w[3] = expand4<4>(v.y >> 16);
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = expand4<2>((v >> (8 * j)) & 0xFFu);
  }
}

template <int XB, int WB>
__global__ void __launch_bounds__(THREADS)
mpmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const int* __restrict__ rqv, const float* __restrict__ scale,
            void* __restrict__ out, int M, int N, int K, int y_bits,
            int x_signed, int out_kind, int vec) {
  __shared__ __align__(16) int8_t xs[MT * KC];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * COLS + warp * CPW;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const long long Kx = K / (8 / XB);  // packed bytes per x row
  const long long Kw = K / (8 / WB);  // packed bytes per w row
  const int off = (x_signed || XB == 8) ? (1 << (XB - 1)) : 0;
  const bool comp = (XB == 8) && !x_signed;  // u8 offset fold

  int acc[CPW][MT];
  int wsum[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    wsum[c] = 0;
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0;
  }

  for (int kc0 = 0; kc0 < K; kc0 += KC) {
    const int kc = min(KC, K - kc0);
    const int kcp = (kc + 15) & ~15;  // staged width, zero-padded to 16
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < mt * kcp; i += THREADS) {
      const int m = i / kcp;
      const int k = i - m * kcp;
      int v = 0;
      if (k < kc) v = field_u<XB>(x + (long long)(m0 + m) * Kx, kc0 + k) - off;
      xs[m * KC + k] = (int8_t)v;
    }
    __syncthreads();

    if (vec) {  // K % 16 == 0 and w 16-byte aligned: 16 values per lane step
      for (int g = lane; g < kc / 16; g += 32) {
        const int k = g * 16;
        uint32_t wv[CPW][4];
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          if (n0 + c < N) {
            load16<WB>(w + (long long)(n0 + c) * Kw + (long long)(kc0 + k) * WB / 8, wv[c]);
          } else {
            wv[c][0] = wv[c][1] = wv[c][2] = wv[c][3] = 0u;
          }
          if (comp) {
#pragma unroll
            for (int j = 0; j < 4; ++j) wsum[c] = __dp4a((int)wv[c][j], 0x01010101, wsum[c]);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < mt) {
            const uint4 xv = *reinterpret_cast<const uint4*>(&xs[m * KC + k]);
#pragma unroll
            for (int c = 0; c < CPW; ++c) {
              int a = acc[c][m];
              a = __dp4a((int)xv.x, (int)wv[c][0], a);
              a = __dp4a((int)xv.y, (int)wv[c][1], a);
              a = __dp4a((int)xv.z, (int)wv[c][2], a);
              a = __dp4a((int)xv.w, (int)wv[c][3], a);
              acc[c][m] = a;
            }
          }
        }
      }
    } else {  // any K: one value per lane step
      for (int k = lane; k < kc; k += 32) {
        int wv[CPW];
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          wv[c] = (n0 + c < N) ? field_s<WB>(w + (long long)(n0 + c) * Kw, kc0 + k) : 0;
          if (comp) wsum[c] += wv[c];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < mt) {
            const int xv = (int)xs[m * KC + k];
#pragma unroll
            for (int c = 0; c < CPW; ++c) acc[c][m] += xv * wv[c];
          }
        }
      }
    }
  }

  // warp-wide sums (every lane ends with the totals)
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) wsum[c] += __shfl_xor_sync(0xffffffffu, wsum[c], s);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mt) {
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) acc[c][m] += __shfl_xor_sync(0xffffffffu, acc[c][m], s);
      }
    }
  }
  if (lane != 0 || n0 >= N) return;

  const int ry = 8 / y_bits;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= mt) continue;
    const long long row = m0 + m;
    int y[CPW];
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      int a = acc[c][m];
      if (comp) a = add_wrap(a, 128 * wsum[c]);
      y[c] = a;
      if (n0 + c >= N) continue;
      if (out_kind == 0) {
        static_cast<float*>(out)[row * N + n0 + c] = __fmul_rn(__int2float_rn(a), scale[0]);
      } else if (out_kind == 1) {
        static_cast<int*>(out)[row * N + n0 + c] = a;
      }
    }
    if (out_kind != 2) continue;
#pragma unroll
    for (int c = 0; c < CPW; ++c) y[c] = requant_one(y[c], rqv, y_bits);
    for (int b = 0; b < CPW / ry; ++b) {
      const int nb = n0 + b * ry;
      if (nb >= N) break;
      static_cast<int8_t*>(out)[row * (N / ry) + nb / ry] = pack_byte(&y[b * ry], y_bits);
    }
  }
}

template <int XB, int WB>
void launch(const void* x, const void* w, const void* rqv, const void* scale, void* out,
            int M, int N, int K, int y_bits, int x_signed, int out_kind, int vec,
            cudaStream_t stream) {
  const dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
  mpmm_kernel<XB, WB><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(rqv), static_cast<const float*>(scale), out, M, N, K,
      y_bits, x_signed, out_kind, vec);
}

}  // namespace

// x (M, K*x_bits/8) and w (N, K*w_bits/8) packed int8; rqv int32
// [shift, bias, thresholds...] (read only for out_kind 2); scale f32[1] (read
// only for out_kind 0). out: f32 (M, N) | int32 (M, N) | int8 (M, N*y_bits/8).
// Returns cudaGetLastError() after the launch.
extern "C" int mpmm_launch(const void* x, const void* w, const void* rqv, const void* scale,
                           void* out, int M, int N, int K, int x_bits, int w_bits,
                           int y_bits, int x_signed, int out_kind, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MPMM_CASE(XB, WB)                                                              \
  case XB * 16 + WB:                                                                   \
    launch<XB, WB>(x, w, rqv, scale, out, M, N, K, y_bits, x_signed, out_kind, vec, s); \
    break;
  switch (x_bits * 16 + w_bits) {
    MPMM_CASE(8, 8) MPMM_CASE(8, 4) MPMM_CASE(8, 2)
    MPMM_CASE(4, 8) MPMM_CASE(4, 4) MPMM_CASE(4, 2)
    MPMM_CASE(2, 8) MPMM_CASE(2, 4) MPMM_CASE(2, 2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MPMM_CASE
  return (int)cudaGetLastError();
}
