// Packed mixed-precision matmul for Hopper (sm_90a): y[m, n] = sum_k x[m, k] w[n, k].
//
// Replaces the TPU kernel src/repro/kernels/mpmm.py::mpmm_pallas (its grid's
// sequential K axis becomes a loop inside the block). Covers all 27 (x, w, y)
// bit-width cells: x_bits and w_bits are template parameters, y_bits and the
// output kind (f32 = acc * scale, int32, or packed with the fused requant) are
// runtime arguments. The kernel masks its own ragged M/N/K edges, so callers
// pass unpadded operands, and takes every shape and alignment.
//
// Experts (the MoE's mpmm_pallas under jax.vmap): E products of contiguous
// (E, M, K) x (E, N, K) operands in ONE launch, the expert the grid's third
// axis; block (x, y, e) offsets its operands and its output by expert e's
// stride and scales an f32 output by scale[e]. A 2-D call is E = 1.
//
// Arithmetic (bit-exact with kernels/ref.py::mpmm_ref):
//   * products of the integer operands accumulate in int32 on the tensor
//     cores, mma.sync m16n8k32 (s8 x s8, or u8 x s8 for unsigned 8-bit
//     ifmaps, which therefore need no offset fold); integer sums are exact
//     in any order, so tiles, splits and paths are free to follow the shape;
//   * fields are unpacked on chip from the little-endian in-byte layout of
//     core/pack.py: weights sign-extended as quant.cuh's field_s does,
//     unsigned ifmaps zero-extended, signed ifmaps (offset-binary) minus
//     2^(b-1), all as s8 bytes in the order of k;
//   * f32 output is __fmul_rn((float)acc, scale): no FMA contraction;
//   * packed output is shift-and-clamp (8-bit) or the threshold ladder (4/2-bit)
//     on the int32 accumulator, then the little-endian in-byte pack, with
//     the device code of quant.cuh that conv2d.cu and qntpack.cu share, from
//     the block's int32 tile in shared memory, one output byte a thread.
//
// Bound on this card: at decode (M = 4..16) the bytes of packed weights, read
// once (K * N * w_bits / 8); at prefill (M = 2048) the int8 operations
// (2 M N K at 1979 TOP/s). Design (the shared skeleton of mma_pipe.cuh): a
// block stages its tile of both operands, SK values of K at a time, through a
// ring of cp.async stages in shared memory, the next stages in flight while
// the current one is multiplied. A lane takes 32 consecutive k of a row (4
// k32 steps; the MMA's k slots follow k within them), reads them as one or
// two 16-byte loads and unpacks them in registers. Two regimes, picked by the
// launcher from M:
//   * M <= 16: one m16 row tile (rows past M are zeros; at M <= 4
//     only 4 activation rows are staged), a narrow column tile (16 columns
//     below N = 8192, so that even the 1 MB projections make 64 blocks; 32
//     above), and the block's 8 or 4 warps split each stage's K, their int32
//     partials added in shared memory at the end; every weight byte is read
//     once per call;
//   * M > 16: 128 x 128 block tiles, 8 warps of 64 x 32, one 128-value K group
//     a stage: each weight tile in shared memory serves 128 rows.
// No TMA and no wgmma: the ring is filled by each thread's cp.async.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_pipe.cuh"
#include "quant.cuh"

namespace {

using mma_pipe::stride;

constexpr int GROUP = 128;  // K values a warp takes from a stage (4 k32 steps)

template <int XB, int WB, class T>
struct Cfg {
  static_assert(T::CPW == 1, "a warp takes one K group a stage");
  static constexpr int SK = GROUP * T::WK;  // K values a stage
  static constexpr int XROW = SK * XB / 8;
  static constexpr int WROW = SK * WB / 8;
  static constexpr int XS = stride(XROW, 4 * XB);  // a lane reads 32 values: 4 * bits bytes
  static constexpr int WS = stride(WROW, 4 * WB);
  static constexpr int STAGE = T::AR * XS + T::BN * WS;
  static constexpr int CT = T::BN + 8;  // the output tile's row stride (ints)
  static constexpr int SMEM = T::STAGES * STAGE > T::BM * CT * 4 ? T::STAGES * STAGE
                                                                  : T::BM * CT * 4;
  static_assert(SMEM <= mma_pipe::MAX_SMEM, "the tile does not fit in shared memory");
};

__device__ __forceinline__ uint32_t rep(uint32_t b) { return b * 0x01010101u; }

// A lane's 32 values of a row: BITS 32-bit words of packed fields -> 8 words
// of 4 bytes, values 4q..4q+3 in word q, fields zero-extended.
template <int BITS>
__device__ __forceinline__ void load32(const uint8_t* p, uint32_t (&o)[8]) {
  if constexpr (BITS == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else if constexpr (BITS == 4) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w = __byte_perm(v[i], 0u, h ? 0x3322 : 0x1100);
        o[2 * i + h] = (w & 0x000F000Fu) | ((w >> 4) & 0x0F000F00u);
      }
    }
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const uint32_t v[2] = {a.x, a.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t w = __byte_perm(v[i], 0u, 0x1111 * b);
        o[4 * i + b] = (w & 0x3u) | ((w >> 2) & 0x300u) | ((w >> 4) & 0x30000u) |
                       ((w >> 6) & 0x3000000u);
      }
    }
  }
}

// Offset-binary fields (stored v + 2^(BITS-1)) -> s8 bytes of v: per byte,
// u + (128 - 2^(BITS-1)) stays below 256, and flipping bit 7 subtracts 128.
template <int BITS>
__device__ __forceinline__ uint32_t offset_s8(uint32_t u) {
  return (u + rep(0x80u - (1u << (BITS - 1)))) ^ 0x80808080u;
}

// Two's-complement fields -> s8 bytes (quant.cuh field_s): flipping a
// field's top bit makes it offset-binary.
template <int BITS>
__device__ __forceinline__ uint32_t twos_s8(uint32_t u) {
  if constexpr (BITS == 8) {
    return u;
  } else {
    return offset_s8<BITS>(u ^ rep(1u << (BITS - 1)));
  }
}

template <int XB, int WB, bool XU8, class T>
__global__ void __launch_bounds__(T::THREADS)
mpmm_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
            const int* __restrict__ rqv, const float* __restrict__ scale,
            void* __restrict__ out, int M, int N, int K, int y_bits, int x_signed,
            int out_kind, int vec_x, int vec_w) {
  using C = Cfg<XB, WB, T>;
  constexpr int MT = T::MT, NT = T::NT, WK = T::WK, STAGES = T::STAGES;
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
  const long long xpitch = (long long)K * XB / 8;
  const long long wpitch = (long long)K * WB / 8;
  const int nst = (K + C::SK - 1) / C::SK;
  // expert e's operands and output (contiguous experts; e = 0 for 2-D calls)
  const int e = blockIdx.z;
  x += (long long)e * M * xpitch;
  w += (long long)e * N * wpitch;
  out = static_cast<int8_t*>(out) +
        (long long)e * M * (out_kind == 2 ? N / (8 / y_bits) : 4LL * N);

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

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  }

  for (int st = 0; st < nst; ++st) {
    mma_pipe::cp_wait<STAGES - 2>();
    __syncthreads();  // stage st has landed, and every warp is done with st - 1
    if (st + STAGES - 1 < nst) load(st + STAGES - 1);
    mma_pipe::cp_commit();

    // this warp's K group of the stage
    const uint8_t* xs = smem + (st % STAGES) * C::STAGE + wk * (GROUP * XB / 8) + t * (4 * XB);
    const uint8_t* ws = smem + (st % STAGES) * C::STAGE + T::AR * C::XS +
                        wk * (GROUP * WB / 8) + t * (4 * WB);
    uint32_t bw[NT][8];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      load32<WB>(ws + (wn * 8 * NT + 8 * j + g) * C::WS, bw[j]);
#pragma unroll
      for (int q = 0; q < 8; ++q) bw[j][q] = twos_s8<WB>(bw[j][q]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = wm * 16 * MT + 16 * i + g;
      uint32_t a0[8] = {}, a1[8] = {};  // rows past the staged ones are zeros
      if (T::AR == T::BM || r < T::AR) load32<XB>(xs + r * C::XS, a0);
      if (T::AR == T::BM || r + 8 < T::AR) load32<XB>(xs + (r + 8) * C::XS, a1);
      if (!XU8 && (XB == 8 || x_signed)) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          a0[q] = offset_s8<XB>(a0[q]);
          a1[q] = offset_s8<XB>(a1[q]);
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t a[4] = {a0[2 * s], a1[2 * s], a0[2 * s + 1], a1[2 * s + 1]};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_pipe::mma_i8<XU8>(acc[i][j], a, bw[j][2 * s], bw[j][2 * s + 1]);
        }
      }
    }
  }
  mma_pipe::cp_wait<0>();

  // The block's int32 tile goes to shared memory (the K split's partials
  // added there; integer sums, exact in any order), then each thread
  // requantizes, packs and stores ry adjacent columns: one byte, or
  // consecutive words, across the threads.
  constexpr int CT = C::CT;
  constexpr int BM = T::BM, BN = T::BN, THREADS = T::THREADS;
  int* tile = reinterpret_cast<int*>(smem);
  __syncthreads();  // every warp is done with the ring
  if constexpr (WK > 1) {
    for (int i = threadIdx.x; i < BM * CT; i += THREADS) tile[i] = 0;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int* at = tile + (wm * 16 * MT + 16 * i + g + 8 * (e >> 1)) * CT + wn * 8 * NT + 8 * j +
                  2 * t + (e & 1);
        if constexpr (WK > 1) {
          atomicAdd(at, acc[i][j][e]);
        } else {
          *at = acc[i][j][e];
        }
      }
    }
  }
  __syncthreads();

  if (out_kind == 2) {  // N is a multiple of ry: a byte's columns are all in or all out
    const int ry = 8 / y_bits;
    const int nb = BN / ry;  // bytes a tile row
    for (int idx = threadIdx.x; idx < BM * nb; idx += THREADS) {
      const int r = idx / nb;
      const int b = idx - r * nb;
      const int row = m0 + r;
      const int col = n0 + b * ry;
      if (row >= M || col >= N) continue;
      int q[4];
      for (int j = 0; j < ry; ++j) q[j] = requant_one(tile[r * CT + b * ry + j], rqv, y_bits);
      static_cast<int8_t*>(out)[(long long)row * (N / ry) + col / ry] = pack_byte(q, y_bits);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx - r * BN;
    const int row = m0 + r;
    const int col = n0 + c;
    if (row >= M || col >= N) continue;
    const int v = tile[r * CT + c];
    if (out_kind == 0) {
      static_cast<float*>(out)[(long long)row * N + col] = __fmul_rn(__int2float_rn(v), scale[e]);
    } else {
      static_cast<int*>(out)[(long long)row * N + col] = v;
    }
  }
}

template <int XB, int WB, bool XU8, class T>
int launch(const void* x, const void* w, const void* rqv, const void* scale, void* out, int E,
           int M, int N, int K, int y_bits, int x_signed, int out_kind, int vec_x, int vec_w,
           cudaStream_t stream) {
  using C = Cfg<XB, WB, T>;
  auto kernel = mpmm_kernel<XB, WB, XU8, T>;
  static const cudaError_t attr = mma_pipe::allow_smem(kernel, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, E);
  kernel<<<grid, T::THREADS, C::SMEM, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const int*>(rqv), static_cast<const float*>(scale), out, M, N, K, y_bits,
      x_signed, out_kind, vec_x, vec_w);
  return (int)cudaGetLastError();
}

// Decode tiles (M <= 16), picked by N: one m16 row tile, the K of each
// stage split over the block's warps; 16 columns a block below N = 8192 (so
// that 1 MB projections still make 64-128 blocks), 32 above (each staged
// activation row serves more columns). AR: activation rows staged, 4 when M
// <= 4. Chosen from a sweep of NT, WK, CPW and STAGES on the card.
//                                   MT NT WM WN WK CPW AR STAGES
template <int AR>
using DecodeNarrow = mma_pipe::Tile<1, 2, 1, 1, 8, 1, AR, 6>;
template <int AR>
using DecodeWide = mma_pipe::Tile<1, 4, 1, 1, 4, 1, AR, 6>;
using Prefill = mma_pipe::Tile<4, 4, 2, 4, 1, 1, 128, 3>;  // 128 x 128 block tiles

template <int XB, int WB, bool XU8>
int launch_shape(const void* x, const void* w, const void* rqv, const void* scale, void* out,
                 int E, int M, int N, int K, int y_bits, int x_signed, int out_kind,
                 cudaStream_t stream) {
  // 16-byte copies where every row of an operand starts on a 16-byte
  // boundary (every expert's too: its offset is a multiple of the row
  // pitch); byte loads into the same shared-memory image otherwise
  const int vec_x = (long long)K * XB / 8 % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = (long long)K * WB / 8 % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
#define MPMM_ARGS \
  x, w, rqv, scale, out, E, M, N, K, y_bits, x_signed, out_kind, vec_x, vec_w, stream
  if (M <= 4) {
    if (N < 8192) return launch<XB, WB, XU8, DecodeNarrow<4>>(MPMM_ARGS);
    return launch<XB, WB, XU8, DecodeWide<4>>(MPMM_ARGS);
  }
  if (M <= 16) {
    if (N < 8192) return launch<XB, WB, XU8, DecodeNarrow<16>>(MPMM_ARGS);
    return launch<XB, WB, XU8, DecodeWide<16>>(MPMM_ARGS);
  }
  return launch<XB, WB, XU8, Prefill>(MPMM_ARGS);
#undef MPMM_ARGS
}

// Unsigned 8-bit ifmaps go to the tensor cores as u8; every other ifmap as s8.
template <int XB, int WB>
int launch_cell(const void* x, const void* w, const void* rqv, const void* scale, void* out,
                int E, int M, int N, int K, int y_bits, int x_signed, int out_kind,
                cudaStream_t stream) {
  if constexpr (XB == 8) {
    if (!x_signed) {
      return launch_shape<XB, WB, true>(x, w, rqv, scale, out, E, M, N, K, y_bits, x_signed,
                                        out_kind, stream);
    }
  }
  return launch_shape<XB, WB, false>(x, w, rqv, scale, out, E, M, N, K, y_bits, x_signed,
                                     out_kind, stream);
}

}  // namespace

// x (E, M, K*x_bits/8) and w (E, N, K*w_bits/8) packed int8, contiguous (E = 1:
// one 2-D product); rqv int32 [shift, bias, thresholds...] (read only for
// out_kind 2); scale f32[E] (read only for out_kind 0). out: f32 (E, M, N) |
// int32 (E, M, N) | int8 (E, M, N*y_bits/8). Any M, N, K and alignment, E <=
// 65535. Returns cudaGetLastError() after the launch.
extern "C" int mpmm_launch(const void* x, const void* w, const void* rqv, const void* scale,
                           void* out, int E, int M, int N, int K, int x_bits, int w_bits,
                           int y_bits, int x_signed, int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MPMM_CASE(XB, WB)                                                                  \
  case XB * 16 + WB:                                                                       \
    return launch_cell<XB, WB>(x, w, rqv, scale, out, E, M, N, K, y_bits, x_signed, out_kind, \
                               s);
  switch (x_bits * 16 + w_bits) {
    MPMM_CASE(8, 8) MPMM_CASE(8, 4) MPMM_CASE(8, 2)
    MPMM_CASE(4, 8) MPMM_CASE(4, 4) MPMM_CASE(4, 2)
    MPMM_CASE(2, 8) MPMM_CASE(2, 4) MPMM_CASE(2, 2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MPMM_CASE
}
