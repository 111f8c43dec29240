// Standalone QntPack for Hopper (sm_90a): int32 accumulators (M, N) -> packed
// (M, N / ry) int8, ry = 8 / y_bits.
//
// Replaces the TPU kernel src/repro/kernels/qntpack.py::qntpack_pallas, the
// paper's third phase on its own. Each accumulator is requantized
// (shift-and-clamp at y = 8, the 2^y - 1 threshold ladder at y = 4, 2) and ry
// adjacent codes are packed little-endian into one byte. The requant and
// pack are quant.cuh's requant_one and pack_byte, the same code as mpmm's and
// conv2d's packed epilogue, so the three kernels agree bit for bit; the
// ladder stays a ladder (it counts the thresholds an accumulator reaches,
// whatever their order).
//
// Bound on this card: bytes, 4 read per accumulator and y_bits / 8 written:
// at the 224 x 224 Reference Layer's accumulators (50176, 64), y = 4,
// 12,845,056 + 1,605,632 B, 4.31 us at 3.35 TB/s. The ladder's 15 compares a
// value at y = 4 come near that time on the integer units. At Tab. 1's
// (256, 64) a call is a launch's fixed cost.
//
// Design:
//   * y_bits is a template parameter, so the ladder unrolls with constant
//     indices;
//   * the requant vector (shift, bias and up to 15 thresholds) travels by
//     value in the kernel's parameters and is read from the constant bank
//     into registers: no global load, and no host-to-device copy a call;
//   * each thread makes WORDS 32-bit words of packed output, each from 4 *
//     ry accumulators: ry 16-byte loads a word (4 accumulators at y = 8, 8
//     at y = 4, 16 at y = 2), all issued before the first requant, and one
//     32-bit store a word. Consecutive threads take consecutive words, so
//     loads and stores coalesce. THREADS and WORDS are the fastest of
//     scripts/sweep_qntpack.py's variants;
//   * the byte path (scalar loads, one store a packed byte, the same
//     arithmetic) takes a ragged tail of n_out % 4 bytes, or every word when
//     phi is off the 16-byte grid or out off the 4-byte grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WORDS = 1;  // output words a thread
constexpr int RQ_LEN = 2 + 15;  // shift, bias and the most thresholds (y = 4)

struct Requant {
  int v[RQ_LEN];  // [shift, bias, thresholds...]: requant_one's vector
};

// the byte path: output bytes [b0, b0 + nb) from scalar loads
template <int Y>
__device__ __forceinline__ void pack_bytes(const int* __restrict__ phi, int8_t* __restrict__ out,
                                           long long b0, int nb, const int* rq) {
  constexpr int RY = 8 / Y;
  for (int b = 0; b < nb; ++b) {
    int q[RY];
#pragma unroll
    for (int j = 0; j < RY; ++j) q[j] = requant_one(phi[(b0 + b) * RY + j], rq, Y);
    out[b0 + b] = pack_byte(q, Y);
  }
}

template <int Y>
__global__ void __launch_bounds__(THREADS)
qntpack_kernel(const int* __restrict__ phi, const Requant rqp, int8_t* __restrict__ out,
               long long n_out, int vec) {
  constexpr int RY = 8 / Y;
  int rq[RQ_LEN];
#pragma unroll
  for (int i = 0; i < RQ_LEN; ++i) rq[i] = rqp.v[i];
  // bytes are row-major over (M, N / ry) and N % ry == 0, so byte i packs the
  // accumulators [i * ry, i * ry + ry) of the flat (M * N) array; word w is
  // bytes [4w, 4w + 4), and a block's words are strided by THREADS
  const long long w0 = (long long)blockIdx.x * THREADS * WORDS + threadIdx.x;
  if (!vec) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const long long b0 = (w0 + (long long)k * THREADS) * 4;
      if (b0 < n_out) pack_bytes<Y>(phi, out, b0, (int)min(4LL, n_out - b0), rq);
    }
    return;
  }
  int4 v[WORDS][RY];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {  // every load in flight before the first requant
    const long long b0 = (w0 + (long long)k * THREADS) * 4;
    if (b0 + 4 <= n_out) {
      const int4* src = reinterpret_cast<const int4*>(phi + b0 * RY);
#pragma unroll
      for (int j = 0; j < RY; ++j) v[k][j] = __ldg(src + j);
    }
  }
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const long long b0 = (w0 + (long long)k * THREADS) * 4;
    if (b0 + 4 <= n_out) {
      int a[4 * RY];
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        a[4 * j] = v[k][j].x;
        a[4 * j + 1] = v[k][j].y;
        a[4 * j + 2] = v[k][j].z;
        a[4 * j + 3] = v[k][j].w;
      }
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int q[RY];
#pragma unroll
        for (int j = 0; j < RY; ++j) q[j] = requant_one(a[b * RY + j], rq, Y);
        word |= (uint32_t)(uint8_t)pack_byte(q, Y) << (8 * b);
      }
      *reinterpret_cast<uint32_t*>(out + b0) = word;
    } else if (b0 < n_out) {  // the ragged tail
      pack_bytes<Y>(phi, out, b0, (int)(n_out - b0), rq);
    }
  }
}

template <int Y>
int launch(const void* phi, const Requant& rq, void* out, long long n_out, int vec,
           cudaStream_t stream) {
  const long long per_block = (long long)THREADS * WORDS;
  const long long blocks = ((n_out + 3) / 4 + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  qntpack_kernel<Y><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const int*>(phi), rq, static_cast<int8_t*>(out), n_out, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// phi (M, N) int32 on the card; rqv: n_rqv host ints [shift, bias,
// thresholds...] (2 read at y = 8, 2 + 2^y - 1 at y = 4, 2); out (M, N / ry)
// int8 on the card, n_out = M * N / ry bytes. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue without launching for another
// y_bits or a short vector).
extern "C" int qntpack_launch(const void* phi, const int* rqv, int n_rqv, void* out,
                              long long n_out, int y_bits, void* stream) {
  if (y_bits != 8 && y_bits != 4 && y_bits != 2) return (int)cudaErrorInvalidValue;
  const int nv = y_bits == 8 ? 2 : 2 + (1 << y_bits) - 1;
  if (rqv == nullptr || n_rqv < nv) return (int)cudaErrorInvalidValue;
  Requant rq = {};
  for (int i = 0; i < nv; ++i) rq.v[i] = rqv[i];
  if (n_out <= 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(phi) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (y_bits) {
    case 8: return launch<8>(phi, rq, out, n_out, vec, s);
    case 4: return launch<4>(phi, rq, out, n_out, vec, s);
    default: return launch<2>(phi, rq, out, n_out, vec, s);
  }
}
