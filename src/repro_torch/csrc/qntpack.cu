// Standalone QntPack for Hopper (sm_90a): int32 accumulators (M, N) -> packed
// (M, N / ry) int8, ry = 8 / y_bits.
//
// Replaces the TPU kernel src/repro/kernels/qntpack.py::qntpack_pallas, the
// paper's third phase on its own. Each thread reads ry adjacent accumulators
// of one row, requantizes each (shift-and-clamp at y = 8, the 2^y - 1
// threshold ladder at y = 4, 2) and writes one little-endian packed byte. The
// requant and pack are the device code of quant.cuh, the same code as mpmm's
// and conv2d's packed epilogue, so the three kernels agree bit for bit.
//
// Bound on this card: pure streaming, 4 bytes read per accumulator and
// y_bits / 8 written; the ladder's <= 15 compares per value are far below the
// H100's integer rate. Design: one output byte per thread, consecutive threads
// on consecutive bytes (so reads of ry * 4 bytes per thread coalesce), the
// requant vector read through the L1 cache. No tiling: a row of any N works,
// given N % ry == 0 (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
qntpack_kernel(const int* __restrict__ phi, const int* __restrict__ rqv,
               int8_t* __restrict__ out, long long n_out, int y_bits) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const int ry = 8 / y_bits;
  // bytes are row-major over (M, N / ry) and N % ry == 0, so byte i packs the
  // accumulators [i * ry, i * ry + ry) of the flat (M * N) array
  const int* src = phi + i * ry;
  int q[8];
  for (int j = 0; j < ry; ++j) q[j] = requant_one(src[j], rqv, y_bits);
  out[i] = pack_byte(q, y_bits);
}

}  // namespace

// phi (M, N) int32; rqv int32 [2 + 2^y_bits - 1]; out (M, N / ry) int8, with
// n_out = M * N / ry bytes. Returns cudaGetLastError() after the launch.
extern "C" int qntpack_launch(const void* phi, const void* rqv, void* out, long long n_out,
                              int y_bits, void* stream) {
  if (y_bits != 8 && y_bits != 4 && y_bits != 2) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_out + THREADS - 1) / THREADS;
  qntpack_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(phi), static_cast<const int*>(rqv), static_cast<int8_t*>(out),
      n_out, y_bits);
  return (int)cudaGetLastError();
}
