// Paged KV scatter for Hopper (sm_90a): write new token rows into the page pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_gather.py::paged_scatter_pallas.
// Row (b, s) of src (B, S_new, F) lands at pool[page, off] with
// idx = pos[b] + s, page = bt[b, idx / ps] and off = idx % ps. Rows whose block
// index falls past the table go to the scratch page 0 (never clamped onto the
// last real page), and rows on an unallocated table entry (0) land there too.
// The copy is dtype-agnostic: a row is row_bytes bytes (int8 KV, f32 scales,
// bf16 all alike).
//
// The pool is written IN PLACE: the JAX kernel aliases the pool in and out
// (input_output_aliases), and here the caller's pool tensor is the output.
//
// Bound on this card: pure data movement, one read and one write of each new
// row; at decode a call moves a few KB and is bound by launch latency. Design:
// one block per row, 16-byte copies when the row size and both pointers allow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
paged_scatter_kernel(uint8_t* __restrict__ pool, const uint8_t* __restrict__ src,
                     const int* __restrict__ pos, const int* __restrict__ bt, int S_new,
                     int nb, int ps, long long row_bytes, int vec) {
  const long long r = blockIdx.x;
  const int b = (int)(r / S_new);
  const int s = (int)(r % S_new);
  const int idx = pos[b] + s;
  const int blk = idx / ps;
  const long long page = (blk < nb) ? bt[(long long)b * nb + blk] : 0;
  const int off = idx % ps;
  uint8_t* dst = pool + (page * ps + off) * row_bytes;
  const uint8_t* from = src + r * row_bytes;
  if (vec) {
    for (long long i = threadIdx.x; i < row_bytes / 16; i += THREADS) {
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(from)[i];
    }
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += THREADS) dst[i] = from[i];
  }
}

}  // namespace

// pool (P, ps, row_bytes) bytes, written in place; src (B, S_new, row_bytes);
// pos (B,) int32; bt (B, nb) int32. vec: row_bytes % 16 == 0 and both
// pointers 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int paged_scatter_launch(void* pool, const void* src, const void* pos,
                                    const void* bt, int B, int S_new, int nb, int ps,
                                    long long row_bytes, int vec, void* stream) {
  paged_scatter_kernel<<<B * S_new, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(pool), static_cast<const uint8_t*>(src),
      static_cast<const int*>(pos), static_cast<const int*>(bt), S_new, nb, ps, row_bytes,
      vec);
  return (int)cudaGetLastError();
}
