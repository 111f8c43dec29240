// Paged KV gather for Hopper (sm_90a): page pool -> contiguous logical rows.
//
// Replaces the TPU kernel src/repro/kernels/paged_gather.py::paged_gather_pallas.
// out[b, j * ps + r] = pool[page, r] with page = bt[b, j], for every slot b,
// table entry j and row r of a page: (B, NB * ps, ...) from (P, ps, ...). The
// copy moves bytes at STORED width and is dtype-agnostic: int8 K/V, packed
// int4, bf16 and f32 scale leaves alike (a page is page_bytes bytes).
//
// Page ids follow the reference's jnp twin (``pool[block_table]``): a
// negative id counts from the end (id + P), then the id is clamped to
// [0, P - 1]. The engine never writes such an id; the clamp keeps every read
// inside the pool.
//
// Bound on this card: pure data movement, each gathered page read once and
// written once (2 * B * NB * page_bytes). Design: one block per (b, j) page,
// 16-byte copies when the page size and both pointers allow, as
// paged_scatter.cu does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
paged_gather_kernel(const uint8_t* __restrict__ pool, const int* __restrict__ bt,
                    uint8_t* __restrict__ out, int P, long long page_bytes, int vec) {
  const long long r = blockIdx.x;  // b * NB + j, row-major like bt and out
  int page = bt[r];
  if (page < 0) page += P;
  page = min(max(page, 0), P - 1);
  const uint8_t* src = pool + (long long)page * page_bytes;
  uint8_t* dst = out + r * page_bytes;
  if (vec) {
    for (long long i = threadIdx.x; i < page_bytes / 16; i += THREADS) {
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    }
  } else {
    for (long long i = threadIdx.x; i < page_bytes; i += THREADS) dst[i] = src[i];
  }
}

}  // namespace

// pool (P, page_bytes) bytes; bt (B, NB) int32; out (B, NB, page_bytes).
// vec: page_bytes % 16 == 0 and both pointers 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int paged_gather_launch(const void* pool, const void* bt, void* out, int P,
                                   long long n_pages_out, long long page_bytes, int vec,
                                   void* stream) {
  paged_gather_kernel<<<(unsigned)n_pages_out, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int*>(bt),
      static_cast<uint8_t*>(out), P, page_bytes, vec);
  return (int)cudaGetLastError();
}
