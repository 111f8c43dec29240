// Whole-page copy inside a KV page pool, for Hopper (sm_90a): the prefix
// cache's copy-on-write clone.
//
// Replaces the TPU kernel src/repro/kernels/paged_gather.py::paged_copy_pallas.
// dst page d[k] takes the bits of src page s[k], k < K, over a pool of P
// pages of page_bytes bytes each: dtype-agnostic (int8 K/V, packed int4,
// bf16 and f32 scale leaves alike). Page ids follow the reference's jnp twin
// (``pool.at[dst].set(pool[src])``): a negative id counts from the end (id +
// P); a source id is then clamped to [0, P - 1], a destination id outside
// [0, P) is dropped.
//
// The contract is a SNAPSHOT: a dst page that reappears as a later src reads
// the ORIGINAL bits. Blocks of one grid run in no order, so one launch is
// correct only when no page is both a source and a destination. The kernel
// is therefore one generic mover: each side is either the pool indexed by a
// page-id list or a dense (K, page_bytes) buffer indexed by k (id list
// NULL). The wrapper launches it once (pool -> pool) when it can show src
// and dst disjoint on the host, and otherwise twice through a staging buffer
// (pool[src] -> buf, then buf -> pool[dst]).
//
// Bound on this card: pure data movement, each copied page read once and
// written once (2 * K * page_bytes); a COW clone moves one page per cache
// leaf (16 KB for an internlm2 kv8 K page) and is bound by launch latency.
// Design: one block per (page, CHUNK bytes of it), 16-byte copies when the
// page size and every pointer allow, a byte loop otherwise, as
// paged_gather.cu does. Page offsets are computed in 64 bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 16LL * THREADS;  // bytes per block: one uint4 per thread

__global__ void __launch_bounds__(THREADS)
paged_copy_kernel(const uint8_t* __restrict__ from, const int* __restrict__ sidx,
                  uint8_t* __restrict__ to, const int* __restrict__ didx, int P,
                  long long page_bytes, int vec) {
  const int k = blockIdx.y;
  long long s = k;
  if (sidx != nullptr) {
    int p = sidx[k];
    if (p < 0) p += P;
    s = min(max(p, 0), P - 1);
  }
  long long d = k;
  if (didx != nullptr) {
    int p = didx[k];
    if (p < 0) p += P;
    if (p < 0 || p >= P) return;  // the twin's scatter drops it
    d = p;
  }
  const long long lo = (long long)blockIdx.x * CHUNK;
  const long long hi = min(lo + CHUNK, page_bytes);
  const uint8_t* src = from + s * page_bytes;
  uint8_t* dst = to + d * page_bytes;
  if (vec) {
    for (long long i = lo / 16 + threadIdx.x; i < hi / 16; i += THREADS) {
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) dst[i] = src[i];
  }
}

}  // namespace

// from: P pages (sidx != NULL) or K pages (sidx == NULL) of page_bytes each;
// to: likewise with didx. sidx / didx: (K,) int32 device page ids or NULL.
// vec: page_bytes % 16 == 0 and both pointers 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int paged_copy_launch(const void* from, const void* sidx, void* to, const void* didx,
                                 int P, int K, long long page_bytes, int vec, void* stream) {
  const long long chunks = (page_bytes + CHUNK - 1) / CHUNK;
  if (K <= 0 || chunks <= 0) return 0;
  if (K > 65535 || chunks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks, (unsigned)K);
  paged_copy_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(from), static_cast<const int*>(sidx),
      static_cast<uint8_t*>(to), static_cast<const int*>(didx), P, page_bytes, vec);
  return (int)cudaGetLastError();
}
