// Paged KV gather for Hopper (sm_90a): the page pools of up to four cache
// leaves -> contiguous logical rows, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/paged_gather.py::paged_gather_pallas.
// For each leaf, out[b, j * ps + r] = pool[page, r] with page = bt[b, j], for
// every slot b, table entry j and row r of a page: (B, NB * ps, ...) from
// (P, ps, ...). The copy moves bytes at STORED width and is dtype-agnostic:
// int8 K/V, packed int4, bf16 and f32 scale leaves alike (a page is
// page_bytes bytes). The leaves of a group share the block table.
//
// Page ids follow the reference's jnp twin (``pool[block_table]``): a
// negative id counts from the end (id + P), then the id is clamped to
// [0, P - 1], with each leaf's own P. The engine never writes such an id; the
// clamp keeps every read inside the pool.
//
// Bound on this card: bytes, each gathered page read once and written once
// (2 * B * NB * page_bytes a leaf; ~17 MB an internlm2 kv8 layer, ~5 us at
// 3.35 TB/s). Design: one launch a group (a layer's four leaves were four);
// each leaf's output is cut into tiles of TILE units (16 bytes where the
// leaf's page size and both pointers allow, else bytes), one block a tile:
// an internlm2 kv8 layer spreads over 2112 blocks of 4 KB, all resident at
// once on 132 SMs. Each thread issues its UNROLL independent 16-byte loads
// into registers before its first store, so the layer's whole read is in
// flight from the start. Registers, not cp.async.bulk through shared memory:
// a copy does no work on the bytes, and with every load already in flight
// staging them in shared memory would add a trip and a barrier. What is left
// at a layer's size is a launch's fixed cost (~2.4 us: the launch, the first
// bytes' latency, the drain), which a contiguous copy of the same bytes pays
// too; past it the kernel moves ~3 TB/s. THREADS and UNROLL are the fastest
// of scripts/sweep_page_movers.py's variants at internlm2's decode shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 4;
constexpr int THREADS = 64;
constexpr int UNROLL = 4;
constexpr long long TILE = (long long)THREADS * UNROLL;  // units a block

struct GatherLeaves {
  const uint8_t* pool[MAX_LEAVES];
  uint8_t* out[MAX_LEAVES];
  long long page_bytes[MAX_LEAVES];
  long long page_units[MAX_LEAVES];  // page_bytes / 16 on the 16-byte path, else page_bytes
  int vec[MAX_LEAVES];
  int n_pages[MAX_LEAVES];  // P of each pool
  int tile_end[MAX_LEAVES];  // running sum of the leaves' tiles
};

// a[l] with l in [0, MAX_LEAVES): a chain of selects on constant indices, so
// the struct stays in the parameter bank (no local-memory copy)
template <class T>
__device__ __forceinline__ T pick(const T (&a)[MAX_LEAVES], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// unit u of one leaf's output: the output page it lies in and its unit
// within the page (a 32-bit division where the leaf's units fit)
__device__ __forceinline__ void split_unit(long long u, long long pu, bool narrow,
                                           long long& r, long long& j) {
  if (narrow) {
    const unsigned q = (unsigned)u / (unsigned)pu;
    r = q;
    j = (long long)((unsigned)u - q * (unsigned)pu);
  } else {
    r = u / pu;
    j = u - r * pu;
  }
}

__global__ void __launch_bounds__(THREADS)
paged_gather_kernel(const GatherLeaves L, const int* __restrict__ bt, long long n_out_pages) {
  const int t = blockIdx.x;
  const int l = (t >= L.tile_end[0]) + (t >= L.tile_end[1]) + (t >= L.tile_end[2]);
  const uint8_t* pool = pick(L.pool, l);
  uint8_t* out = pick(L.out, l);
  const long long page_bytes = pick(L.page_bytes, l);
  const long long pu = pick(L.page_units, l);
  const int P = pick(L.n_pages, l);
  const bool vec = pick(L.vec, l) != 0;
  const long long units = n_out_pages * pu;
  const bool narrow = units <= 0xffffffffLL;
  const long long u0 = (t - (l == 0 ? 0 : pick(L.tile_end, l - 1))) * TILE + threadIdx.x;
  uint4 v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long u = u0 + (long long)k * THREADS;
    if (u < units) {
      long long r, j;
      split_unit(u, pu, narrow, r, j);
      int page = __ldg(bt + r);
      if (page < 0) page += P;
      page = min(max(page, 0), P - 1);
      const uint8_t* src = pool + (long long)page * page_bytes;
      if (vec) {
        v[k] = __ldg(reinterpret_cast<const uint4*>(src) + j);
      } else {
        v[k].x = src[j];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long u = u0 + (long long)k * THREADS;
    if (u < units) {
      // out is contiguous (B * NB pages of page_bytes): unit u sits at u units
      if (vec) {
        reinterpret_cast<uint4*>(out)[u] = v[k];
      } else {
        out[u] = (uint8_t)v[k].x;
      }
    }
  }
}

}  // namespace

// n leaves (1..4): pools[i] (n_pages[i], page_bytes[i]) bytes; outs[i]
// (n_out_pages, page_bytes[i]); vec[i]: page_bytes[i] % 16 == 0 and both
// pointers 16-byte aligned. bt (n_out_pages,) int32 (the (B, NB) table,
// row-major), shared by the leaves. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue without launching for n outside 1..4, or a
// grid of 2^31 blocks or more).
extern "C" int paged_gather_launch(int n, const void* const* pools, void* const* outs,
                                   const long long* page_bytes, const int* vec,
                                   const int* n_pages, const void* bt, long long n_out_pages,
                                   void* stream) {
  if (n < 1 || n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  GatherLeaves L = {};
  long long tiles = 0;
  for (int i = 0; i < MAX_LEAVES; ++i) {
    if (i < n) {
      L.pool[i] = static_cast<const uint8_t*>(pools[i]);
      L.out[i] = static_cast<uint8_t*>(outs[i]);
      L.page_bytes[i] = page_bytes[i];
      L.page_units[i] = vec[i] ? page_bytes[i] / 16 : page_bytes[i];
      L.vec[i] = vec[i];
      L.n_pages[i] = n_pages[i];
      tiles += (n_out_pages * L.page_units[i] + TILE - 1) / TILE;
      if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    }
    L.tile_end[i] = (int)tiles;  // unused leaves end where the last one does
  }
  if (tiles == 0) return (int)cudaSuccess;
  paged_gather_kernel<<<(unsigned)tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<const int*>(bt), n_out_pages);
  return (int)cudaGetLastError();
}
