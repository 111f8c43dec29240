// Paged KV scatter for Hopper (sm_90a): write new token rows into the page
// pools of up to four cache leaves in one launch.
//
// Replaces the TPU kernel src/repro/kernels/paged_gather.py::paged_scatter_pallas.
// For each leaf, row (b, s) of src (B, S_new, F) lands at pool[page, off] with
// idx = pos[b] + s, page = bt[b, idx / ps] and off = idx % ps. Rows whose
// block index falls past the table go to the scratch page 0 (never clamped
// onto the last real page), and rows on an unallocated table entry (0) land
// there too. The leaves of a group (a layer's k, v, k_s, v_s; or its c, c_s,
// r) share pos and the block table; each has its own dtype and row width, and
// the copy is dtype-agnostic: a row is row_bytes bytes.
//
// The pools are written IN PLACE: the JAX kernel aliases the pool in and out
// (input_output_aliases), and here the caller's pool tensors are the output.
//
// Bound on this card: launch latency. A decode step writes one row a slot and
// leaf, a few KB a layer against ~2 us of launch, so the design removes
// launches: the group is one launch (a layer's four leaves were four), whose
// parameters travel as one struct. One block a new row: its threads walk the
// concatenation of every leaf's row in units (16 bytes where the leaf's row
// size and both pointers allow, else single bytes, chosen per leaf), each
// thread loading its UNROLL units into registers before it stores them, so a
// row's loads are all in flight at once; at decode (4 rows of 132 units at
// kv8) one unit a thread. The row's place (pos, then the table: two dependent
// loads) is read after the row's own loads are issued, so the trips overlap.
// THREADS and UNROLL are the fastest of scripts/sweep_page_movers.py's
// variants at internlm2's decode shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 4;
constexpr int THREADS = 256;
constexpr int UNROLL = 1;

struct ScatterLeaves {
  uint8_t* pool[MAX_LEAVES];
  const uint8_t* src[MAX_LEAVES];
  long long row_bytes[MAX_LEAVES];
  int vec[MAX_LEAVES];  // 16-byte units (1) or byte units (0)
  int unit_end[MAX_LEAVES];  // running sum of the leaves' units a row
};

// a[l] with l in [0, MAX_LEAVES): a chain of selects on constant indices, so
// the struct stays in the parameter bank (no local-memory copy)
template <class T>
__device__ __forceinline__ T pick(const T (&a)[MAX_LEAVES], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

__global__ void __launch_bounds__(THREADS)
paged_scatter_kernel(const ScatterLeaves L, const int* __restrict__ pos,
                     const int* __restrict__ bt, int S_new, int nb, int ps) {
  const long long r = blockIdx.x;  // row (b, s) of every leaf's src
  const int total = L.unit_end[MAX_LEAVES - 1];
  long long slot = -1;  // the row's place in the pools, read after the first loads
  for (int u0 = threadIdx.x; u0 < total; u0 += THREADS * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = u0 + k * THREADS;
      if (u < total) {
        const int l = (u >= L.unit_end[0]) + (u >= L.unit_end[1]) + (u >= L.unit_end[2]);
        const int j = u - (l == 0 ? 0 : pick(L.unit_end, l - 1));
        const uint8_t* from = pick(L.src, l) + r * pick(L.row_bytes, l);
        if (pick(L.vec, l)) {
          v[k] = __ldg(reinterpret_cast<const uint4*>(from) + j);
        } else {
          v[k].x = from[j];
        }
      }
    }
    if (slot < 0) {  // pos, then the table: two dependent loads, behind the row's own
      const int b = (int)(r / S_new);
      const int idx = pos[b] + (int)(r % S_new);
      const int blk = idx / ps;
      const long long page = (blk < nb) ? bt[(long long)b * nb + blk] : 0;
      slot = page * ps + idx % ps;
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = u0 + k * THREADS;
      if (u < total) {
        const int l = (u >= L.unit_end[0]) + (u >= L.unit_end[1]) + (u >= L.unit_end[2]);
        const int j = u - (l == 0 ? 0 : pick(L.unit_end, l - 1));
        uint8_t* to = pick(L.pool, l) + slot * pick(L.row_bytes, l);
        if (pick(L.vec, l)) {
          reinterpret_cast<uint4*>(to)[j] = v[k];
        } else {
          to[j] = (uint8_t)v[k].x;
        }
      }
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// n leaves (1..4): pools[i] (P, ps, row_bytes[i]) bytes, written in place;
// srcs[i] (B, S_new, row_bytes[i]); vec[i]: row_bytes[i] % 16 == 0 and both
// pointers 16-byte aligned. pos (B,) int32; bt (B, nb) int32, shared by the
// leaves. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// without launching for n outside 1..4 or a row of 2^31 units or more).
extern "C" int paged_scatter_launch(int n, void* const* pools, const void* const* srcs,
                                    const long long* row_bytes, const int* vec,
                                    const void* pos, const void* bt, int B, int S_new, int nb,
                                    int ps, void* stream) {
  if (n < 1 || n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  ScatterLeaves L = {};
  long long end = 0;
  for (int i = 0; i < MAX_LEAVES; ++i) {
    if (i < n) {
      L.pool[i] = static_cast<uint8_t*>(pools[i]);
      L.src[i] = static_cast<const uint8_t*>(srcs[i]);
      L.row_bytes[i] = row_bytes[i];
      L.vec[i] = vec[i];
      end += vec[i] ? row_bytes[i] / 16 : row_bytes[i];
      if (end >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    }
    L.unit_end[i] = (int)end;  // unused leaves end where the last one does
  }
  paged_scatter_kernel<<<B * S_new, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<const int*>(pos), static_cast<const int*>(bt), S_new, nb, ps);
  return (int)cudaGetLastError();
}

// An empty kernel: the launch floor a launch-bound row is read against.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
