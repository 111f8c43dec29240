// Whole-page copy over a set of KV page pools, for Hopper (sm_90a): the
// prefix cache's copy-on-write clone, every cache leaf of every layer in one
// launch.
//
// Replaces the TPU kernel src/repro/kernels/paged_gather.py::paged_copy_pallas
// (and the reference's tree map of it over every cache leaf,
// src/repro/serve/prefix.py::_tree_copy). On each leaf of the set, dst page
// d[k] takes the bits of src page s[k], k < K, in a pool of P pages of
// page_bytes bytes each: dtype-agnostic (int8 K/V, packed int4, bf16 and f32
// scale leaves alike), each leaf with its own P, page size and pointer. Page
// ids follow the reference's jnp twin (``pool.at[dst].set(pool[src])``): a
// negative id counts from the end (id + P); a source id is then clamped to
// [0, P - 1], a destination id outside [0, P) is dropped.
//
// The contract is a SNAPSHOT: a dst page that reappears as a later src reads
// the ORIGINAL bits. Blocks of one grid run in no order, so one launch is
// correct only when no page is both a source and a destination. The kernel
// is therefore one mover in three modes: pool -> pool, pool[src] -> a
// staging buffer of K rows (every leaf's page side by side in a row), and
// that buffer -> pool[dst]. The wrapper launches it once (pool -> pool) when
// it can show src and dst disjoint on the host, and otherwise twice through
// one staging buffer for the whole set: an overlap, or ids on the card.
//
// Bound on this card: pure data movement, each copied page read once and
// written once: 2 * K * (the set's page bytes). An internlm2 kv8 clone (24
// layers of k, v at 16 KB a page and k_s, v_s at 512 B) moves 2 * 811,008 B,
// 0.48 us at 3.35 TB/s; it is latency-bound (that is less than the bytes the
// card needs in flight to reach its rate), and was launch-bound with one
// launch a leaf (96 a clone).
//
// Design:
//   * one launch a clone: a flat grid over (leaf, CHUNK bytes of its page)
//     pairs by K ids (24 x (4 + 4 + 1 + 1) = 240 blocks at internlm2 kv8);
//   * the leaf table (pointer, page bytes, staging offset, chunk range, P,
//     16-byte flag; 40 B a leaf) lives on the card: 96 leaves would come
//     near the 4 KB parameter limit, DeepSeek-V3 at full depth past it. The
//     wrapper builds it once per leaf set and caches it, so a clone after
//     the first uploads nothing. A block finds its leaf from the table's
//     chunk ranges (the prefix sums of the leaves' chunk counts): every
//     thread tests a leaf, one load round trip, and the match goes through
//     shared memory;
//   * up to MAX_IDS page ids travel by value in the parameters (a clone has
//     K = 1), read from the constant bank; more ids, or ids on the card, are
//     read from device memory;
//   * each thread issues its loads (one 16-byte load where the leaf's page
//     size and pointer allow, else 16 single bytes) before it stores any;
//   * page offsets are computed in 64 bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16 * THREADS;  // bytes a block: one 16-byte unit a thread
constexpr int MAX_IDS = 16;

// one leaf of the set: the layout kernels/paged_gather.py::copy_table writes
struct LeafRec {
  long long pool;  // device address of page 0
  long long page_bytes;
  long long buf_off;  // the leaf's offset in a staging row
  int chunk_begin, chunk_end;  // its chunks in the flat grid
  int pages;  // P
  int vec;  // 16-byte units (1) or bytes (0)
};
static_assert(sizeof(LeafRec) == 40, "LeafRec is five int64 words");

struct CopyIds {
  const int* src;  // (K,) page ids on the card, or nullptr: s and d below
  const int* dst;
  int s[MAX_IDS];
  int d[MAX_IDS];
};

enum Mode : int { POOL_TO_POOL = 0, POOL_TO_BUF = 1, BUF_TO_POOL = 2 };

__global__ void __launch_bounds__(THREADS)
paged_copy_kernel(const LeafRec* __restrict__ leaves, int n, const __grid_constant__ CopyIds ids,
                  uint8_t* buf, long long buf_row, int mode) {
  __shared__ LeafRec rec;
  const int c = blockIdx.x;
  const int k = blockIdx.y;
  const int sid = ids.src != nullptr ? ids.src[k] : ids.s[k];
  const int did = ids.dst != nullptr ? ids.dst[k] : ids.d[k];
  for (int l = threadIdx.x; l < n; l += THREADS) {
    const LeafRec r = leaves[l];
    if (c >= r.chunk_begin && c < r.chunk_end) rec = r;
  }
  __syncthreads();
  const int P = rec.pages;
  const long long page_bytes = rec.page_bytes;
  uint8_t* const pool = reinterpret_cast<uint8_t*>(rec.pool);
  const uint8_t* from;
  uint8_t* to;
  if (mode == BUF_TO_POOL) {
    from = buf + (long long)k * buf_row + rec.buf_off;
  } else {
    int s = sid < 0 ? sid + P : sid;
    s = min(max(s, 0), P - 1);
    from = pool + (long long)s * page_bytes;
  }
  if (mode == POOL_TO_BUF) {
    to = buf + (long long)k * buf_row + rec.buf_off;
  } else {
    const int d = did < 0 ? did + P : did;
    if (d < 0 || d >= P) return;  // the twin's scatter drops it
    to = pool + (long long)d * page_bytes;
  }
  const long long lo = (long long)(c - rec.chunk_begin) * CHUNK;
  const int len = (int)min((long long)CHUNK, page_bytes - lo);  // bytes of this chunk
  from += lo;
  to += lo;
  if (rec.vec) {
    if ((int)threadIdx.x * 16 < len) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(from) + threadIdx.x);
      reinterpret_cast<uint4*>(to)[threadIdx.x] = v;
    }
  } else {
    uint8_t v[CHUNK / THREADS];
#pragma unroll
    for (int j = 0; j < CHUNK / THREADS; ++j) {
      const int i = j * THREADS + threadIdx.x;
      if (i < len) v[j] = from[i];
    }
#pragma unroll
    for (int j = 0; j < CHUNK / THREADS; ++j) {
      const int i = j * THREADS + threadIdx.x;
      if (i < len) to[i] = v[j];
    }
  }
}

}  // namespace

// leaves: n LeafRec on the card; chunks: the set's chunk count (the last
// leaf's chunk_end). Ids: src_dev / dst_dev, (K,) int32 on the card, or both
// NULL and src_host / dst_host, K <= MAX_IDS host ints passed by value.
// mode 0 copies pool -> pool; 1 pool[src] -> buf, 2 buf -> pool[dst], buf
// holding K rows of buf_row bytes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue without launching for arguments outside
// these ranges).
extern "C" int paged_copy_launch(const void* leaves, int n, int chunks, const void* src_dev,
                                 const void* dst_dev, const int* src_host, const int* dst_host,
                                 int K, void* buf, long long buf_row, int mode, void* stream) {
  if (K <= 0 || chunks <= 0) return 0;
  if (n <= 0 || K > 65535 || mode < POOL_TO_POOL || mode > BUF_TO_POOL ||
      (mode != POOL_TO_POOL && buf == nullptr) || (src_dev == nullptr) != (dst_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  CopyIds ids = {};
  ids.src = static_cast<const int*>(src_dev);
  ids.dst = static_cast<const int*>(dst_dev);
  if (src_dev == nullptr) {
    if (K > MAX_IDS || src_host == nullptr || dst_host == nullptr)
      return (int)cudaErrorInvalidValue;
    for (int k = 0; k < K; ++k) {
      ids.s[k] = src_host[k];
      ids.d[k] = dst_host[k];
    }
  }
  const dim3 grid((unsigned)chunks, (unsigned)K);
  paged_copy_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LeafRec*>(leaves), n, ids, static_cast<uint8_t*>(buf), buf_row, mode);
  return (int)cudaGetLastError();
}
