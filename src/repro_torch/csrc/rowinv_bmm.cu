// Row-invariant f32 batched product C[z] = A[z] @ B[z] over strided
// operands, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference computes the unfused attention's
// products (models/attention.py: the GQA read's q . k and p . v, the MLA
// read's five absorbed einsums) with jnp.einsum, which XLA lowers to a dot;
// the port ran them through torch.einsum, which on the card goes to cuBLAS.
// cuBLAS picks its kernel (tile, split over k) by the shape, so one query
// row got other bits when computed alone (a decode step, M = 1) than among
// 16 rows (a continuous mixed step) or 5 (a speculative verify), and the
// continuous and speculative engines parted from the serialized one at
// ties. This kernel makes the order of every sum a function of K alone:
//   * each output C[z][m, n] is one f32 FMA chain over k = 0, 1, ..., K - 1
//     in order, from 0 (fmaf, no split over k, no atomics), computed by one
//     thread;
//   * the tiles only decide which thread computes an output and which
//     values it reads from shared memory, never the order of its chain: the
//     launcher may pick the tile from M (decode, verify, mixed step) and a
//     row keeps its bits whatever M, N and the batch count are.
// The batch is two dimensions (z1, z2) with a stride each on every operand
// (0 where an operand is shared across it: MLA's weights across the batch
// of slots, its latents across the heads), so every einsum of the two
// attention reads maps onto one launch without a copy.
//
// Bound on this card: at the serving shapes the products are matrix-vector
// work over the dequantized cache (M = 1..16 query rows against Sk = 1024
// keys), a few flops a byte, so device-memory bytes bound them (internlm2's
// q . k at decode: 4 slots x 16 heads x 1024 x 128 f32 keys, 33.6 MB, 0.010
// ms at 3.35 TB/s; an unfused decode step's 48 products 0.485 ms). The first
// design (a block of 256 threads over a tile of 1 or 16 rows, K staged in
// chunks of 32 through shared memory one load at a time) took 9.86 ms a
// step on an H100: each thread waited on its loads one by one, and p . v
// (N = 128) ran 64 blocks on 132 SMs. This design keeps every chain and
// changes only how the operands arrive:
//   * a block is BN threads, one output column each (BN = 128, or 32 where
//     N is narrow, so p . v's 4 slots x 16 heads x 128 columns make 256
//     blocks), and holds RM rows' accumulators (RM = 1, 4, 8 or 16 from M);
//   * each chunk of BK = 32 k's is loaded whole before it is used: the
//     column's 32 values of B straight from device memory into registers
//     when B's columns are contiguous (a warp reads 128 consecutive bytes a
//     k), or, when its k's are (q . k: a key row of d), 32 loads a thread
//     issued together, a warp reading 128 consecutive bytes of one row,
//     then written transposed to shared memory; A's RM x 32 values go to
//     shared memory and every thread reads them by broadcast;
//     B's column values for the next chunk are loaded while this chunk's
//     FMAs run;
//   * the chain runs over the chunk's k's in order from registers, A read
//     four k's at a time (float4 from shared memory); the last chunk stops
//     at K (a padded k is never added).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;  // k a chunk

struct Strides {
  long long a1, a2, am, ak;  // A: batch z1, z2, row m, contraction k
  long long b1, b2, bk, bn;  // B: batch z1, z2, contraction k, column n
  long long c1, c2, cm, cn;  // C: batch z1, z2, row m, column n
};

// A block owns rows [m0, m0 + RM) and columns [n0, n0 + BN) of one batch
// entry; thread tx computes column n0 + tx of every row.
template <int RM, int BN>
__global__ void __launch_bounds__(BN)
rowinv_bmm_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                  int Z2, int M, int N, int K, Strides st) {
  static_assert(BN % 32 == 0, "whole warps");
  __shared__ __align__(16) float as[RM][BK];  // read as float4: 4 k's of a row
  __shared__ float bs[BK][BN + 1];  // B's chunk when its k's are contiguous
  const int z1 = blockIdx.z / Z2;
  const int z2 = blockIdx.z - z1 * Z2;
  const float* a = A + z1 * st.a1 + z2 * st.a2;
  const float* b = B + z1 * st.b1 + z2 * st.b2;
  const int m0 = blockIdx.y * RM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x;
  const int n = n0 + tx;
  const bool b_kfast = st.bk == 1 && st.bn != 1;

  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.0f;

  // B's column straight from device memory (B's columns contiguous): the
  // next chunk's loads are issued before this chunk's FMAs
  float next[BK];
  if (!b_kfast) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk)
      next[kk] = (n < N && kk < K) ? b[kk * st.bk + n * st.bn] : 0.0f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kn = min(BK, K - k0);
    for (int i = tx; i < RM * BK; i += BN) {
      const int m = i / BK;
      const int k = i % BK;
      as[m][k] = (m0 + m < M && k < kn) ? a[(m0 + m) * st.am + (k0 + k) * st.ak] : 0.0f;
    }
    float bv[BK];
    if (b_kfast) {
      // element j of this thread: k = tx % BK, column n0 + (j * BN + tx) / BK
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const int i = j * BN + tx;
        const int c = n0 + i / BK;
        const int k = i % BK;
        bv[j] = (c < N && k < kn) ? b[(k0 + k) * st.bk + c * st.bn] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const int i = j * BN + tx;
        bs[i % BK][i / BK] = bv[j];
      }
    }
    __syncthreads();
    if (b_kfast) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) bv[kk] = bs[kk][tx];
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) bv[kk] = next[kk];
      const int k1 = k0 + BK;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk)
        next[kk] = (n < N && k1 + kk < K) ? b[(k1 + kk) * st.bk + n * st.bn] : 0.0f;
    }
    // k in order: the chain never depends on the tile
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(&as[r][k4]);
        if (k4 < kn) acc[r] = fmaf(av.x, bv[k4], acc[r]);
        if (k4 + 1 < kn) acc[r] = fmaf(av.y, bv[k4 + 1], acc[r]);
        if (k4 + 2 < kn) acc[r] = fmaf(av.z, bv[k4 + 2], acc[r]);
        if (k4 + 3 < kn) acc[r] = fmaf(av.w, bv[k4 + 3], acc[r]);
      }
    }
    __syncthreads();
  }

  if (n >= N) return;
  float* c = C + z1 * st.c1 + z2 * st.c2 + n * st.cn;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + r;
    if (m < M) c[m * st.cm] = acc[r];
  }
}

template <int RM, int BN>
int launch(const float* a, const float* b, float* c, int Z1, int Z2, int M, int N, int K,
           const Strides& st, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + RM - 1) / RM, Z1 * Z2);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  rowinv_bmm_kernel<RM, BN><<<grid, BN, 0, stream>>>(a, b, c, Z2, M, N, K, st);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_rows(const float* a, const float* b, float* c, int Z1, int Z2, int M, int N, int K,
                const Strides& st, cudaStream_t stream) {
  if (M == 1) return launch<1, BN>(a, b, c, Z1, Z2, M, N, K, st, stream);
  if (M <= 4) return launch<4, BN>(a, b, c, Z1, Z2, M, N, K, st, stream);
  if (M <= 8) return launch<8, BN>(a, b, c, Z1, Z2, M, N, K, st, stream);
  return launch<16, BN>(a, b, c, Z1, Z2, M, N, K, st, stream);
}

}  // namespace

// a, b, c: f32; C[z1, z2][m, n] = sum_k A[z1, z2][m, k] * B[z1, z2][k, n],
// each operand addressed through the twelve strides (in elements; a
// stride may be 0): A's z1, z2, m, k, then B's z1, z2, k, n, then C's z1,
// z2, m, n. Z1, Z2, M, N >= 1, K >= 0 (K = 0 writes zeros). The tile is
// picked from the shape: 1, 4, 8 or 16 rows a block from M, 128 or 32
// columns from N; the bits of an output do not depend on it. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int rowinv_bmm_launch(const void* a, const void* b, void* c, int Z1, int Z2, int M,
                                 int N, int K, const long long* strides, void* stream) {
  if (Z1 < 1 || Z2 < 1 || M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (N >= 512) return launch_rows<128>(A, B, C, Z1, Z2, M, N, K, st, str);
  return launch_rows<32>(A, B, C, Z1, Z2, M, N, K, st, str);
}
