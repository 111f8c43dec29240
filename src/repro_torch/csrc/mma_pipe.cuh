// The shared skeleton of the packed-weight tensor-core matmuls (mpmm.cu,
// wdqmm.cu): the cp.async ring that stages operand tiles in shared memory,
// the padding that keeps the fragment reads free of bank conflicts, and the
// mma.sync instructions; the last two, and the exact three-part bf16 split
// of an f32 operand, serve flash_mha.cu and paged_mla_attn.cu too.
//
// Staging. A stage is a K range of SK values of every row of a block's tile,
// taken from a row-major matrix of packed rows (pitch = K * bits / 8 bytes)
// into shared memory rows of `stride` bytes, 16 bytes a copy. Where every row
// starts on a 16-byte boundary (`vec`), the copies are cp.async.cg (L2 only,
// the weights are read once) and run behind the compute on the earlier
// stages; bytes past a row's end are zero-filled by the copy itself. Any
// other pitch or address takes the same tile through plain byte loads, so
// the shared-memory image, and every sum made from it, is the same.
//
// Fragment reads. Each lane reads `per` contiguous bytes of a row (4 lanes a
// row, rows g = lane / 4). The padded stride puts the rows that one phase
// of a shared-memory load covers on distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_pipe {

// Shared memory a block may take on this card (H100: 227 KB).
constexpr int MAX_SMEM = 232448;

// A block's tiling: MT x NT mma tiles a warp; WM x WN warps over the
// block's rows and columns and WK warps splitting each stage's K; CPW
// chunks a warp takes from each stage (wdqmm; mpmm's warps take one K
// group); AR
// activation rows staged (fewer than the block's rows only at decode: the
// fragments' other rows are zeros); STAGES stages in the cp.async ring.
template <int MT_, int NT_, int WM_, int WN_, int WK_, int CPW_, int AR_, int STAGES_>
struct Tile {
  static constexpr int MT = MT_, NT = NT_, WM = WM_, WN = WN_, WK = WK_, CPW = CPW_;
  static constexpr int STAGES = STAGES_;
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 8 * NT * WN;
  static constexpr int THREADS = 32 * WM * WN * WK;
  static constexpr int AR = AR_ < BM ? AR_ : BM;
};

// Shared-memory row stride for rows of `row` bytes of which each lane reads
// `per` contiguous bytes (lane t at t * per): for per <= 16 one load phase
// covers 128 / (4 per) rows, which tile the 32 banks when the stride is an
// odd multiple of 4 per modulo 8 per; for per = 32 (two 16-byte loads) two
// rows a phase, so an odd multiple of 16 modulo 32.
constexpr int stride(int row, int per) {
  return per <= 16 ? row + (4 * per - row % (8 * per) + 8 * per) % (8 * per)
                   : row + (16 - row % 32 + 32) % 32;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + R), bytes [b0, b0 + SB) of each, into dst (row stride
// `ds`); rows at or past `nrows` and bytes past a row's end become zeros.
template <int R, int SB, int THREADS>
__device__ __forceinline__ void stage_rows(uint8_t* dst, int ds, const uint8_t* __restrict__ src,
                                           long long pitch, int nrows, int r0, long long b0,
                                           int vec) {
  constexpr int CH = SB / 16;
  for (int i = threadIdx.x; i < R * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i - r * CH;
    uint8_t* d = dst + r * ds + c * 16;
    const long long off = b0 + c * 16;
    const int valid = r0 + r < nrows && off < pitch ? (int)min(16LL, pitch - off) : 0;
    const uint8_t* s = valid ? src + (long long)(r0 + r) * pitch + off : src;
    if (vec) {
      cp_async16(d, s, valid);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; j < valid; ++j) v[j >> 2] |= (uint32_t)__ldg(s + j) << (8 * (j & 3));
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// d += a . b on s8 (or u8, for A) by s8 into s32: m16n8k32.
template <bool AU8>
__device__ __forceinline__ void mma_i8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (AU8) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// d = a . b + c on bf16 into f32: m16n8k16.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// Split two f32 values (adjacent k) into the bf16 pairs hi, mid and lo with
// hi + mid + lo == x exactly, each pair one fragment register: hi holds x's
// top 8 significant bits, mid the next 8, lo the last 8 (only a value below
// ~2^-110 can lose bits to underflow), so each part's product with a bf16
// operand is exact in f32 and three bf16 products take x at f32 precision.
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r1 = make_float2(__fsub_rn(x.x, hf.x), __fsub_rn(x.y, hf.y));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r1.x, r1.y);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r1.x, mf.x), __fsub_rn(r1.y, mf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Set the dynamic shared memory a kernel may take above 48 KB, once.
template <typename F>
__host__ inline cudaError_t allow_smem(F* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace mma_pipe
