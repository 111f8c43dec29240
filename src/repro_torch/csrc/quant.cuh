// Device helpers shared by the packed kernels (mpmm.cu, conv2d.cu, qntpack.cu):
// reading one field of a packed row, and the paper's QntPack on one int32
// accumulator (requant) and on ry adjacent results (pack).
//
// Layouts (kernels/ref.py, core/pack.py): sub-byte fields are little-endian
// inside each byte along the packed axis; weights are sign-extended, ifmaps
// and ofmaps unsigned. The requant vector rqv is int32
// [shift, bias, 2^y - 1 ascending thresholds] (kernels/mpmm.py requant_vector).
//
// Requant arithmetic is the reference's, bit for bit:
//   * y = 8: (acc + bias) >> shift, clamped to [0, 255]. The sum wraps as
//     JAX's int32 add does: it is taken on uint32 (signed overflow is
//     undefined in C++), and the shift is arithmetic;
//   * y = 4, 2: the threshold ladder, sum_i [acc >= T_i] (no search).

#pragma once

#include <stdint.h>

// Unsigned field of value k in a packed row.
template <int BITS>
__device__ __forceinline__ int field_u(const int8_t* row, long long k) {
  if constexpr (BITS == 8) {
    return (int)(uint8_t)row[k];
  } else {
    constexpr int R = 8 / BITS;
    const uint32_t b = (uint8_t)row[k / R];
    return (int)((b >> ((k % R) * BITS)) & ((1u << BITS) - 1u));
  }
}

// Sign-extended field of value k in a packed row.
template <int BITS>
__device__ __forceinline__ int field_s(const int8_t* row, long long k) {
  if constexpr (BITS == 8) {
    return (int)row[k];
  } else {
    const int u = field_u<BITS>(row, k);
    return (u ^ (1 << (BITS - 1))) - (1 << (BITS - 1));
  }
}

// Wrap-safe int32 add (two's complement, as JAX computes it).
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

// QntPack phase 1: one int32 accumulator -> its y_bits-wide unsigned code.
__device__ __forceinline__ int requant_one(int acc, const int* __restrict__ rqv, int y_bits) {
  if (y_bits == 8) {
    const int q = add_wrap(acc, rqv[1]) >> rqv[0];  // arithmetic shift
    return min(max(q, 0), 255);
  }
  int q = 0;
  const int nt = (1 << y_bits) - 1;
#pragma unroll
  for (int i = 0; i < nt; ++i) q += (acc >= rqv[2 + i]) ? 1 : 0;
  return q;
}

// QntPack phase 2: ry = 8 / y_bits codes -> one packed byte, code j in bits
// [j * y_bits, (j + 1) * y_bits).
__device__ __forceinline__ int8_t pack_byte(const int* q, int y_bits) {
  const int ry = 8 / y_bits;
  uint32_t word = 0;
  for (int j = 0; j < ry; ++j) {
    word |= ((uint32_t)q[j] & ((1u << y_bits) - 1u)) << (j * y_bits);
  }
  return (int8_t)(uint8_t)word;
}
