// The paper's Reference Layer conv for Hopper (sm_90a): 3x3, stride 1, pad 1,
// HWC, packed ifmap (H, W, C / rx) and packed weights (Cout, 9C / rw) in
// (dy, dx, c) order -> packed ofmap (H, W, Cout / ry), all 27 (x, w, y) cells.
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py::conv2d_pallas, which
// fuses the paper's three phases: im2col, the s8 MatMul and QntPack. x_bits
// and w_bits are template parameters, y_bits a runtime argument.
//
// Arithmetic (bit-exact with kernels/ref.py::conv2d_ref):
//   * the ifmap is NOT pre-padded: the kernel masks the 1-pixel border
//     itself. A border tap is treated exactly as x = 0, as the reference's
//     integer zero pad;
//   * 8-bit unsigned ifmaps are offset-folded like mpmm's: the kernel
//     computes with x' = x - 128 in s8 and adds 128 * sum(w) over ALL 9C taps.
//     A border tap is x' = -128 there, whose share of the fold cancels it, so
//     the sum equals the u8 x s8 one. Sub-byte ifmaps fit s8 as they are;
//   * products accumulate in int32 with __dp4a; integer sums are exact in any
//     order (|phi| <= 9C * 255 * 128);
//   * requant and pack are quant.cuh's, the same code as mpmm's epilogue.
//
// Design (a simple kernel that is right; no tensor cores, no TMA): one block
// per (output row h, tile of CT output channels). The block unpacks the three
// input rows h-1..h+1 (border columns included) to s8 in shared memory once,
// and its CT weight rows too, each pixel's channels padded with zeros to Cp.
// For a fixed dy, the im2col row of pixel p is then the 3 * Cp contiguous
// bytes of input row dy starting at pixel p, so a thread walks it as words and
// feeds __dp4a directly. A thread owns one pixel and 4 adjacent output
// channels (a packed output byte holds 8/y_bits <= 4 adjacent channels, so
// each byte is formed by one thread); neighbouring threads take neighbouring
// pixels. Cp / 4 is kept odd, so the 32 pixels of a warp read 32 different
// shared-memory banks. Bound on this card: at the paper's shape (16x16, 32 ->
// 64) the work is a few microseconds of launch latency; at 224x224 the ifmap
// and ofmap bytes bound it (about 1-2 us), against which this kernel's
// re-unpack of the weights per block and its dp4a rate are the cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CT = 64;   // output channels per block
constexpr int CPT = 4;   // output channels per thread

template <int XB, int WB>
__global__ void __launch_bounds__(THREADS)
conv2d_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const int* __restrict__ rqv, int8_t* __restrict__ out, int H, int W, int C,
              int Cp, int Cout, int y_bits) {
  extern __shared__ __align__(16) int8_t smem[];
  const int h = blockIdx.x;
  const int n_base = blockIdx.y * CT;
  const int ct = min(CT, Cout - n_base);
  const int row_px = W + 2;                       // staged pixels per input row
  int8_t* xs = smem;                              // [3][W + 2][Cp]
  int8_t* ws = xs + 3 * row_px * Cp;              // [CT][9][Cp]
  int* wsum = reinterpret_cast<int*>(ws + CT * 9 * Cp);  // [CT]
  const long long Cx = C / (8 / XB);              // packed bytes per ifmap pixel
  const long long Kw = 9LL * C / (8 / WB);        // packed bytes per weight row
  constexpr int OFF = (XB == 8) ? 128 : 0;        // u8 offset fold

  for (int i = threadIdx.x; i < 3 * row_px * Cp; i += THREADS) {
    const int r = i / (row_px * Cp);
    const int rem = i - r * row_px * Cp;
    const int col = rem / Cp;
    const int c = rem - col * Cp;
    const int ih = h - 1 + r;
    const int iw = col - 1;
    int v = 0;
    if (c < C) {
      const bool inside = ih >= 0 && ih < H && iw >= 0 && iw < W;
      v = (inside ? field_u<XB>(x + ((long long)ih * W + iw) * Cx, c) : 0) - OFF;
    }
    xs[i] = (int8_t)v;
  }
  for (int i = threadIdx.x; i < CT * 9 * Cp; i += THREADS) {
    const int n = i / (9 * Cp);
    const int t = i - n * 9 * Cp;
    const int k9 = t / Cp;
    const int c = t - k9 * Cp;
    int v = 0;
    if (n < ct && c < C) v = field_s<WB>(w + (long long)(n_base + n) * Kw, (long long)k9 * C + c);
    ws[i] = (int8_t)v;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < CT; n += THREADS) {
    const int* row = reinterpret_cast<const int*>(ws + n * 9 * Cp);
    int s = 0;
    for (int j = 0; j < 9 * Cp / 4; ++j) s = __dp4a(row[j], 0x01010101, s);
    wsum[n] = s;
  }
  __syncthreads();

  const int groups = (ct + CPT - 1) / CPT;
  const int ry = 8 / y_bits;
  const long long out_row = Cout / ry;  // packed bytes per ofmap pixel
  for (int it = threadIdx.x; it < W * groups; it += THREADS) {
    const int px = it % W;
    const int c0 = (it / W) * CPT;
    int acc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] = 0;
    for (int dy = 0; dy < 3; ++dy) {
      const int* xr = reinterpret_cast<const int*>(xs + (dy * row_px + px) * Cp);
      const int* wr = reinterpret_cast<const int*>(ws + c0 * 9 * Cp + dy * 3 * Cp);
      for (int j = 0; j < 3 * Cp / 4; ++j) {
        const int xv = xr[j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c] = __dp4a(xv, wr[c * 9 * Cp / 4 + j], acc[c]);
      }
    }
    int q[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int a = OFF ? add_wrap(acc[c], OFF * wsum[c0 + c]) : acc[c];
      q[c] = requant_one(a, rqv, y_bits);
    }
    int8_t* dst = out + ((long long)h * W + px) * out_row;
    for (int b = 0; b < CPT / ry; ++b) {
      const int nb = n_base + c0 + b * ry;
      if (nb >= Cout) break;
      dst[nb / ry] = pack_byte(&q[b * ry], y_bits);
    }
  }
}

template <int XB, int WB>
int launch(const void* x, const void* w, const void* rqv, void* out, int H, int W, int C,
           int Cp, int Cout, int y_bits, cudaStream_t stream) {
  const size_t smem = (size_t)3 * (W + 2) * Cp + (size_t)CT * 9 * Cp + CT * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_kernel<XB, WB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(H, (Cout + CT - 1) / CT);
  conv2d_kernel<XB, WB><<<grid, THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(rqv), static_cast<int8_t*>(out), H, W, C, Cp, Cout, y_bits);
  return (int)cudaGetLastError();
}

}  // namespace

// x (H, W, C * x_bits / 8) and w (Cout, 9C * w_bits / 8) packed int8, unpadded;
// rqv int32 [shift, bias, thresholds...]; out (H, W, Cout * y_bits / 8) int8.
// Cp: the staged channel width (C rounded up to a multiple of 4 with Cp / 4
// odd; the wrapper computes it and checks the shared memory it needs).
// Returns the launch's cudaError_t.
extern "C" int conv2d_launch(const void* x, const void* w, const void* rqv, void* out, int H,
                             int W, int C, int Cp, int Cout, int x_bits, int w_bits,
                             int y_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_bits != 8 && y_bits != 4 && y_bits != 2) return (int)cudaErrorInvalidValue;
#define CONV_CASE(XB, WB) \
  case XB * 16 + WB:      \
    return launch<XB, WB>(x, w, rqv, out, H, W, C, Cp, Cout, y_bits, s);
  switch (x_bits * 16 + w_bits) {
    CONV_CASE(8, 8) CONV_CASE(8, 4) CONV_CASE(8, 2)
    CONV_CASE(4, 8) CONV_CASE(4, 4) CONV_CASE(4, 2)
    CONV_CASE(2, 8) CONV_CASE(2, 4) CONV_CASE(2, 2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CONV_CASE
}
