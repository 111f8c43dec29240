// The paper's Reference Layer conv for Hopper (sm_90a): 3x3, stride 1, pad 1,
// HWC, packed ifmap (H, W, C / rx) and packed weights (Cout, 9C / rw) in
// (dy, dx, c) order -> packed ofmap (H, W, Cout / ry), all 27 (x, w, y) cells.
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py::conv2d_pallas, which
// fuses the paper's three phases: im2col, the s8 MatMul and QntPack. x_bits,
// w_bits and the block's output-channel tile are template parameters, y_bits
// a runtime argument.
//
// Arithmetic (bit-exact with kernels/ref.py::conv2d_ref):
//   * an implicit GEMM: M = output pixels, N = Cout, K = 9C in (dy, dx, c)
//     order, on the tensor cores, mma.sync m16n8k32 into int32: u8 x s8 for
//     8-bit ifmaps (as mpmm's XU8 path), s8 x s8 for sub-byte ones (their
//     unsigned values fit s8), so no offset fold; integer sums are exact in
//     any order (|phi| <= 9C * 255 * 128);
//   * the ifmap is NOT pre-padded: a border tap is staged as x = 0, exactly
//     the reference's integer zero pad;
//   * channels are padded with zeros to Cp = C rounded up to 32 on both
//     operands, so each k32 step is one tap's (or 32 channels of one tap's)
//     products, and the padded products add exact zeros;
//   * requant and pack are quant.cuh's requant_one and pack_byte per packed
//     byte, from the int32 tile staged in shared memory (as mpmm's epilogue).
//
// Bound on this card: at the paper's shape (16x16, 32 -> 64) the work is far
// below a launch's latency; at 224x224 the ifmap and ofmap bytes bound it
// (about 1 us). The first design (one block per output row and 64 channels,
// __dp4a over bytes unpacked one field at a time) took 32.4 us and 148 us on
// an H100 80GB HBM3 at 700 W; its weight unpack alone was 72% of a block at
// the paper's shape (scripts/probe_conv2d_phases.py; PERF.md rows 6a-6b).
// Design:
//   1. A block owns a band of output rows, a segment of WS pixels of each
//      (WS a multiple of 16, all of W where it fits) and a tile of CT output
//      channels. Staging copies packed bytes with cp.async, the 16-byte
//      chunks that hold a contiguous range (the tile's weight rows; an input
//      row's pixels of the segment and its halo), all in flight together,
//      then unpacks them in shared memory a 32-bit word (4 fields) a thread
//      and step, the word's index split by multiply-shift divisors made on
//      the host. (A first version loaded and unpacked from device memory
//      word by word: its address arithmetic and dependent loads took 5 to
//      13 us a block, scripts/probe_conv2d_phases.py.)
//   2. Weights: unpacked once a block into rows of 9 Cp bytes at a stride of
//      an odd multiple of 32 bytes (odd32). Input rows: a ring of three
//      slots; the band's first row stages rows h-1..h+1 with the weights, and
//      while row h is multiplied the packed bytes of row h+2 are in flight,
//      unpacked into the slot of row h-1 when row h is done. A slot holds
//      WS + 2 pixels (zeros at the border and outside the ifmap), Cp
//      channels each at a pixel stride of an odd multiple of 32 bytes.
//   3. Products: a warp takes an m16 tile of pixels and NTW n8 tiles of
//      channels; for tap (dy, dx) and 32 channels c, A's row g is pixel
//      p + g + dx of staged row dy and B's column is a weight row; lane t
//      reads 8 contiguous bytes of each (k 8t..8t+7, fed to the MMA's k slots
//      4t..4t+3 and 16+4t..16+4t+3 on both operands alike), one 64-bit load
//      each, conflict-free at those strides.
//   4. Epilogue: the warp's int32 tile goes to its own shared-memory scratch,
//      then each lane requantizes and packs whole output bytes and stores
//      them, the output width a template parameter there so that the
//      requant vector sits in registers.
// The launcher picks CT (64, 32 or 16: the largest that still gives
// MIN_BLOCKS blocks of one row each) and the band height (rows a block, so
// that the grid is about ROW_BLOCKS blocks); both constants come from the
// sweep in scripts/probe_conv2d_phases.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_pipe.cuh"
#include "quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WS_MAX = 256;      // output pixels of a row a block takes at most
constexpr int MIN_BLOCKS = 128;  // the grid a CT must still give, rows one a block
constexpr int ROW_BLOCKS = 264;  // the grid the band height aims at
constexpr int RQ_MAX = 2 + 15;   // requant vector entries read: shift, bias, y = 4's ladder

// n8 tiles of output channels a warp takes at a time
__host__ __device__ constexpr int ntw(int ct) { return ct >= 32 ? 4 : ct / 8; }

// A row of b bytes (a multiple of 32) padded to an odd multiple of 32, so
// that 4 consecutive rows start in 4 distinct 32-byte bank groups
// (mma_pipe::stride's rule for 8-byte reads, callable at run time here)
__host__ __device__ constexpr int odd32(int b) { return b + (32 - b % 64 + 64) % 64; }

__host__ __device__ constexpr int up(int x, int a) { return (x + a - 1) / a * a; }

// Shared-memory layout of one launch configuration (bytes): the requant
// vector, the unpacked weight tile, the ring of three unpacked input rows,
// the warps' epilogue scratch (which the first staging's packed bytes use
// before it) and the packed bytes of the next input row.
struct Layout {
  int Cp, nc, PX, WST, WS, RS, ES, RAWW, RAWX;
  int rq, ws, ring, scr, pre, bytes;
  __host__ __device__ Layout(int C, int W_seg, int ct, int XB, int WB) {
    Cp = up(C, 32);
    nc = Cp / 32;
    PX = odd32(Cp);       // staged pixel stride
    WST = odd32(9 * Cp);  // weight row stride
    WS = W_seg;
    RS = up((WS + 2) * PX, 128);
    ES = 8 * ntw(ct) + 4;  // epilogue scratch row stride, ints
    RAWW = up(ct * 9 * C * WB / 8, 16) + 32;  // packed bytes, 16-byte chunks, slack
    RAWX = up((WS + 2) * C * XB / 8, 16) + 32;
    rq = 0;
    ws = 128;  // RQ_MAX ints
    ring = ws + up(ct * WST, 128);
    scr = ring + 3 * RS;
    const int scr_bytes = WARPS * 16 * ES * 4;
    pre = scr + up(scr_bytes > RAWW + 3 * RAWX ? scr_bytes : RAWW + 3 * RAWX, 128);
    bytes = pre + RAWX;
  }
};

// n / d for 0 <= n < 2^32 by a multiply-high, an add and a shift (the
// round-up method; m and s made on the host): the unpack loops' index
// arithmetic, where an integer division by a run-time d costs tens of
// instructions a word.
struct Div {
  uint32_t m;
  int s;
  __host__ static Div of(uint32_t d) {
    Div v{0, 0};
    while ((1ull << v.s) < d) ++v.s;
    v.m = (uint32_t)(((1ull << 32) * ((1ull << v.s) - d)) / d + 1);
    return v;
  }
  __device__ int operator()(int n) const {
    return (int)(((uint64_t)__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
};

// The divisors of a launch: weight words a row (9 Cp / 4) and a tap (Cp / 4),
// staged words a pixel (PX / 4).
struct Divs {
  Div row, tap, px;
};

// Copy the bytes [b0, b1) of a tensor at g into shared memory at dst as the
// 16-byte chunks that hold them (all in flight; the chunks' extra bytes lie
// beside bytes of the tensor, on its pages). Returns the offset from dst at
// which byte b0 landed, (g + b0) % 16.
__device__ __forceinline__ int raw_copy(uint8_t* dst, const uint8_t* g, long long b0,
                                        long long b1) {
  if (b1 <= b0) return 0;
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(g + b0) & ~uintptr_t(15);
  const uintptr_t a1 = (reinterpret_cast<uintptr_t>(g + b1) + 15) & ~uintptr_t(15);
  for (int k = threadIdx.x; k < (int)((a1 - a0) / 16); k += THREADS)
    mma_pipe::cp_async16(dst + 16 * k, reinterpret_cast<const void*>(a0 + 16 * k), 16);
  return (int)(reinterpret_cast<uintptr_t>(g + b0) - a0);
}

// n <= 4 packed bytes at shared-memory byte offset o of raw, little-endian,
// from the two aligned words that hold them (raw has 4 bytes of slack).
__device__ __forceinline__ uint32_t raw_bytes(const uint8_t* raw, int o, int n) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(raw + (o & ~3));
  const uint32_t v = __funnelshift_r(a[0], a[1], 8 * (o & 3));
  return n >= 4 ? v : v & ((1u << (8 * n)) - 1u);
}

// 4 packed BITS-wide fields (the low 4 * BITS bits of raw) -> 4 bytes,
// zero-extended, or sign-extended (two's complement fields) when SIGNED.
template <int BITS, bool SIGNED>
__device__ __forceinline__ uint32_t expand(uint32_t raw) {
  if constexpr (BITS == 8) {
    return raw;
  } else if constexpr (BITS == 4) {
    const uint32_t u = (raw & 0xFu) | ((raw & 0xF0u) << 4) | ((raw & 0xF00u) << 8) |
                       ((raw & 0xF000u) << 12);
    return SIGNED ? __vsub4(u ^ 0x08080808u, 0x08080808u) : u;
  } else {
    const uint32_t u = (raw & 0x3u) | ((raw & 0xCu) << 6) | ((raw & 0x30u) << 12) |
                       ((raw & 0xC0u) << 18);
    return SIGNED ? __vsub4(u ^ 0x02020202u, 0x02020202u) : u;
  }
}

// One warp's item of the epilogue: the 16 x 8 NTW int32 tile at scr (row
// stride ES) -> npx pixels x nby packed bytes at dst (pixel stride orow), a
// byte a lane at a time, through quant.cuh's requant_one and pack_byte at
// output width Y (the requant vector rq in registers: constant indices).
template <int Y, int NTW>
__device__ __forceinline__ void emit(const int* scr, int ES, const int* rq, int8_t* dst,
                                     long long orow, int npx, int nby, int lane) {
  constexpr int RY = 8 / Y;
  constexpr int NB = 8 * NTW / RY;  // packed bytes a pixel of the item
#pragma unroll
  for (int k = 0; k < (16 * NB + 31) / 32; ++k) {
    const int idx = lane + 32 * k;
    const int r = idx / NB;
    const int b = idx % NB;
    if (idx < 16 * NB && r < npx && b < nby) {
      int q[RY];
#pragma unroll
      for (int j = 0; j < RY; ++j) q[j] = requant_one(scr[r * ES + b * RY + j], rq, Y);
      dst[r * orow + b] = pack_byte(q, Y);
    }
  }
}

template <int XB, int WB, int CT>
__global__ void __launch_bounds__(THREADS, 2)
conv2d_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
              const int* __restrict__ rqv, int8_t* __restrict__ out, int H, int W, int C,
              int Cout, int y_bits, int WSeg, int nseg, int nct, int rpb, Divs dv) {
  constexpr bool XU8 = XB == 8;
  constexpr int NTW = ntw(CT);
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout L(C, WSeg, CT, XB, WB);
  const int ct = blockIdx.x % nct;
  const int seg = (blockIdx.x / nct) % nseg;
  const int band = blockIdx.x / (nct * nseg);
  const int n0 = ct * CT;
  const int w0 = seg * L.WS;
  const int h0 = band * rpb;
  const int h1 = min(H, h0 + rpb);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  int* rq = reinterpret_cast<int*>(smem + L.rq);
  uint8_t* ws = smem + L.ws;
  uint8_t* ring = smem + L.ring;
  int* scr = reinterpret_cast<int*>(smem + L.scr) + warp * 16 * L.ES;
  uint8_t* raw_w = smem + L.scr;     // the first staging's packed bytes, over the scratch
  uint8_t* raw_x = raw_w + L.RAWW;   // three rows of them
  uint8_t* pre = smem + L.pre;       // the next input row's packed bytes
  // the entries requant_one reads (shift and bias, or the ladder), zeros after
  if (tid < (y_bits == 8 ? 2 : 2 + (1 << y_bits) - 1)) rq[tid] = rqv[tid];
  else if (tid < RQ_MAX) rq[tid] = 0;

  const int CW = L.Cp / 4;  // words a (row, tap) of weights / of a staged pixel's channels
  const int PW = L.PX / 4;  // words a staged pixel, padding included
  const int xrow = C * XB / 8;      // packed bytes an ifmap pixel
  const int wrow = 9 * C * WB / 8;  // packed bytes a weight row
  const int ctv = min(CT, Cout - n0);                               // the tile's weight rows
  const int iwlo = max(w0 - 1, 0), iwhi = min(w0 + L.WS + 1, W);  // the segment's input pixels
  auto slot = [&](int ih) { return ring + ((ih - h0 + 1) % 3) * L.RS; };
  // input row ih's packed bytes of the segment -> raw (none outside the
  // ifmap); returns where pixel iwlo's landed
  auto copy_row = [&](uint8_t* raw, int ih) {
    return ih >= 0 && ih < H ? raw_copy(raw, x, ((long long)ih * W + iwlo) * xrow,
                                        ((long long)ih * W + iwhi) * xrow)
                             : 0;
  };
  // input row ih from its packed bytes at raw + o into its slot, a word (a
  // pixel's 4 channels) a thread and step; zeros outside the ifmap
  // Where C is a multiple of 32 and pixels sit unpadded (PX == C), a row's
  // staged words from its first pixel in the ifmap to its last are the
  // packed fields in order: word j from the XB / 2 packed bytes at o + j XB / 2.
  const bool lin_x = C == L.Cp && L.PX == L.Cp;
  auto unpack_row = [&](const uint8_t* raw, int o, int ih) {
    uint8_t* dst = slot(ih);
    const bool in = ih >= 0 && ih < H;
    if (lin_x) {
      const int v0 = in ? (iwlo - w0 + 1) * PW : 0;
      const int v1 = in ? (iwhi - w0 + 1) * PW : 0;
#pragma unroll 4
      for (int i = tid; i < (L.WS + 2) * PW; i += THREADS)
        *reinterpret_cast<uint32_t*>(dst + 4 * i) =
            i >= v0 && i < v1 ? expand<XB, false>(raw_bytes(raw, o + (i - v0) * XB / 2, XB / 2))
                              : 0u;
      return;
    }
#pragma unroll 4
    for (int i = tid; i < (L.WS + 2) * PW; i += THREADS) {
      const int col = dv.px(i);
      const int c0 = (i - col * PW) * 4;
      const int iw = w0 + col - 1;
      uint32_t v = 0;
      if (in && iw >= 0 && iw < W && c0 < C)
        v = expand<XB, false>(raw_bytes(raw, o + (iw - iwlo) * xrow + c0 * XB / 8,
                                        (min(4, C - c0) * XB + 7) / 8));
      *reinterpret_cast<uint32_t*>(dst + 4 * i) = v;
    }
  };

  // the first staging: the weight tile's and three input rows' packed bytes,
  // every copy in flight together; then their unpack in shared memory
  const int ow = raw_copy(raw_w, w, (long long)n0 * wrow, (long long)(n0 + ctv) * wrow);
  int ox[3];
  for (int r = 0; r < 3; ++r) ox[r] = copy_row(raw_x + r * L.RAWX, h0 - 1 + r);
  mma_pipe::cp_commit();
  mma_pipe::cp_wait<0>();
  __syncthreads();
  // the weight tile; where C is a multiple of 32 and rows sit unpadded
  // (WST == 9 C), its words are the packed rows' fields in order
  if (C == L.Cp && L.WST == 9 * L.Cp) {
#pragma unroll 4
    for (int i = tid; i < CT * 9 * CW; i += THREADS)
      *reinterpret_cast<uint32_t*>(ws + 4 * i) =
          i < ctv * 9 * CW ? expand<WB, true>(raw_bytes(raw_w, ow + i * WB / 2, WB / 2)) : 0u;
  } else {
#pragma unroll 4
    for (int i = tid; i < CT * 9 * CW; i += THREADS) {
      const int n = dv.row(i);
      const int r = i - n * 9 * CW;
      const int tap = dv.tap(r);
      const int c0 = (r - tap * CW) * 4;
      uint32_t v = 0;
      if (n < ctv && c0 < C)
        v = expand<WB, true>(raw_bytes(raw_w, ow + n * wrow + (tap * C + c0) * WB / 8,
                                       (min(4, C - c0) * WB + 7) / 8));
      *reinterpret_cast<uint32_t*>(ws + n * L.WST + 4 * r) = v;
    }
  }
  for (int r = 0; r < 3; ++r) unpack_row(raw_x + r * L.RAWX, ox[r], h0 - 1 + r);
  __syncthreads();
  int rqr[RQ_MAX];  // the requant vector's head (all that y <= 4 reads), in registers
#pragma unroll
  for (int i = 0; i < RQ_MAX; ++i) rqr[i] = rq[i];

  const int ry = 8 / y_bits;
  const long long orow = Cout / ry;  // packed bytes an ofmap pixel
  const int mts = L.WS / 16;         // m16 tiles of the segment
  const int ngr = CT / (8 * NTW);    // n groups of the tile
  for (int h = h0; h < h1; ++h) {
    // input row h + 2's packed bytes (output row h + 1's last input row), in
    // flight during row h's products
    const bool next = h + 1 < h1;
    const int op = next ? copy_row(pre, h + 2) : 0;
    mma_pipe::cp_commit();
    for (int item = warp; item < mts * ngr; item += WARPS) {
      const int mt = item % mts;
      const int ng = item / mts;
      const int p0 = mt * 16;
      int acc[4][4] = {};
      const uint8_t* rows[3] = {slot(h - 1), slot(h), slot(h + 1)};
      for (int ch = 0; ch < L.nc; ++ch) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          const uint8_t* xr = rows[dy] + (p0 + g + dx) * L.PX + ch * 32 + 8 * t;
          const uint8_t* wr = ws + (ng * 8 * NTW + g) * L.WST + tap * L.Cp + ch * 32 + 8 * t;
          const uint2 lo = *reinterpret_cast<const uint2*>(xr);
          const uint2 hi = *reinterpret_cast<const uint2*>(xr + 8 * L.PX);
          const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < NTW) {
              const uint2 b = *reinterpret_cast<const uint2*>(wr + j * 8 * L.WST);
              mma_pipe::mma_i8<XU8>(acc[j], a, b.x, b.y);
            }
          }
        }
      }
      // epilogue: the warp's 16 x 8 NTW int32 tile through its scratch, then
      // whole packed bytes a lane
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < NTW) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            scr[(g + 8 * (e >> 1)) * L.ES + 8 * j + 2 * t + (e & 1)] = acc[j][e];
        }
      }
      __syncwarp();
      int8_t* dst = out + ((long long)h * W + w0 + p0) * orow + (n0 + ng * 8 * NTW) / ry;
      const int npx = min(16, W - w0 - p0);
      const int nby = min(8 * NTW, Cout - n0 - ng * 8 * NTW) / ry;
      switch (y_bits) {  // each width with its thresholds in registers
        case 8:
          emit<8, NTW>(scr, L.ES, rqr, dst, orow, npx, nby, lane);
          break;
        case 4:
          emit<4, NTW>(scr, L.ES, rqr, dst, orow, npx, nby, lane);
          break;
        default:
          emit<2, NTW>(scr, L.ES, rqr, dst, orow, npx, nby, lane);
      }
      __syncwarp();
    }
    mma_pipe::cp_wait<0>();
    __syncthreads();  // every warp is done with row h - 1's slot; row h + 2's bytes are in
    if (next) {
      unpack_row(pre, op, h + 2);
      __syncthreads();
    }
  }
}

// The launch configuration: the Cout tile, the segment width (both so that
// the block's shared memory fits), the segments a row and the rows a block.
struct Plan {
  int ct, ws, nseg, nct, rpb, bands, smem;
};

template <int XB, int WB>
Plan plan(int H, int W, int C, int Cout) {
  Plan p{};
  const int cts[3] = {64, 32, 16};  // the Cout tiles, widest first
  for (int k = 0; k < 3; ++k) {
    const int ct = cts[k];
    int wseg = min((W + 15) / 16 * 16, WS_MAX);
    while (wseg > 16 && Layout(C, wseg, ct, XB, WB).bytes > mma_pipe::MAX_SMEM) wseg -= 16;
    const int bytes = Layout(C, wseg, ct, XB, WB).bytes;
    if (bytes > mma_pipe::MAX_SMEM) continue;
    const int nseg = (W + wseg - 1) / wseg;
    const int nct = (Cout + ct - 1) / ct;
    p = Plan{ct, wseg, nseg, nct, 1, 0, bytes};
    if (H * nseg * nct >= MIN_BLOCKS) break;  // else try a narrower tile
  }
  if (p.ct == 0) return p;
  const int per_band = p.nseg * p.nct;
  const int bands = max(1, min(H, ROW_BLOCKS / per_band));
  p.rpb = (H + bands - 1) / bands;
  p.bands = (H + p.rpb - 1) / p.rpb;
  return p;
}

template <int XB, int WB, int CT>
int launch(const Plan& p, const void* x, const void* w, const void* rqv, void* out, int H, int W,
           int C, int Cout, int y_bits, cudaStream_t stream) {
  auto kernel = conv2d_kernel<XB, WB, CT>;
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (p.smem > opted) {
    const cudaError_t e = mma_pipe::allow_smem(kernel, p.smem);
    if (e != cudaSuccess) return (int)e;
    opted = p.smem;
  }
  const Layout L(C, p.ws, CT, XB, WB);
  const Divs dv{Div::of(9 * L.Cp / 4), Div::of(L.Cp / 4), Div::of(L.PX / 4)};
  kernel<<<p.bands * p.nseg * p.nct, THREADS, p.smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const int*>(rqv), static_cast<int8_t*>(out), H, W, C, Cout, y_bits, p.ws,
      p.nseg, p.nct, p.rpb, dv);
  return (int)cudaGetLastError();
}

template <int XB, int WB>
int launch_ct(const void* x, const void* w, const void* rqv, void* out, int H, int W, int C,
              int Cout, int y_bits, cudaStream_t stream) {
  const Plan p = plan<XB, WB>(H, W, C, Cout);
  switch (p.ct) {
    case 64:
      return launch<XB, WB, 64>(p, x, w, rqv, out, H, W, C, Cout, y_bits, stream);
    case 32:
      return launch<XB, WB, 32>(p, x, w, rqv, out, H, W, C, Cout, y_bits, stream);
    case 16:
      return launch<XB, WB, 16>(p, x, w, rqv, out, H, W, C, Cout, y_bits, stream);
    default:
      return (int)cudaErrorInvalidValue;  // no tile fits the block's shared memory
  }
}

}  // namespace

// x (H, W, C * x_bits / 8) and w (Cout, 9C * w_bits / 8) packed int8, unpadded;
// rqv int32 [shift, bias, thresholds...]; out (H, W, Cout * y_bits / 8) int8.
// Any alignment. Returns the launch's cudaError_t, or cudaErrorInvalidValue
// for bits it does not take or a C too wide for any tile.
extern "C" int conv2d_launch(const void* x, const void* w, const void* rqv, void* out, int H,
                             int W, int C, int Cout, int x_bits, int w_bits, int y_bits,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_bits != 8 && y_bits != 4 && y_bits != 2) return (int)cudaErrorInvalidValue;
  if (H < 1 || W < 1 || C < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
#define CONV_CASE(XB, WB) \
  case XB * 16 + WB:      \
    return launch_ct<XB, WB>(x, w, rqv, out, H, W, C, Cout, y_bits, s);
  switch (x_bits * 16 + w_bits) {
    CONV_CASE(8, 8) CONV_CASE(8, 4) CONV_CASE(8, 2)
    CONV_CASE(4, 8) CONV_CASE(4, 4) CONV_CASE(4, 2)
    CONV_CASE(2, 8) CONV_CASE(2, 4) CONV_CASE(2, 2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CONV_CASE
}
