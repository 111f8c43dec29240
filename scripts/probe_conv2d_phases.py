#!/usr/bin/env python3
"""Where a block of the Reference-Layer conv2d kernel spends its time, on one GPU.

Run from the repository root:

    python3 scripts/probe_conv2d_phases.py [--source path/to/conv2d.cu]

First it prints chip_smoke.py phase 7's Reference-Layer rows
(``chip_smoke.reference_layer_rows``: qntpack and conv2d per call beside
their bound, plain version and library call). Then it builds a copy of the
conv2d source (``src/repro_torch/csrc/conv2d.cu``, or ``--source``: e.g. a
parent tree's, unpacked with ``git archive``) under ``build/probe_conv2d/``
with ``clock64()`` stamps between the kernel's phases (thread 0 of every
block, after a barrier) and ``%globaltimer`` at each block's start and end,
read back with ``cudaMemcpyFromSymbol``, and runs the quickstart's cell
(8, 4, 4) at the paper's shape (16 x 16, 32 -> 64) and at 224 x 224 over
fresh operands: for each shape, the mean cycles a block spends in each
phase (median over the last calls), the span of the grid and the card's SM
clock. The stamps add barriers and stores, so the total runs a little above
the kernel's own time. Each of the two kernel designs has its own phases
and insertion points, matched in the source text and asserted: a change to
the kernel may need them updated.

  * the first design (one block per output row and 64 output channels,
    ``__dp4a``): staging of the three input rows, staging of the weights
    (one field a byte), the weight sums of the offset fold, and the loop
    over (pixel, 4 channels) split by thread 0's clock into its products
    and its epilogue (requant, pack, store);
  * the implicit GEMM (``mma.sync``): the weights' unpack, the staging of
    the input rows (three, then one a row), the products and the epilogue,
    summed over the block's rows; and a sweep of the launcher's
    ``ROW_BLOCKS`` (blocks a grid aims at) and of the Cout tile at both
    shapes, each variant built from a copy of the source with the constant
    replaced, timed with ``chip_smoke.device_ms`` (torch.profiler, device
    time a call over CALLS launches).
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

BLOCKS, SLOTS = 1024, 12  # stamp rows (blocks), stamps a block
CALLS = 12  # fresh operand sets a shape; the first two are warm-up


def clock(k: int, add: bool = False) -> str:
    op = "+=" if add else "="
    return f"  if (threadIdx.x == 0) g_stamp[blockIdx.x][{k}] {op} clock64();\n"


def gtime(k: int) -> str:
    return ("  if (threadIdx.x == 0) { unsigned long long t; asm volatile(\"mov.u64 %0, "
            f"%%globaltimer;\" : \"=l\"(t)); g_stamp[blockIdx.x][{k}] = t; }}\n")


class Source:
    """A kernel source with text inserted at anchors that must occur once."""

    def __init__(self, text: str):
        self.text = text

    def at(self, anchor: str, text: str, after: bool = True) -> None:
        if self.text.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        self.text = self.text.replace(anchor, anchor + text if after else text + anchor)


def readback() -> str:
    return ('\nextern "C" int probe_read(void* dst) {\n'
            "  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));\n}\n"
            'extern "C" int probe_clear() {\n'
            f"  static unsigned long long z[{BLOCKS}][{SLOTS}];\n"
            "  return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));\n}\n")


# ------------------------------------------------------------ first design
#: stamps 0..4 at phase ends (clock), 5 / 6 thread 0's cycles in products /
#: epilogue, 8 / 10 the block's start / end (globaltimer), 9 = 1 (ran)
FIRST_PHASES = ("rows", "weights", "wsum", "products", "epilogue")


def first_stamped(src: str) -> str:
    s = Source(src)
    s.at('#include "quant.cuh"\n', f"__device__ unsigned long long g_stamp[{BLOCKS}][{SLOTS}];\n")
    s.at("  constexpr int OFF = (XB == 8) ? 128 : 0;        // u8 offset fold\n",
         gtime(8) + clock(0))
    s.at("    xs[i] = (int8_t)v;\n  }\n", "  __syncthreads();\n" + clock(1))
    s.at("    ws[i] = (int8_t)v;\n  }\n  __syncthreads();\n", clock(2))
    s.at("    wsum[n] = s;\n  }\n  __syncthreads();\n",
         clock(3) + "  long long t_prod = 0, t_epi = 0;\n")
    s.at("    int acc[CPT];\n", "    const long long t0 = clock64();\n", after=False)
    s.at("    int q[CPT];\n", "    const long long t1 = clock64();\n    t_prod += t1 - t0;\n",
         after=False)
    store = "      dst[nb / ry] = pack_byte(&q[b * ry], y_bits);\n    }\n"
    s.at(store, "    t_epi += clock64() - t1;\n")
    end = store + "    t_epi += clock64() - t1;\n  }\n"
    s.at(end, "  __syncthreads();\n" + clock(4) + gtime(10)
         + "  if (threadIdx.x == 0) { g_stamp[blockIdx.x][5] = t_prod; "
           "g_stamp[blockIdx.x][6] = t_epi; g_stamp[blockIdx.x][9] = 1; }\n")
    return s.text + readback()


def first_args(x_p, w_p, rqv, out, H, W, C, Cout, bits):
    cp = -(-C // 4) * 4
    cp = cp + 4 if (cp // 4) % 2 == 0 else cp  # the first design's staged width
    return (x_p.data_ptr(), w_p.data_ptr(), rqv.data_ptr(), out.data_ptr(), H, W, C, cp, Cout,
            *bits)


FIRST_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def first_phases(row) -> list[float]:
    """Cycles of each phase from one block's stamps: the loop's time split
    by thread 0's own products / epilogue ratio."""
    loop = row[4] - row[3]
    share = row[5] / max(1, row[5] + row[6])
    return [row[1] - row[0], row[2] - row[1], row[3] - row[2], loop * share, loop * (1 - share)]


# --------------------------------------------------------- implicit GEMM
#: stamps 0 at the block's start, 7 when the first staging's packed bytes
#: have landed, 1 after their unpack, 2 at its end (clock); 3, 4, 5 thread 0's
#: cycles in the later rows' staging (the wait for the next row's bytes, the
#: barrier, the unpack), in products and in epilogues; 8 / 10 globaltimer,
#: 9 = 1 (ran)
IGEMM_PHASES = ("first copies", "first unpack", "later rows", "products", "epilogue", "waits")


def igemm_stamped(src: str) -> str:
    s = Source(src)
    s.at('#include "quant.cuh"\n', f"__device__ unsigned long long g_stamp[{BLOCKS}][{SLOTS}];\n")
    s.at("  const int t = lane & 3;\n", gtime(8) + clock(0)
         + "  long long t_rows = 0, t_prod = 0, t_epi = 0;\n")
    s.at("  // the weight tile; where C is a multiple of 32", clock(7), after=False)
    s.at("  int rqr[RQ_MAX];", clock(1), after=False)  # right after the unpack's barrier
    s.at("    mma_pipe::cp_wait<0>();\n    __syncthreads();  // every warp is done",
         "    const long long tr0 = clock64();\n", after=False)
    end = "      unpack_row(pre, op, h + 2);\n      __syncthreads();\n    }\n"
    s.at(end, "    t_rows += clock64() - tr0;\n")
    s.at("      int acc[4][4] = {};\n", "      const long long tp0 = clock64();\n", after=False)
    s.at("      // epilogue: the warp's", "      const long long tp1 = clock64();\n"
         "      t_prod += tp1 - tp0;\n", after=False)
    s.at("          emit<2, NTW>(scr, L.ES, rqr, dst, orow, npx, nby, lane);\n      }\n"
         "      __syncwarp();\n", "      t_epi += clock64() - tp1;\n")
    s.at(end + "    t_rows += clock64() - tr0;\n  }\n", clock(2) + gtime(10)
         + "  if (threadIdx.x == 0) { g_stamp[blockIdx.x][3] = t_rows; g_stamp[blockIdx.x][4] = "
           "t_prod; g_stamp[blockIdx.x][5] = t_epi; g_stamp[blockIdx.x][9] = 1; }\n")
    return s.text + readback()


def igemm_args(x_p, w_p, rqv, out, H, W, C, Cout, bits):
    return (x_p.data_ptr(), w_p.data_ptr(), rqv.data_ptr(), out.data_ptr(), H, W, C, Cout, *bits)


IGEMM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def igemm_phases(row) -> list[float]:
    compute = row[2] - row[1] - row[3]
    return [row[7] - row[0], row[1] - row[7], row[3], row[4], row[5],
            compute - row[4] - row[5]]


DESIGNS = {"first": (first_stamped, first_args, FIRST_ARGTYPES, FIRST_PHASES, first_phases),
           "igemm": (igemm_stamped, igemm_args, IGEMM_ARGTYPES, IGEMM_PHASES, igemm_phases)}


def design_of(src: str) -> str:
    return "igemm" if "mma_i8" in src else "first"


# ----------------------------------------------------------------- sweep
#: (Cout tile, 0 = the launcher's pick; ROW_BLOCKS) variants of the sweep,
#: built for the quickstart's cell (8, 4, 4) only
SWEEP = [(ct, rb) for ct in (0, 16, 32, 64) for rb in (132, 264, 528)]


def variant_source(src: str, ct: int, rb: int) -> str:
    """The source with ROW_BLOCKS = rb, the launcher's Cout tiles all ct
    (unless ct is 0) and only the cell (8, 4) in its switch."""
    tiles = f"{{{ct}, {ct}, {ct}}}" if ct else "{64, 32, 16}"
    out, n = re.subn(r"const int cts\[3\] = \{64, 32, 16\};", f"const int cts[3] = {tiles};",
                     src)
    out, m = re.subn(r"^constexpr int ROW_BLOCKS = \d+;", f"constexpr int ROW_BLOCKS = {rb};",
                     out, flags=re.M)
    out, k = re.subn(r"^    CONV_CASE\(8, 8\)[^\n]*\n    CONV_CASE\(4, 8\)[^\n]*\n"
                     r"    CONV_CASE\(2, 8\)[^\n]*\n", "    CONV_CASE(8, 4)\n", out, flags=re.M)
    if (n, m, k) != (1, 1, 1):
        raise RuntimeError("conv2d.cu: the Cout tiles, ROW_BLOCKS or the cell switch not found")
    return out


def sweep(torch, cs, src: str, shapes) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.mpmm import requant_vector
    from repro_torch.kernels.ref import conv2d_ref

    root = ROOT / "build" / "probe_conv2d" / "sweep"
    procs = {}
    for ct, rb in SWEEP:
        d = root / f"ct{ct}_rb{rb}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "conv2d.cu").write_text(variant_source(src, ct, rb))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(d / "lib.so"), str(d / "conv2d.cu")]
        procs[(ct, rb)] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        fn = ctypes.CDLL(str(d / "lib.so")).conv2d_launch
        fn.argtypes, fn.restype = IGEMM_ARGTYPES, ctypes.c_int
        fns[key] = fn
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(27)
    bits = (8, 4, 4)
    for H, W, C, Cout in shapes:
        x_p, w_p, rq = cs.conv_operands(torch, g, dev, H, W, C, Cout, *bits)
        rqv = requant_vector(rq).to(dev)
        want = conv2d_ref(x_p, w_p, rq, x_bits=8, w_bits=4, y_bits=4)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream
        times = {key: [] for key in fns}
        for key, fn in fns.items():
            out.zero_()
            build.check(fn(*igemm_args(x_p, w_p, rqv, out, H, W, C, Cout, bits), stream), str(key))
            if not torch.equal(out, want):
                raise AssertionError(f"sweep variant {key} differs from conv2d_ref at {H}x{W}")
        for _ in range(2):
            for key, fn in fns.items():
                args = (*igemm_args(x_p, w_p, rqv, out, H, W, C, Cout, bits), stream)
                call = lambda fn=fn, args=args: [fn(*args) for _ in range(cs.CALLS)]  # noqa: E731
                times[key].append(cs.device_ms(call)[0] / cs.CALLS)
        for (ct, rb), ts in times.items():
            print(f"sweep (8, 4, 4) at {H}x{W}: CT {'auto' if ct == 0 else ct:>4}, ROW_BLOCKS "
                  f"{rb:3d}: {statistics.median(ts) * 1e3:.2f} us a call (rounds "
                  f"{', '.join(f'{t * 1e3:.2f}' for t in ts)})", flush=True)


def build_lib(d: pathlib.Path, name: str, text: str):
    from repro_torch.kernels import build

    (d / f"{name}.cu").write_text(text)
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                        str(d / f"lib{name}.so"), str(d / f"{name}.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}\n{r.stderr}")
    return ctypes.CDLL(str(d / f"lib{name}.so"))


def probe(torch, cs, lib, design: str, shapes) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.mpmm import requant_vector
    from repro_torch.kernels.ref import conv2d_ref

    _, args_of, argtypes, names, phases_of = DESIGNS[design]
    fn = lib.conv2d_launch
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(26)
    bits = (8, 4, 4)
    for H, W, C, Cout in shapes:
        phases, spans, nblk = [], [], 0
        for _ in range(CALLS):
            x_p, w_p, rq = cs.conv_operands(torch, g, dev, H, W, C, Cout, *bits)
            rqv = requant_vector(rq).to(dev)
            out = torch.empty((H, W, Cout // 2), dtype=torch.int8, device=dev)
            torch.cuda.synchronize()
            lib.probe_clear()
            err = fn(*args_of(x_p, w_p, rqv, out, H, W, C, Cout, bits),
                     torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            build.check(err, "conv2d_launch (stamped)")
            want = conv2d_ref(x_p, w_p, rq, x_bits=bits[0], w_bits=bits[1], y_bits=bits[2])
            if not torch.equal(out, want):
                raise AssertionError(f"stamped conv2d differs from conv2d_ref at {H}x{W}")
            st = (ctypes.c_ulonglong * (BLOCKS * SLOTS))()
            lib.probe_read(st)
            rows = [[st[b * SLOTS + k] for k in range(SLOTS)] for b in range(BLOCKS)]
            act = [row for row in rows if row[9] > 0]
            nblk = len(act)
            phases.append([statistics.mean(x) for x in zip(*(phases_of(r) for r in act))])
            spans.append((max(r[10] for r in act) - min(r[8] for r in act)) / 1e3)
        ph = [statistics.median(x[k] for x in phases[2:]) for k in range(len(names))]
        clk = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(f"conv2d ({design} design) (8, 4, 4) at {H}x{W}, {C} -> {Cout}, {nblk} blocks: "
              f"cycles a block (mean over blocks, median over calls): "
              + ", ".join(f"{n} {v:.0f}" for n, v in zip(names, ph))
              + f"; total {sum(ph):.0f}; grid span {statistics.median(spans[2:]):.2f} us; "
              + clk.strip(), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=pathlib.Path, default=None,
                    help="the conv2d.cu to probe (default: this tree's)")
    ap.add_argument("--no-rows", action="store_true", help="skip phase 7's rows")
    ap.add_argument("--no-sweep", action="store_true", help="skip the implicit GEMM's sweep")
    a = ap.parse_args()
    import chip_smoke as cs
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    print(cs.gpu_line(), flush=True)
    if not a.no_rows:
        build.ensure_built()
        for r in cs.reference_layer_rows(torch, dev, torch.Generator(device=dev).manual_seed(3)):
            print(f"  row {r['name']}: {r['ms']:.6f} ms, plain {r['plain_ms']:.6f}, library "
                  f"{r['library_ms']:.6f}", flush=True)
    src = (a.source or build.CSRC / "conv2d.cu").read_text()
    design = design_of(src)
    d = ROOT / "build" / "probe_conv2d"
    d.mkdir(parents=True, exist_ok=True)
    lib = build_lib(d, "stamped", DESIGNS[design][0](src))
    paper = cs.ref_layer()
    shapes = (paper, (224, 224, *paper[2:]))
    probe(torch, cs, lib, design, shapes)
    if design == "igemm" and not a.no_sweep:
        sweep(torch, cs, src, shapes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
