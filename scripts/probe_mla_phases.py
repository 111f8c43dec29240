#!/usr/bin/env python3
"""Where a block of paged_mla_attn's split pass spends its time, on one GPU.

Run from the repository root:  python3 scripts/probe_mla_phases.py

Builds a copy of ``csrc/paged_mla_attn.cu`` under ``build/probe_mla/`` with a
``clock64()`` stamp after each of the split kernel's phases (thread 0 of
every block, after the phase's ``__syncthreads``; one more barrier before the
last stamp) and ``%globaltimer`` at a block's start and end, read back with
``cudaMemcpyFromSymbol``. Then it runs the kv8 call of a DeepSeek-V3 decode
step (4 slots at 159..543 cached rows, H 128, C 512, dr 64, pages of 16)
over 12 fresh pools and prints, for the blocks that hold a visible key, the
mean cycles of each phase (median over the last 10 calls): the table reads
(pos / bt), staging and the queries, dequantization, scores, softmax,
context and the partial's stores; then the span of the grid and the card's
SM clock. The stamps add a barrier and a few stores, so the total runs a
little above the kernel's own time. The insertion points are matched in the
source text and asserted: a change to the kernel may need them updated.
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = ("pos/bt", "stage+q", "dequant", "scores", "softmax", "context", "stores")
BLOCKS, SLOTS = 1024, 12  # stamp rows (blocks), stamps a block


def stamped_source(src: str) -> str:
    def at(anchor: str, text: str, after: bool = True) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    def clock(k: int) -> str:
        return f"  if (threadIdx.x == 0) g_stamp[blockIdx.x][{k}] = clock64();\n"

    def gtime(k: int) -> str:
        return ("  if (threadIdx.x == 0) { unsigned long long t; asm volatile(\"mov.u64 %0, "
                f"%%globaltimer;\" : \"=l\"(t)); g_stamp[blockIdx.x][{k}] = t; }}\n")

    at('#include "paged_split.cuh"\n',
       f"__device__ unsigned long long g_stamp[{BLOCKS}][{SLOTS}];\n")
    at("  const int warp = tid >> 5;\n", gtime(8) + clock(0))
    at("  const int RA = npg * L.PR;  // rows the products take\n  __syncthreads();\n", clock(1))
    at("  asm volatile(\"cp.async.wait_group 0;\\n\" ::);\n  __syncthreads();\n", clock(2))
    at("\n  const int g = lane >> 2;", clock(3), after=False)
    at("  }\n  __syncthreads();\n\n  // running softmax", "", after=False)
    src = src.replace("  }\n  __syncthreads();\n\n  // running softmax",
                      "  }\n  __syncthreads();\n" + clock(4) + "\n  // running softmax")
    at("\n  // the partial's (m, l)", clock(5), after=False)
    at("  float* ot = reinterpret_cast<float*>(smem + L.q);\n", clock(6), after=False)
    end = "      pm[i] = ot[hh * OLD + i - hh * C];\n    }\n  }\n}"
    at(end, "", after=False)
    src = src.replace(end, end[:-1] + "  __syncthreads();\n" + clock(7) + gtime(10)
                      + "  if (tid == 0) g_stamp[blockIdx.x][9] = npg;\n}")
    return src + (
        '\nextern "C" int probe_read(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));\n}\n"
        'extern "C" int probe_clear() {\n'
        f"  static unsigned long long z[{BLOCKS}][{SLOTS}];\n"
        "  return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));\n}\n")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attn import (
        _BITS_CODE,
        _MLA_ARGTYPES,
        MLA_HEADS_PER_BLOCK,
        MLA_PAGES_PER_SPLIT,
    )

    d = ROOT / "build" / "probe_mla"
    d.mkdir(parents=True, exist_ok=True)
    (d / "paged_mla_attn.cu").write_text(stamped_source((build.CSRC / "paged_mla_attn.cu")
                                                        .read_text()))
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                        str(d / "lib.so"), str(d / "paged_mla_attn.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout, r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = lib.paged_mla_attn_launch
    fn.argtypes, fn.restype = _MLA_ARGTYPES, ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda", 0)
    mcfg = configs.get_arch(cs.MLA_ARCH)
    scale = 1.0 / (mcfg.d_nope + mcfg.d_rope) ** 0.5
    g = torch.Generator(device=dev).manual_seed(1)
    hb, pps = MLA_HEADS_PER_BLOCK, MLA_PAGES_PER_SPLIT
    phases, spans = [], []
    for _ in range(12):
        ql, qr, c, s_, r_, pos, bt = cs.mla_case(torch, dev, mcfg, 8, g)
        B, H, C = ql.shape
        nb = bt.shape[1]
        out = torch.empty((B, H, C), device=dev)
        part = torch.empty(B * -(-H // hb) * -(-nb // pps) * hb * (C + 2), device=dev)
        torch.cuda.synchronize()
        lib.probe_clear()
        err = fn(ql.data_ptr(), qr.data_ptr(), c.data_ptr(), s_.data_ptr(), r_.data_ptr(),
                 pos.data_ptr(), bt.data_ptr(), out.data_ptr(), part.data_ptr(), B, H, C,
                 qr.shape[-1], c.shape[1], nb, _BITS_CODE[8], 16, float(scale),
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        build.check(err, "paged_mla_attn_launch (stamped)")
        st = (ctypes.c_ulonglong * (BLOCKS * SLOTS))()
        lib.probe_read(st)
        rows = [[st[b * SLOTS + k] for k in range(SLOTS)] for b in range(BLOCKS)]
        act = [row for row in rows if row[9] > 0]
        phases.append([statistics.mean(row[k + 1] - row[k] for row in act) for k in range(7)])
        spans.append((max(row[10] for row in act) - min(row[8] for row in rows if row[8])) / 1e3)
    ph = [statistics.median(x[k] for x in phases[2:]) for k in range(7)]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"paged_mla_attn split pass, kv8, HB={hb} PPS={pps}, {len(act)} blocks with a "
          f"visible key: cycles a block (mean over blocks, median over calls): "
          + ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, ph))
          + f"; total {sum(ph):.0f}; grid span {statistics.median(spans[2:]):.2f} us; "
          + clock.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
