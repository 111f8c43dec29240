#!/usr/bin/env python3
"""Where a block of qkv_decode's split pass spends its time, on one GPU.

Run from the repository root:  python3 scripts/probe_qkv_phases.py

Builds a copy of ``csrc/qkv_decode.cu`` under ``build/probe_qkv/`` with a
``clock64()`` stamp after each of the split kernel's phases (thread 0 of
every block, after the phase's barrier; one more barrier before the last
stamp) and ``%globaltimer`` at a block's start and end, read back with
``cudaMemcpyFromSymbol``. Then it runs chip_smoke.py phase 12's call (B 4,
S 1024, 16 / 8 heads, D 128, kv8 and kv4, pos 1023 and 511) over 12 fresh
caches and prints, for the blocks that hold a visible key, the mean cycles
of each phase (median over the last 10 calls): K's copies (the query
staged meanwhile), the scores, the softmax with the wait for V's copies,
P . V, the partial's stores; then the span of the grid and the card's SM
clock. The stamps add a barrier and a few stores. The insertion points are
matched in the source text and asserted: a change to the kernel may need
them updated.
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = ("K copies", "scores", "softmax+V wait", "P . V", "stores")
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
    at("  asm volatile(\"cp.async.wait_group 1;\\n\" ::);  // K's group has landed\n"
       "  __syncthreads();\n", clock(1))
    at("\n  // softmax over the split", clock(2), after=False)
    at("  asm volatile(\"cp.async.wait_group 0;\\n\" ::);  // V's group has landed too\n"
       "  __syncthreads();\n", clock(3))
    at("      if (two) r[D + e] = a1[e];\n    }\n  }\n  __syncthreads();\n", clock(4))
    at("  for (int i = tid; i < 2 * G; i += THREADS) pm[G * D + i] = ml[i];\n",
       "  __syncthreads();\n" + clock(5) + gtime(10)
       + "  if (threadIdx.x == 0) g_stamp[blockIdx.x][9] = 1;\n")
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
    from repro_torch.kernels import qkv_decode as QD

    d = ROOT / "build" / "probe_qkv"
    d.mkdir(parents=True, exist_ok=True)
    (d / "qkv_decode.cu").write_text(stamped_source((build.CSRC / "qkv_decode.cu").read_text()))
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                        str(d / "lib.so"), str(d / "qkv_decode.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout, r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = lib.qkv_decode_launch
    fn.argtypes, fn.restype = QD._ARGTYPES, ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda", 0)
    cfg = configs.get_arch("internlm2-1.8b")
    B, S, Hq, Hkv, D = cs.N_SLOTS, cs.S_MAX, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 15)
    clk = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    for bits in (8, 4):
        for pos in (S - 1, S // 2 - 1):
            phases, spans = [], []
            for _ in range(12):
                q, kq, ks, vq, vs = cs.qkv_case(torch, g, dev, B, S, Hq, Hkv, D, bits)
                out = torch.empty((B, Hq, D), device=dev)
                part = torch.empty(B * Hq * -(-S // QD.KEYS_PER_SPLIT) * (D + 2), device=dev)
                torch.cuda.synchronize()
                lib.probe_clear()
                err = fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                         out.data_ptr(), part.data_ptr(), B, Hq, Hkv, S, D, bits, pos,
                         1.0 / D**0.5, torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                build.check(err, "qkv_decode_launch (stamped)")
                st = (ctypes.c_ulonglong * (BLOCKS * SLOTS))()
                lib.probe_read(st)
                rows = [[st[b * SLOTS + k] for k in range(SLOTS)] for b in range(BLOCKS)]
                act = [row for row in rows if row[9] > 0]
                phases.append([statistics.mean(row[k + 1] - row[k] for row in act)
                               for k in range(5)])
                spans.append((max(row[10] for row in act) - min(row[8] for row in act)) / 1e3)
            ph = [statistics.median(x[k] for x in phases[2:]) for k in range(5)]
            print(f"qkv_decode split pass, kv{bits}, pos {pos}, KPS={QD.KEYS_PER_SPLIT}, "
                  f"{len(act)} blocks: cycles a block (mean over blocks, median over calls): "
                  + ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, ph))
                  + f"; total {sum(ph):.0f}; grid span {statistics.median(spans[2:]):.2f} us; "
                  + clk.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
