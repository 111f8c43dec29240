#!/usr/bin/env python3
"""Sweep qkv_decode's keys a split on one NVIDIA GPU.

Run from the repository root:  python3 scripts/sweep_qkv_split.py

``csrc/qkv_decode.cu`` fixes ``KPS``, the keys a block of the split pass
takes before its partial goes to the merge. This script builds the source
once for each KPS in ``GRID`` (the constant rewritten in a copy under
``build/sweep_qkv/``, every nvcc started together), holds each variant
against the plain version (``kernels/qkv_decode.py`` ``TOL``, atol = rtol)
and times each at chip_smoke.py phase 12's shape: B 4, S 1024, 16 / 8
heads, D 128, pos 1023 (and 511), kv8 and kv4, over ``chip_smoke.COLD_STEPS``
distinct caches a window (more bytes than the 50 MB L2 holds). Device time a
call from ``chip_smoke.device_ms`` (torch.profiler: the split pass and the
merge together, and the split pass alone); the variants run in turns, ``ROUNDS`` times, and the
median is kept. Prints a line a variant and the fastest.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

GRID = (32, 64, 128, 256)
ROUNDS = 3


def build_variants(build) -> dict:
    src = (build.CSRC / "qkv_decode.cu").read_text()
    procs = {}
    for kps in GRID:
        d = ROOT / "build" / "sweep_qkv" / f"kps{kps}"
        d.mkdir(parents=True, exist_ok=True)
        text, n = re.subn(r"^constexpr int KPS = \d+;", f"constexpr int KPS = {kps};", src,
                          flags=re.M)
        if n != 1:
            raise RuntimeError("qkv_decode.cu: KPS not found")
        (d / "qkv_decode.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(d / "lib.so"), str(d / "qkv_decode.cu")]
        procs[kps] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    fns = {}
    for kps, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for KPS={kps}:\n{log}")
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
        print(f"built KPS={kps}: registers {regs}", flush=True)
        from repro_torch.kernels.qkv_decode import _ARGTYPES

        fn = ctypes.CDLL(str(d / "lib.so")).qkv_decode_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns[kps] = fn
    return fns


def caller(torch, fn, kps):
    """qkv_decode_cuda's launch through a variant, its scratch sized by KPS."""
    from repro_torch.kernels import build

    def call(q, kq, ks, vq, vs, pos, bits):
        B, Hq, D = q.shape
        S, Hkv = kq.shape[1], kq.shape[2]
        out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
        part = torch.empty(B * Hq * -(-S // kps) * (D + 2), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                 out.data_ptr(), part.data_ptr(), B, Hq, Hkv, S, D, bits, pos, 1.0 / D**0.5,
                 build.stream_ptr(q.device))
        build.check(err, f"qkv_decode variant KPS={kps}")
        return out

    return call


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels import qkv_decode as QD

    dev = torch.device("cuda", 0)
    card = cs.gpu_line()
    print(card, flush=True)
    calls = {kps: caller(torch, fn, kps) for kps, fn in build_variants(build).items()}
    cfg = configs.get_arch("internlm2-1.8b")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 15)
    shape = (cs.N_SLOTS, cs.S_MAX, cfg.n_heads, cfg.kv_heads, cfg.head_dim)
    n = cs.COLD_STEPS
    best = {}
    for bits in (8, 4):
        sets = [cs.qkv_case(torch, g, dev, *shape, bits) for _ in range(n)]
        for pos in (cs.S_MAX - 1, cs.S_MAX // 2 - 1):
            plain = QD.qkv_decode_plain(*sets[0], pos, bits=bits)
            times = {kps: [] for kps in calls}
            parts = {kps: [] for kps in calls}
            for kps, call in calls.items():
                err = (call(*sets[0], pos, bits) - plain).abs()
                if bool((err > QD.TOL * (1 + plain.abs())).any()):
                    raise AssertionError(f"KPS={kps} kv{bits} pos {pos}: max error "
                                         f"{float(err.max())} above TOL")
            for _ in range(ROUNDS):
                for kps, call in calls.items():
                    fn = lambda call=call: [call(*s, pos, bits) for s in sets]  # noqa: E731
                    times[kps].append(cs.device_ms(fn)[0] / n)
                    parts[kps].append(cs.device_ms(fn, names=("qkv_split_kernel",))[0] / n)
            for kps, ts in times.items():
                print(f"kv{bits} pos {pos} KPS={kps:3d}: {statistics.median(ts) * 1e3:.2f} us a "
                      f"call, split pass {statistics.median(parts[kps]) * 1e3:.2f} (rounds "
                      f"{', '.join(f'{t * 1e3:.2f}' for t in ts)})", flush=True)
            best[(bits, pos)] = min(times, key=lambda k: statistics.median(times[k]))
    print(f"fastest KPS: {best} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
