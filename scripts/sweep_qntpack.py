#!/usr/bin/env python3
"""Sweep the qntpack kernel's block shape on one NVIDIA GPU.

Run from the repository root:  python3 scripts/sweep_qntpack.py

``csrc/qntpack.cu`` fixes two constants: ``THREADS``, the threads of a
block, and ``WORDS``, the 32-bit words of packed output a thread makes
(every load of all its words in flight before its first requant). This
script builds the source once for each (THREADS, WORDS) in GRID (the
constants rewritten in a copy under ``build/sweep_qntpack/``, every nvcc
started together), holds each variant bit for bit against the plain version
(y = 8, 4, 2 at Tab. 1's (256, 64), at a ragged (37, 3 ry) and with phi
off the 16-byte grid), and times each through the shipped wrapper at y = 4
at Tab. 1's shape and at the 224 x 224 Reference Layer's accumulators
(50176, 64), and at y = 8 and 2 at the latter: the kernel's device time a
call (``chip_smoke.device_ms``, CALLS calls a window), the variants in
turns, ``ROUNDS`` times, the median kept. Prints a table and writes it to
``build/sweep_qntpack/sweep_qntpack.json``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: (THREADS, WORDS) variants, the shipped one first
GRID = [(256, 1), (128, 1), (512, 1), (256, 2), (128, 2), (128, 4), (256, 4)]
ROUNDS = 3
CALLS = 50
#: (y_bits, (M, N)) timed
CASES = [(4, (256, 64)), (4, (50176, 64)), (8, (50176, 64)), (2, (50176, 64))]


def variant_source(src: str, threads: int, words: int) -> str:
    out, n = re.subn(r"^constexpr int THREADS = \d+;", f"constexpr int THREADS = {threads};",
                     src, flags=re.M)
    out, m = re.subn(r"^constexpr int WORDS = \d+;", f"constexpr int WORDS = {words};", out,
                     flags=re.M)
    if (n, m) != (1, 1):
        raise RuntimeError("THREADS or WORDS not found")
    return out


def build_variants(build) -> dict:
    from repro_torch.kernels import qntpack as QK

    root = ROOT / "build" / "sweep_qntpack"
    src = (build.CSRC / "qntpack.cu").read_text()
    procs = {}
    t0 = time.perf_counter()
    for threads, words in GRID:
        d = root / f"t{threads}_w{words}"
        d.mkdir(parents=True, exist_ok=True)
        cu = d / "qntpack.cu"
        cu.write_text(variant_source(src, threads, words))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(d / "lib.so"), str(cu)]
        procs[threads, words] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (d, proc) in procs.items():
        log_text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log_text}")
        regs = re.findall(r"Used (\d+) registers", log_text)
        spills = re.findall(r"(\d+) bytes spill stores", log_text)
        print(f"built {key}: registers {regs}, spill stores {sorted(set(spills))}", flush=True)
        fn = ctypes.CDLL(str(d / "lib.so")).qntpack_launch
        fn.argtypes, fn.restype = QK._ARGTYPES, ctypes.c_int
        fns[key] = fn
    print(f"built {len(procs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    return fns


def caller(fn):
    """``qntpack_cuda`` with the variant's entry point in place of the
    shipped one."""
    from repro_torch.kernels import build
    from repro_torch.kernels.qntpack import qntpack_cuda

    def call(phi, rqv, y_bits):
        saved = build._ENTRIES.get(("qntpack", "qntpack_launch"))
        build._ENTRIES["qntpack", "qntpack_launch"] = fn
        try:
            return qntpack_cuda(phi, rqv, y_bits=y_bits)
        finally:
            build._ENTRIES["qntpack", "qntpack_launch"] = saved

    return call


def operands(torch, g, dev, y_bits, shape):
    from repro_torch.core import quant as Q

    phi = torch.randint(-(1 << 20), 1 << 20, shape, generator=g, device=dev, dtype=torch.int32)
    phi[0] = (1 << 31) - 1 - torch.arange(shape[1], dtype=torch.int32, device=dev)
    rq = Q.make_requant_params(y_bits=y_bits, eps_phi=(1 << y_bits) / 2.0**21, eps_y=1.0,
                               lam=float(1 << 20))
    return phi, rq


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.mpmm import requant_vector
    from repro_torch.kernels.ref import qntpack_ref

    dev = torch.device("cuda", 0)
    print(cs.gpu_line(), flush=True)
    build.ensure_built()
    calls = {key: caller(fn) for key, fn in build_variants(build).items()}
    g = torch.Generator(device=dev).manual_seed(0)
    for y_bits in (8, 4, 2):
        for shape in ((256, 64), (37, 3 * (8 // y_bits))):
            phi, rq = operands(torch, g, dev, y_bits, shape)
            flat = torch.empty(phi.numel() + 1, dtype=torch.int32, device=dev)
            flat[1:].copy_(phi.reshape(-1))
            want = qntpack_ref(phi, rq, y_bits=y_bits)
            for key, call in calls.items():
                for x in (phi, flat[1:].view(shape)):
                    if not torch.equal(call(x, requant_vector(rq), y_bits), want):
                        raise AssertionError(f"variant {key} differs at y={y_bits} {shape}")
    print("every variant bit-exact with the plain version", flush=True)
    cases = []
    for y_bits, shape in CASES:
        phi, rq = operands(torch, g, dev, y_bits, shape)
        cases.append((y_bits, shape, phi, requant_vector(rq)))
    times = {(key, c[:2]): [] for key in calls for c in cases}
    for _ in range(ROUNDS):
        for key, call in calls.items():
            for y_bits, shape, phi, rqv in cases:
                t, _, _ = cs.device_ms(lambda: [call(phi, rqv, y_bits) for _ in range(CALLS)],
                                       names=("qntpack_kernel",))
                times[key, (y_bits, shape)].append(t / CALLS * 1e3)
    rows = []
    for key in calls:
        row = {"threads": key[0], "words": key[1]}
        for y_bits, shape, phi, _ in cases:
            us = statistics.median(times[key, (y_bits, shape)])
            nbytes = phi.numel() * 4 + phi.numel() * y_bits // 8
            row[f"y{y_bits} {shape[0]}x{shape[1]} us"] = us
            row[f"y{y_bits} {shape[0]}x{shape[1]} of bound"] = nbytes / cs.HBM_BYTES_PER_S * 1e6 / us
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = ROOT / "build" / "sweep_qntpack" / "sweep_qntpack.json"
    out.write_text(json.dumps({"gpu": cs.gpu_line(), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
