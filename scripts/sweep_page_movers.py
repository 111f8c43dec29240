#!/usr/bin/env python3
"""Sweep the page movers' block shapes on one NVIDIA GPU.

Run from the repository root:  python3 scripts/sweep_page_movers.py

``csrc/paged_scatter.cu`` and ``csrc/paged_gather.cu`` each fix two
constants: ``THREADS``, the threads of a block, and ``UNROLL``, the 16-byte
loads a thread holds in registers before its stores. This script builds
each source once for each (THREADS, UNROLL) in its grid (the constants
rewritten in a copy under ``build/sweep_movers/``, every nvcc started
together), holds each variant bit for bit against the plain version on one
layer's group, and times each on internlm2-1.8b's kv8 decode shapes as the
model calls them: one group a layer (k, k_s, v, v_s), 24 layers each on its
own pool (4 slots, 64 pages of 16 rows each, more bytes than the 50 MB L2
holds); the scatter writes one row a slot, the gather reads every page of
the table. Device time a step from ``chip_smoke.device_ms``
(torch.profiler); the variants run in turns, ``ROUNDS`` times, and the
median is kept. Beside them: one empty kernel's device time (the launch
floor). Then the shipped gather's fixed cost and rate: one group launch of
a kv8 layer's four leaves over 4, 16 and 64 slots' tables, beside one
``Tensor.copy_`` of the same bytes (a contiguous device-to-device copy),
each window over distinct buffers of ``WINDOW_BYTES`` in all. Prints a
table and writes it to ``build/sweep_movers/sweep_page_movers.json``.
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

#: (THREADS, UNROLL) variants of each kernel, the shipped one first
GRID = {"paged_scatter": [(256, 1), (512, 1), (256, 2), (128, 4), (64, 4)],
        "paged_gather": [(64, 4), (32, 4), (64, 2), (64, 8), (128, 4), (256, 4)]}
ROUNDS = 3
#: slots a gather launch reads in the scaling probe (64 pages each)
SCALING_SLOTS = (4, 16, 64)
#: bytes a scaling window moves at least, over distinct buffers (the L2 holds 50 MB)
WINDOW_BYTES = 256 << 20


def variant_source(src: str, threads: int, unroll: int) -> str:
    out, n = re.subn(r"^constexpr int THREADS = \d+;", f"constexpr int THREADS = {threads};",
                     src, flags=re.M)
    out, m = re.subn(r"^constexpr int UNROLL = \d+;", f"constexpr int UNROLL = {unroll};", out,
                     flags=re.M)
    if (n, m) != (1, 1):
        raise RuntimeError("THREADS or UNROLL not found")
    return out


def build_variants(build) -> dict:
    from repro_torch.kernels import paged_gather as PG

    root = ROOT / "build" / "sweep_movers"
    procs = {}
    t0 = time.perf_counter()
    for name, grid in GRID.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        for threads, unroll in grid:
            d = root / f"{name}_t{threads}_u{unroll}"
            d.mkdir(parents=True, exist_ok=True)
            cu = d / f"{name}.cu"
            cu.write_text(variant_source(src, threads, unroll))
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                   str(d / "lib.so"), str(cu)]
            procs[name, threads, unroll] = (d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (d, proc) in procs.items():
        log_text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log_text}")
        regs = re.findall(r"Used (\d+) registers", log_text)
        spills = re.findall(r"(\d+) bytes spill stores", log_text)
        print(f"built {key}: registers {sorted(set(regs))}, spill stores {sorted(set(spills))}",
              flush=True)
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), f"{key[0]}_launch")
        fn.argtypes = PG._SCATTER_ARGTYPES if key[0] == "paged_scatter" else PG._GATHER_ARGTYPES
        fn.restype = ctypes.c_int
        fns[key] = fn
    print(f"built {len(procs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    return fns


def callers(fns):
    """Each variant's group call, with the shipped wrapper's checks and
    flags: the wrapper's module-level entry point swapped for the
    variant's."""
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_gather as PG

    def bind(key, fn):
        wrapper = PG.paged_scatter_leaves_cuda if key[0] == "paged_scatter" else (
            PG.paged_gather_leaves_cuda)
        symbol = f"{key[0]}_launch"

        def call(*args):
            saved = build._ENTRIES.get((key[0], symbol))
            build._ENTRIES[key[0], symbol] = fn
            try:
                return wrapper(*args)
            finally:
                build._ENTRIES[key[0], symbol] = saved

        return call

    return {key: bind(key, fn) for key, fn in fns.items()}


def gather_scaling(torch, dev, cfg, cs, g) -> list:
    """The shipped gather over growing tables (one launch a group of a kv8
    layer's k, k_s, v, v_s) beside ``Tensor.copy_`` of the same bytes: the
    time a launch, so its fixed cost and its rate."""
    from repro_torch.kernels import ops

    nb = cs.S_MAX // cs.PAGE_SIZE
    rows = []
    for slots in SCALING_SLOTS:
        P_ = slots * nb + 1
        shapes = [((P_, cs.PAGE_SIZE, cfg.kv_heads, cfg.head_dim), torch.int8),
                  ((P_, cs.PAGE_SIZE, cfg.kv_heads), torch.float32)] * 2
        read = slots * nb * sum(
            cs.PAGE_SIZE * (cfg.kv_heads * cfg.head_dim if dt == torch.int8 else 4 * cfg.kv_heads)
            for _, dt in shapes)
        n = max(1, WINDOW_BYTES // (2 * read))
        groups = []
        for _ in range(n):
            lv = [cs.seeded(torch, g, torch.empty(sh, dtype=dt, device=dev)) for sh, dt in shapes]
            bt = (torch.randperm(P_ - 1, generator=g, device=dev)[: slots * nb] + 1)
            groups.append((lv, bt.reshape(slots, nb).to(torch.int32)))
        t, _, how = cs.device_ms(lambda: [ops.paged_gather_leaves(lv, bt) for lv, bt in groups],
                                 names=("paged_gather_kernel",))
        del groups
        pairs = [(torch.empty(read, dtype=torch.uint8, device=dev),
                  torch.empty(read, dtype=torch.uint8, device=dev)) for _ in range(n)]
        tc, _, howc = cs.device_ms(lambda: [d.copy_(s_) for s_, d in pairs])
        del pairs
        t, tc = t / n, tc / n
        rows.append(dict(slots=slots, bytes_moved=2 * read, gather_ms=t, copy_ms=tc))
        print(f"gather, one launch over {slots} slots ({2 * read / 1e6:.1f} MB moved): "
              f"{t * 1e3:.2f} us, {2 * read / t / 1e6:.0f} GB/s ({how}); copy_ of the same "
              f"bytes {tc * 1e3:.2f} us, {2 * read / tc / 1e6:.0f} GB/s ({howc})", flush=True)
    (a, b) = rows[0], rows[-1]
    rate = (b["bytes_moved"] - a["bytes_moved"]) / (b["gather_ms"] - a["gather_ms"]) / 1e6
    fixed = a["gather_ms"] * 1e3 - a["bytes_moved"] / rate / 1e3
    print(f"gather: {rate:.0f} GB/s past the first {SCALING_SLOTS[0]} slots, {fixed:.2f} us "
          f"a launch fixed (a line through {SCALING_SLOTS[0]} and {SCALING_SLOTS[-1]} slots)",
          flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.paged_gather import launch_floor_cuda

    dev = torch.device("cuda", 0)
    card = cs.gpu_line()
    print(card, flush=True)
    build.ensure_built()
    calls = callers(build_variants(build))
    cfg = configs.get_arch("internlm2-1.8b")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    cases = [cs.attn_case(torch, dev, cfg, 8, g) for _ in range(cfg.n_layers)]
    groups = [([c[1], c[2], c[3], c[4]], c[5], c[6]) for c in cases]
    news = [[cs.seeded(torch, g, torch.empty((cs.N_SLOTS, 1, *a.shape[2:]), dtype=a.dtype,
                                             device=dev)) for a in lv] for lv, _, _ in groups]

    def step(key, call):
        if key[0] == "paged_scatter":
            return lambda: [call(lv, n, p, b) for (lv, p, b), n in zip(groups, news)]
        return lambda: [call(lv, b) for lv, _, b in groups]

    lv, p, b = groups[0]
    for key, call in calls.items():
        if key[0] == "paged_scatter":
            got = call([a.clone() for a in lv], news[0], p, b)
            want = ops.paged_scatter_leaves([a.clone() for a in lv], news[0], p, b, impl="torch")
            same = all(cs.same_bytes(torch, x[1:], y[1:]) for x, y in zip(got, want))
        else:
            same = all(cs.same_bytes(torch, x, y) for x, y in
                       zip(call(lv, b), ops.paged_gather_leaves(lv, b, impl="torch")))
        torch.cuda.synchronize()
        if not same:
            raise AssertionError(f"variant {key} disagrees with the plain version")
    print("every variant bit-exact with the plain version on one layer's group", flush=True)

    floor, _, how = cs.device_ms(lambda: [launch_floor_cuda(dev) for _ in range(cs.CALLS)],
                                 names=("empty_kernel",))
    floor /= cs.CALLS
    print(f"launch floor: one empty kernel {floor * 1e3:.3f} us device ({how})", flush=True)
    times = {key: [] for key in calls}
    for _ in range(ROUNDS):
        for key, call in calls.items():
            times[key].append(cs.device_ms(step(key, call), names=(f"{key[0]}_kernel",))[0])
    nbytes = sum(2 * b.numel() * a[0].numel() * a.element_size() + b.numel() * 4
                 for lv, _, b in groups for a in lv)
    bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
    rows = []
    for key, ts in times.items():
        t = statistics.median(ts)
        rows.append(dict(kernel=key[0], THREADS=key[1], UNROLL=key[2], step_ms=t, rounds=ts,
                         us_a_launch=t / len(groups) * 1e3))
        extra = (f", {bound / t:.2f} of the bound {bound:.4f} ms"
                 if key[0] == "paged_gather" else "")
        print(f"{key[0]} THREADS={key[1]:3d} UNROLL={key[2]}: {t:.4f} ms a decode step, "
              f"{t / len(groups) * 1e3:.2f} us a launch{extra} (rounds "
              f"{', '.join(f'{x:.4f}' for x in ts)})", flush=True)
    scaling = gather_scaling(torch, dev, cfg, cs, g)
    out = ROOT / "build" / "sweep_movers" / "sweep_page_movers.json"
    out.write_text(json.dumps(dict(card=card, floor_us=floor * 1e3, rows=rows,
                                   scaling=scaling), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
