#!/usr/bin/env python3
"""Compare two checkouts of the port on one NVIDIA GPU: the device time of
the steps that read the KV cache unfused, where the attention's f32
products run (through ``torch.einsum`` in a tree before the row-invariant
``rowinv_bmm`` kernel, through that kernel after it).

Run from the repository root:  python3 scripts/compare_unfused_verify.py OTHER

OTHER is another checkout of the repository (say the parent commit, made
with ``git archive`` into the gitignored ``build/``). The two trees run in
turns, OTHER, this one, this one, OTHER, each in a process of its own that
imports only that tree's ``src``; both load the kernels built from this
tree's ``build/kernels`` (a library's directory is keyed by a hash of its
sources, so a tree whose sources differ builds its own). Each run, at full
width under w4a8 with an 8-bit paged cache (pages of 16, each slot's 64
pages shuffled over the pool; weights from a seeded generator on the card),
4 slots at 159, 287, 415 and 543 cached rows: internlm2-1.8b's unfused
decode step, its continuous mixed step (4 decode lanes, width 16) and its
speculative verify (``spec_verify_step``, 5 positions a slot), and
DeepSeek-V3's three MLA layers' unfused decode step. For each: the device
time of one call (torch.profiler, the kernels' own time summed, the median
of 3 windows, each after a warm-up step in the same window) and of the
products in it (``rowinv_bmm_kernel``, or cuBLAS's gemm / gemv kernels),
and the wall time (median of 3 calls, each ended by a synchronize). Prints
one JSON line a run and the medians of each tree.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: device kernels that compute the unfused read's products in either tree
PRODUCTS = ("rowinv_bmm_kernel", "gemm", "gemv", "Kernel2", "splitK")


def timed(torch, fn) -> tuple[float, float, float]:
    """(device ms, the products' device ms, wall ms) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    walls, devs, prods = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()  # the warm-up step: the first device events a window loses are its
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
        seen = [(e.key, (getattr(e, "self_device_time_total", 0) or 0) / 1e3)
                for e in prof.key_averages()]
        devs.append(sum(t for _, t in seen))
        prods.append(sum(t for k, t in seen if any(p in k for p in PRODUCTS)))
    return statistics.median(devs), statistics.median(prods), statistics.median(walls)


def one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.ensure_built()
    policy = get_policy("w4a8")
    B, ps, nb = 4, 16, 64
    pos = torch.tensor([159, 287, 415, 543], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    bt = (torch.randperm(B * nb, generator=g, device=dev) + 1).reshape(B, nb).to(torch.int32)
    out = {"root": str(root)}
    for arch, layers in (("internlm2-1.8b", None), ("deepseek-v3-671b", 3)):
        cfg = configs.get_arch(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, policy,
                               device=dev)
        caches = M.init_paged_cache(cfg, policy, B * nb + 1, ps, device=dev)
        toks = torch.ones((B, 1), dtype=torch.int32, device=dev)
        tag = arch.split("-")[0]
        steps = {"decode": lambda: M.decode_step(params, toks, pos, caches, cfg, policy,
                                                 block_tables=bt, fused_attn=False)}
        if layers is None:
            wide = torch.ones((B, 16), dtype=torch.int32, device=dev)
            ones = torch.ones((B,), dtype=torch.int32, device=dev)
            window = torch.ones((B, 5), dtype=torch.int32, device=dev)
            five = torch.full((B,), 5, dtype=torch.int32, device=dev)
            lanes = (np.zeros(B, np.float32), np.zeros(B, np.int64), np.ones(B, np.float32),
                     np.zeros(B, np.int64), np.zeros(B, np.int64))
            steps["mixed"] = lambda: M.mixed_step(params, wide, pos, ones, caches, cfg, policy,
                                                  block_tables=bt, page_size=ps)
            steps["verify"] = lambda: M.spec_verify_step(params, window, pos, five, *lanes,
                                                         caches, cfg, policy, block_tables=bt,
                                                         page_size=ps)
        for name, fn in steps.items():
            d, p, w = timed(torch, fn)
            out.update({f"{tag}_{name}_device_ms": d, f"{tag}_{name}_products_ms": p,
                        f"{tag}_{name}_wall_ms": w})
        del params, caches, steps
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(pathlib.Path(sys.argv[2]).resolve())), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    other = pathlib.Path(sys.argv[1]).resolve()
    shared = other / "build" / "kernels"
    if not shared.exists():  # one build serves both trees where their sources agree
        (ROOT / "build" / "kernels").mkdir(parents=True, exist_ok=True)
        shared.parent.mkdir(parents=True, exist_ok=True)
        os.symlink(ROOT / "build" / "kernels", shared)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    runs: dict = {str(other): [], str(ROOT): []}
    for root in (other, ROOT, ROOT, other):
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[str(root)].append(row)
        print(json.dumps(row), flush=True)
    for root, rows in runs.items():
        keys = [k for k in rows[0] if k != "root"]
        med = {k: statistics.median(r[k] for r in rows) for k in keys}
        print(f"{root}: " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
