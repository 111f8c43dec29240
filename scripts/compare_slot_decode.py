#!/usr/bin/env python3
"""Compare two checkouts of the port on one NVIDIA GPU: the internlm2-1.8b
decode step on the dense (slot) cache, where ``seq_insert`` writes every
layer's new K/V rows.

Run from the repository root:  python3 scripts/compare_slot_decode.py OTHER

OTHER is another checkout of the repository (say the parent commit, made
with ``git archive`` into the gitignored ``build/``). The two trees run in
turns, OTHER, this one, this one, OTHER, each in a process of its own that
imports only that tree's ``src``; both load the kernels built from this
tree's ``build/kernels`` (a library's directory is keyed by a hash of its
sources, so a tree whose sources differ builds its own). Each run:
internlm2-1.8b at full width under w4a8 (weights from a seeded generator on
the card), one decode step on a dense cache of 4 slots x 1024 rows at 159,
287, 415 and 543 cached rows, fused and unfused: wall time (mean of 10
steps after 2, no profiler), the host syncs of one step (PyTorch's sync
debug mode at "warn"), one profiled step's device busy time; then
chip_smoke.py's four greedy requests (prompts of 128 to 512 tokens, 32 new
tokens each) served on the slot cache, fused: step EMA, TPOT p50 and
tokens/s. Prints one JSON line a run and the medians of each tree.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]


def syncs(torch, fn) -> int:
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


def one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.ensure_built()
    cfg, policy = configs.get_arch("internlm2-1.8b"), get_policy("w4a8")
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, policy, device=dev)
    B = 4
    caches = M.init_cache(cfg, policy, B, 1024, device=dev)
    toks = torch.ones((B, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([159, 287, 415, 543], dtype=torch.int32, device=dev)
    out = {"root": str(root)}
    for fused in (True, False):
        def step():
            return M.decode_step(params, toks, pos, caches, cfg, policy, fused_attn=fused)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 10
        n_sync = syncs(torch, step)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        busy = sum((getattr(e, "self_device_time_total", 0) or 0) / 1e3
                   for e in prof.key_averages())
        tag = "fused" if fused else "unfused"
        out[f"{tag}_wall_ms"], out[f"{tag}_busy_ms"] = wall, busy
        out[f"{tag}_syncs"] = n_sync
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab, size=n).astype(np.int32), max_new=32)
            for i, n in enumerate((128, 256, 384, 512))]
    eng = ServeEngine(params, cfg, policy, n_slots=B, s_max=1024, cache="slot", fused_attn=True,
                      device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    m = eng.metrics()
    out.update(step_ema_ms=m["step_ema_s"] * 1e3, tpot_p50_ms=m["slo/tpot_p50_s"] * 1e3,
               tokens_per_s=m["tokens_generated"] / (time.perf_counter() - t0))
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
