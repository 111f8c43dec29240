#!/usr/bin/env python3
"""Compare two checkouts of the port on one NVIDIA GPU: the internlm2-1.8b
paged decode step and paged serving, where the page movers run.

Run from the repository root:  python3 scripts/compare_page_movers.py OTHER

OTHER is another checkout of the repository (say the parent commit, made
with ``git archive`` into the gitignored ``build/``). The two trees run in
turns, OTHER, this one, this one, OTHER, each in a process of its own that
imports only that tree's ``src`` and builds that tree's kernels. Each run:
internlm2-1.8b at full width under w4a8 (weights from a seeded generator on
the card), one decode step on the paged cache (4 slots at 159, 287, 415 and
543 cached rows, 64 pages of 16 rows each, shuffled over the pool), fused
and unfused: wall time (mean of 5 steps after 2, no profiler), then one
profiled step's device busy time and the page movers' device time; then
chip_smoke.py's four greedy requests (prompts of 128 to 512 tokens, 32 new
tokens each) served on the paged cache, fused: step EMA, TPOT p50 and
tokens/s. Prints one JSON line a run and the medians of each tree.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOVERS = ("paged_scatter_kernel", "paged_gather_kernel")


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

    dev = torch.device("cuda", 0)
    build.ensure_built()
    cfg, policy = configs.get_arch("internlm2-1.8b"), get_policy("w4a8")
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, policy, device=dev)
    nb, ps, B = 64, 16, 4
    caches = M.init_paged_cache(cfg, policy, B * nb + 1, ps, device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    bt = (torch.randperm(B * nb, generator=g, device=dev) + 1).reshape(B, nb).to(torch.int32)
    toks = torch.ones((B, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([159, 287, 415, 543], dtype=torch.int32, device=dev)
    out = {"root": str(root)}
    for fused in (True, False):
        def step():
            return M.decode_step(params, toks, pos, caches, cfg, policy, block_tables=bt,
                                 fused_attn=fused)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 5
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        busy, movers = 0.0, {k: 0.0 for k in MOVERS}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            busy += us / 1e3
            for k in MOVERS:
                if k in e.key:
                    movers[k] += us / 1e3
        tag = "fused" if fused else "unfused"
        out[f"{tag}_wall_ms"], out[f"{tag}_busy_ms"] = wall, busy
        out.update({f"{tag}_{k}_ms": v for k, v in movers.items()})
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab, size=n).astype(np.int32), max_new=32)
            for i, n in enumerate((128, 256, 384, 512))]
    eng = ServeEngine(params, cfg, policy, n_slots=B, s_max=1024, cache="paged", page_size=ps,
                      fused_attn=True, device=dev)
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
