#!/usr/bin/env python3
"""Time the port's paged_copy and qntpack kernels on one NVIDIA GPU, for one
or more checkouts of the repository in turns.

Run from the repository root:  python3 scripts/compare_copy_qntpack.py TREE [TREE ...]

Each TREE is a checkout of the repository (``.`` for this one; another, say
the parent commit, made with ``git archive`` into the gitignored
``build/``). The trees run in the order given (for two versions: other,
this, this, other), each in a process of its own that imports only that
tree's ``src`` and builds that tree's kernels. Each run measures, through
the tree's public ops:

  * qntpack at y = 4 (requant parameters of chip_smoke.py's kernels line) at
    Tab. 1's (256, 64) and at the 224 x 224 Reference Layer's accumulators
    (50176, 64): the kernel's device time a call (torch.profiler, CALLS
    calls a window, the median of five windows) and ``torch.bucketize``
    over the same thresholds, the ladder alone;
  * one COW clone of an internlm2-1.8b kv8 paged cache (24 layers of k, v,
    k_s, v_s; 257 pages of 16 rows), page 1 into page 2 on every leaf with
    host ids, as the prefix cache makes it: the kernels' device time a
    clone, their launches, and the clone's wall time (20 clones, then one
    synchronize);
  * the host-to-device copies (``Memcpy HtoD`` in the profiler) of one
    clone and of one ``ops.qntpack`` call, each after a first call.

Prints the card, one JSON line a run, and the medians of each tree.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CALLS = 50
SHAPES = ((256, 64), (50176, 64))


def one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as C
    from repro_torch import configs
    from repro_torch.core import quant as Q
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import build, ops
    from repro_torch.models import model as M

    dev = torch.device("cuda", 0)
    build.ensure_built()
    out = {"root": str(root)}
    g = torch.Generator(device=dev).manual_seed(0)
    rq = Q.make_requant_params(y_bits=4, eps_phi=2.0**-17, eps_y=1.0, lam=float(1 << 20))
    thresholds = torch.from_numpy(rq.thresholds.astype("int32")).to(dev)
    for m, n in SHAPES:
        phi = torch.randint(-(1 << 20), 1 << 20, (m, n), generator=g, device=dev,
                            dtype=torch.int32)
        t, _, _ = C.device_ms(lambda: [ops.qntpack(phi, rq, y_bits=4) for _ in range(CALLS)],
                              names=("qntpack_kernel",))
        tl, _, _ = C.device_ms(lambda: [torch.bucketize(phi, thresholds, right=True)
                                        for _ in range(CALLS)])
        out[f"qntpack_{m}x{n}_us"] = t / CALLS * 1e3
        out[f"bucketize_{m}x{n}_us"] = tl / CALLS * 1e3
    out["qntpack_htod"] = C.htod_copies(torch, dev, lambda: ops.qntpack(phi, rq, y_bits=4))

    cfg, policy = configs.get_arch("internlm2-1.8b"), get_policy("w4a8")
    caches = M.init_paged_cache(cfg, policy, 257, 16, device=dev)
    leaves = [a for layer in caches for a in layer.values()]
    s, d = torch.tensor([1], dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    if hasattr(ops, "paged_copy_leaves"):
        clone = lambda: ops.paged_copy_leaves(leaves, s, d)  # noqa: E731
    else:
        clone = lambda: [ops.paged_copy(a, s, d) for a in leaves]  # noqa: E731
    t, _, how = C.device_ms(clone, names=("paged_copy",))
    out["clone_device_ms"] = t
    n0 = build.LAUNCHES["paged_copy"]
    clone()
    out["clone_launches"] = build.LAUNCHES["paged_copy"] - n0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        clone()
    torch.cuda.synchronize()
    out["clone_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    out["clone_htod"] = C.htod_copies(torch, dev, clone)
    out["clone_how"] = how
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(pathlib.Path(sys.argv[2]).resolve())), flush=True)
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    runs: dict = {}
    for tree in sys.argv[1:]:
        root = pathlib.Path(tree).resolve()
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.setdefault(str(root), []).append(row)
        print(json.dumps(row), flush=True)
    for root, rows in runs.items():
        keys = [k for k, v in rows[0].items() if isinstance(v, (int, float))]
        med = {k: statistics.median(r[k] for r in rows) for k in keys}
        print(f"{root}: " + ", ".join(f"{k} {v}" for k, v in med.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
