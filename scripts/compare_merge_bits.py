#!/usr/bin/env python3
"""Hold paged_attn and paged_mla_attn to another checkout's bits, on one GPU.

Run from the repository root:  python3 scripts/compare_merge_bits.py OTHER

OTHER is another checkout of the repository (say the parent commit, made
with ``git archive`` into the gitignored ``build/``). The two decode
attention kernels share their merge with qkv_decode through
``csrc/paged_split.cuh``; this script builds OTHER's ``paged_attn.cu`` and
``paged_mla_attn.cu`` (each against OTHER's headers) under
``build/compare_merge/``, runs both trees' kernels through this tree's
wrappers (the other tree's library swapped in for the call) on
chip_smoke.py's phase-2 cases (internlm2's GQA pools at bf16 / kv8 / kv4,
without and with a window of 100; DeepSeek-V3's latent pools at bf16 / kv8
/ kv4, at the serving run's positions and at ragged ones) and requires the
outputs to be equal bit for bit (exit 1 on the first difference); then
times one kv8 call of each kernel through both trees in turns (this, OTHER,
OTHER, this; ``chip_smoke.device_ms``) and prints each tree's median.
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
SOURCES = ("paged_attn", "paged_mla_attn")


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage (on a CUDA device): compare_merge_bits.py OTHER", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build, ops

    csrc = pathlib.Path(sys.argv[1]).resolve() / "src" / "repro_torch" / "csrc"
    out = ROOT / "build" / "compare_merge"
    out.mkdir(parents=True, exist_ok=True)
    build.ensure_built()
    libs = {}
    for name in SOURCES:
        so = out / f"lib{name}.so"
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
                            str(csrc / f"{name}.cu")], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(so))

    def through_other(name, fn):
        """fn() through OTHER's library."""
        build._ENTRIES.pop((name, f"{name}_launch"), None)
        saved, build._LIBS[name] = build._LIBS[name], libs[name]
        try:
            return fn()
        finally:
            build._LIBS[name] = saved
            build._ENTRIES.pop((name, f"{name}_launch"), None)

    def run(name, fn):
        """fn() through this tree's library and through OTHER's."""
        mine, theirs = fn(), through_other(name, fn)
        torch.cuda.synchronize()
        return mine, theirs

    def times(name, fn):
        """Device ms of fn() through each tree, in turns (this, OTHER, OTHER,
        this): the medians of each tree's windows."""
        t = {"this": [], "other": []}
        for who in ("this", "other", "other", "this"):
            timed = lambda: cs.device_ms(fn)[0]  # noqa: E731
            t[who].append(timed() if who == "this" else through_other(name, timed))
        return {k: statistics.median(v) for k, v in t.items()}

    dev = torch.device("cuda", 0)
    print(cs.gpu_line(), flush=True)
    cfg, mcfg = configs.get_arch("internlm2-1.8b"), configs.get_arch(cs.MLA_ARCH)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    n = 0
    for bits in (None, 8, 4):
        q, k, ks, v, vs, pos, bt = cs.attn_case(torch, dev, cfg, bits, g)
        for window in (None, 100):
            a, b = run("paged_attn", lambda: ops.paged_attn(
                q, k, ks, v, vs, pos, bits=bits, block_table=bt, window=window, impl="cuda"))
            if not torch.equal(a, b):
                print(f"paged_attn bits={bits} window={window}: the trees differ", flush=True)
                return 1
            n += 1
    scale = 1.0 / (mcfg.d_nope + mcfg.d_rope) ** 0.5
    for pos in (None, [0, 37, 600, 1000]):
        for bits in (None, 8, 4):
            ql, qr, c, c_s, r, p, bt = cs.mla_case(torch, dev, mcfg, bits, g, pos)
            a, b = run("paged_mla_attn", lambda: ops.paged_mla_attn(
                ql, qr, c, c_s, r, p, block_table=bt, bits=bits, scale=scale, impl="cuda"))
            if not torch.equal(a, b):
                print(f"paged_mla_attn bits={bits} pos={p.tolist()}: the trees differ", flush=True)
                return 1
            n += 1
    print(f"paged_attn and paged_mla_attn: {n} cases bit-identical to {sys.argv[1]}", flush=True)
    q, k, ks, v, vs, pos, bt = cs.attn_case(torch, dev, cfg, 8, g)
    t = times("paged_attn", lambda: ops.paged_attn(q, k, ks, v, vs, pos, bits=8, block_table=bt,
                                                    impl="cuda"))
    print(f"paged_attn kv8, one call (4 slots, 16 / 8 heads): {t['this'] * 1e3:.2f} us device "
          f"here, {t['other'] * 1e3:.2f} us through {sys.argv[1]}", flush=True)
    ql, qr, c, c_s, r, p, bt = cs.mla_case(torch, dev, mcfg, 8, g)
    t = times("paged_mla_attn", lambda: ops.paged_mla_attn(
        ql, qr, c, c_s, r, p, block_table=bt, bits=8, scale=scale, impl="cuda"))
    print(f"paged_mla_attn kv8, one call (4 slots, 128 heads): {t['this'] * 1e3:.2f} us device "
          f"here, {t['other'] * 1e3:.2f} us through {sys.argv[1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
