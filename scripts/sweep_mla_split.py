#!/usr/bin/env python3
"""Sweep paged_mla_attn's compile-time tiling on one NVIDIA GPU.

Run from the repository root:  python3 scripts/sweep_mla_split.py

``csrc/paged_mla_attn.cu`` fixes two constants: ``PPS``, the pages a block
walks before its partial goes to the merge, and ``HB``, the heads a block
takes. This script builds the source once for each (HB, PPS) in ``GRID``
(the constants rewritten in a copy under ``build/sweep_mla/``, every nvcc
started together), holds each variant against the plain version
(``ATTN_TOL`` x (1 + max |plain|)), and times each on DeepSeek-V3's kv8 decode
shapes: one decode step of 3 calls (a call per MLA layer) over 4 slots at
159, 287, 415 and 543 cached rows, H 128, C 512, dr 64, pages of 16, each
call on its own latent pool and the window over ``chip_smoke.COLD_STEPS``
such steps (more bytes than the 50 MB L2 holds). Device time per step from
``chip_smoke.device_ms`` (torch.profiler), the split pass and the merge
apart; the variants run in turns, ``ROUNDS`` times, and the median is kept.
Prints a table and the fastest variant, and writes them to
``build/sweep_mla/sweep_mla_split.json``.
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

#: (HB, PPS) variants: HB a multiple of 16 that shares the 8 warps evenly
#: and keeps the block's shared memory under the card's 227 KB at C 512
GRID = [(16, 1), (16, 2), (16, 4), (32, 1), (32, 2), (32, 4)]
ROUNDS = 3


def variant_source(src: str, hb: int, pps: int) -> str:
    out, n = re.subn(r"^constexpr int PPS = \d+;", f"constexpr int PPS = {pps};", src, flags=re.M)
    out, m = re.subn(r"^constexpr int HB = \d+;", f"constexpr int HB = {hb};", out, flags=re.M)
    if (n, m) != (1, 1):
        raise RuntimeError("paged_mla_attn.cu: PPS or HB not found")
    return out


def build_variants(build) -> dict:
    src = (build.CSRC / "paged_mla_attn.cu").read_text()
    root = ROOT / "build" / "sweep_mla"
    procs = {}
    t0 = time.perf_counter()
    for hb, pps in GRID:
        d = root / f"hb{hb}_pps{pps}"
        d.mkdir(parents=True, exist_ok=True)
        cu = d / "paged_mla_attn.cu"
        cu.write_text(variant_source(src, hb, pps))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(d / "lib.so"), str(cu)]
        procs[(hb, pps)] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (d, proc) in procs.items():
        log_text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for HB, PPS = {key}:\n{log_text}")
        regs = re.findall(r"Used (\d+) registers", log_text)
        spills = re.findall(r"(\d+) bytes spill stores", log_text)
        print(f"built HB={key[0]} PPS={key[1]}: registers {sorted(set(regs))}, spill stores "
              f"{sorted(set(spills))}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.paged_mla_attn_launch
        from repro_torch.kernels.paged_attn import _MLA_ARGTYPES

        fn.argtypes, fn.restype = _MLA_ARGTYPES, ctypes.c_int
        libs[key] = fn
    print(f"built {len(GRID)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def caller(torch, fn, hb, pps):
    """paged_mla_attn_cuda's launch through a variant's library, its scratch
    sized by the variant's HB and PPS."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attn import _BITS_CODE, _copy_width

    def call(ql, qr, c, cs, r, pos, bt, bits, scale):
        B, H, C = ql.shape
        dr = qr.shape[-1]
        ps, NB = c.shape[1], bt.shape[1]
        out = torch.empty((B, H, C), dtype=torch.float32, device=ql.device)
        nsplit = -(-NB // pps)
        part = torch.empty(B * -(-H // hb) * nsplit * hb * (C + 2), dtype=torch.float32,
                           device=ql.device)
        vb = _copy_width(16, c, r)
        err = fn(ql.data_ptr(), qr.data_ptr(), c.data_ptr(),
                 cs.data_ptr() if bits is not None else None, r.data_ptr(), pos.data_ptr(),
                 bt.data_ptr(), out.data_ptr(), part.data_ptr(), B, H, C, dr, ps, NB,
                 _BITS_CODE[bits], vb, float(scale), build.stream_ptr(ql.device))
        build.check(err, f"variant HB={hb} PPS={pps}")
        build.LAUNCHES["paged_mla_attn"] += 1
        return out

    return call


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs_mod
    from repro_torch import configs
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda", 0)
    card = cs_mod.gpu_line()
    print(card, flush=True)
    libs = build_variants(build)
    mcfg = configs.get_arch(cs_mod.MLA_ARCH)
    scale = 1.0 / (mcfg.d_nope + mcfg.d_rope) ** 0.5
    g = torch.Generator(device=dev).manual_seed(cs_mod.SEED + 8)
    steps = cs_mod.COLD_STEPS
    cases = [cs_mod.mla_case(torch, dev, mcfg, 8, g) for _ in range(cs_mod.MLA_LAYERS * steps)]
    calls = {key: caller(torch, fn, *key) for key, fn in libs.items()}

    # each variant against the plain version on the first case
    plain = ops.paged_mla_attn(*cases[0][:6], block_table=cases[0][6], bits=8, scale=scale,
                               impl="torch")
    tol = cs_mod.ATTN_TOL * (1 + float(plain.abs().max()))
    for key, call in calls.items():
        err = float((call(*cases[0], 8, scale) - plain).abs().max())
        print(f"HB={key[0]} PPS={key[1]}: max |variant - plain| = {err:.3e} (tol {tol:.3e})",
              flush=True)
        if err > tol:
            raise AssertionError(f"variant {key} disagrees with the plain version")

    times = {key: [] for key in calls}
    for _ in range(ROUNDS):
        for key, call in calls.items():
            fn = lambda call=call: [call(*c, 8, scale) for c in cases]  # noqa: E731
            split, _, _ = cs_mod.device_ms(fn, names=("paged_mla_split_kernel",))
            merge, _, _ = cs_mod.device_ms(fn, names=("paged_attn_merge_kernel",))
            times[key].append((split / steps, merge / steps))
    rows = []
    for key, ts in times.items():
        split = statistics.median(t[0] for t in ts)
        merge = statistics.median(t[1] for t in ts)
        rows.append(dict(HB=key[0], PPS=key[1], split_ms=split, merge_ms=merge,
                         step_ms=split + merge, rounds=[list(t) for t in ts]))
        print(f"HB={key[0]:3d} PPS={key[1]}: {split + merge:.4f} ms a decode step "
              f"(split {split:.4f}, merge {merge:.4f}; rounds "
              f"{', '.join(f'{a + b:.4f}' for a, b in ts)})", flush=True)
    best = min(rows, key=lambda r: r["step_ms"])
    print(f"fastest: HB={best['HB']} PPS={best['PPS']} at {best['step_ms']:.4f} ms a decode "
          f"step ({card})", flush=True)
    (ROOT / "build" / "sweep_mla" / "sweep_mla_split.json").write_text(
        json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
