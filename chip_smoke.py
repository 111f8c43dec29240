#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order (any failure ends the run with a nonzero exit):
  1. the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/csrc/`` with nvcc (sm_90a) and report the build time;
  2. hold each kernel against its plain PyTorch version on the card:
     mpmm on all 27 cells x 3 output kinds at a small shape and on the five
     main-path (N, K) at M = 4 and 16 (bit-exact); paged_scatter (bit-exact,
     scratch page excluded); paged_attn on bf16 / kv8 / kv4, with and without
     a window (tolerance ATTN_TOL); conv2d on all 27 cells at the paper's
     Reference Layer and at a ragged shape, qntpack on every output width at
     the Tab. 1 shape, paged_gather on every cache leaf (all bit-exact);
  3. the serving path: ServeEngine serving internlm2-1.8b at full width under
     policy w4a8 with an 8-bit KV cache (weights from a seeded
     torch.Generator on the card), 4 greedy requests, first on the slot cache
     and then on the paged cache; the token streams must be identical and
     mpmm, paged_attn and paged_scatter must have launched;
  4. the Reference-Layer path: ``repro_torch.examples.quickstart`` and
     ``mixed_precision_sweep`` (27 cells) on the card, their packed ofmaps
     equal to the CPU run's and their mean errors within 1e-6; then the
     paper's three phases unfused (im2col, mpmm int32 out, qntpack) equal to
     the fused conv2d; conv2d and qntpack must have launched;
  5. the unfused paged read: the serving path again with
     ``fused_attn=False``, slot then paged cache; the two streams must be
     identical and paged_gather must have launched (agreement with the fused
     streams is printed, not gated: the softmax sums in another order);
  6. a teacher-forced decode step at full width, kernel path against plain
     path from the same cache (largest logit difference, argmax agreement);
  7. each kernel's time beside its bound and its plain version's time (per
     decode step for the serving kernels; per call at the paper's shape for
     conv2d, also at 224 x 224, and qntpack);
  8. the MLA serving path: ServeEngine serving DeepSeek-V3 at its published
     widths cut to its three dense (MLA) layers, policy w4a8 with an 8-bit
     latent cache, the same 4 greedy requests, on the slot cache and then
     the paged cache (fused decode: paged_mla_attn), then both again with
     ``fused_attn=False`` (the paged read through paged_gather); slot and
     paged streams identical, fused and unfused; then a teacher-forced MLA
     decode step (kernel vs plain), the MLA step's breakdown, and
     paged_mla_attn's time per decode step beside its bound, its plain
     version and ``F.scaled_dot_product_attention`` on the bf16 cell.
     Phase 2 holds paged_mla_attn against its plain version on bf16 / kv8 /
     kv4 at H 128, C 512, dr 64, pages of 16 (tolerance ATTN_TOL).

Phases 3, 4, 5 and 8 each start with every launch count at 0 (phase 8 once
for its fused runs and once for its unfused runs) and read the counts at
their end; the kernels line gives each kernel the count of its own path.

The line before the last is the kernels JSON, the last line the result
JSON.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12

#: paged_attn / paged_mla_attn kernel vs plain version: both follow the same
#: page-blocked softmax; only the order of the f32 sums inside each dot
#: differs, so the reference's own fused-vs-twin bound applies
#: (tests/test_paged_attn.py)
ATTN_TOL = 1e-5
#: the MLA path: DeepSeek-V3 at its published widths, cut to its three dense
#: (MLA) layers; every deeper layer carries the experts the port lacks
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 3
#: decode steps per timing window over distinct latent pools (8 x 3 pools of
#: 2.7 MB exceed the card's 50 MB L2), so each call finds its pages cold
COLD_STEPS = 8

PROMPT_LENS = (128, 256, 384, 512)
MAX_NEW = 32
N_SLOTS, S_MAX, PAGE_SIZE = 4, 1024, 16
SEED = 0
#: the paper's Tab. 1 QntPack shape (M, N)
TAB1 = (256, 64)
#: launches per timed window for the per-call kernel times
CALLS = 50


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


# ---------------------------------------------------------------- phase 2


def main_path_mm_shapes(cfg):
    """(N, K, calls per decode step) of every projection on the main path."""
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.kv_heads * cfg.head_dim
    L = cfg.n_layers
    return [(cfg.n_heads * cfg.head_dim, d, L), (kv, d, 2 * L), (d, cfg.n_heads * cfg.head_dim, L),
            (f, d, 2 * L), (d, f, L), (cfg.vocab_padded, d, 1)]


def check_mpmm(torch, dev, cfg, report):
    from repro_torch.core import pack as P
    from repro_torch.core import quant as Q
    from repro_torch.core.policy import PERMUTATIONS
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED)

    def operands(M, N, K, xb, wb):
        x = torch.randint(0, 1 << xb, (M, K), generator=g, device=dev, dtype=torch.int32)
        w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (N, K), generator=g, device=dev,
                          dtype=torch.int32)
        return P.pack(x.to(torch.uint8), xb), P.pack(w.to(torch.int8), wb)

    worst = 0
    n = 0
    # all cells x kinds x signedness at a small ragged shape, and at K % 16 != 0
    for (M, N, K) in ((37, 40, 96), (3, 24, 44)):
        for xb, wb, yb in PERMUTATIONS:
            if K % (8 // xb) or K % (8 // wb):
                continue
            x_p, w_p = operands(M, N, K, xb, wb)
            rq = Q.make_requant_params(y_bits=yb, eps_phi=2.0**-9, eps_y=1.0, lam=3.0)
            for kind in ("packed", "int32", "f32"):
                if kind == "packed" and N % (8 // yb):
                    continue
                for signed in (False, True):
                    kw = dict(x_bits=xb, w_bits=wb, y_bits=yb, x_signed=signed, out_kind=kind,
                              out_scale=torch.tensor(0.0123, device=dev))
                    a = ops.mpmm(x_p, w_p, rq, impl="cuda", **kw)
                    b = ops.mpmm(x_p, w_p, rq, impl="torch", **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(a, b):
                        raise AssertionError(f"mpmm mismatch cell {(xb, wb, yb)} {kind} "
                                             f"signed={signed} shape {(M, N, K)}")
                    n += 1
    # the main path's cell (8, 4, 8), signed, f32 out, at its shapes
    for M in (4, 16):
        for N, K, _ in main_path_mm_shapes(cfg):
            x_p, w_p = operands(M, N, K, 8, 4)
            kw = dict(x_bits=8, w_bits=4, y_bits=8, x_signed=True, out_kind="f32",
                      out_scale=torch.tensor(3.1e-4, device=dev))
            a = ops.mpmm(x_p, w_p, None, impl="cuda", **kw)
            b = ops.mpmm(x_p, w_p, None, impl="torch", **kw)
            torch.cuda.synchronize()
            worst = max(worst, float((a - b).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"mpmm mismatch at main-path shape M={M} N={N} K={K}")
            n += 1
    report["mpmm"] = {"max_abs_err": worst, "checks": n}
    log(f"mpmm: {n} comparisons bit-exact (27 cells x 3 kinds x signedness; main-path shapes)")


def make_pool(torch, g, dev, P_, ps, hkv, d, bits):
    """A random quantized K or V page pool and its scales."""
    if bits is None:
        return (torch.randn((P_, ps, hkv, d), generator=g, device=dev).to(torch.bfloat16), None)
    r = 8 // bits
    q = torch.randint(-128, 128, (P_, ps, hkv, d // r), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    s = torch.rand((P_, ps, hkv), generator=g, device=dev) * 0.05 + 1e-3
    return q, s


def attn_case(torch, dev, cfg, bits, g):
    """Main-path shapes: 4 slots, Hq 16, Hkv 8, D 128, pages of 16 rows,
    positions as after the serving run (prompt + max_new - 1)."""
    B, ps = N_SLOTS, PAGE_SIZE
    nb = S_MAX // ps
    P_ = B * nb + 1
    k, ks = make_pool(torch, g, dev, P_, ps, cfg.kv_heads, cfg.head_dim, bits)
    v, vs = make_pool(torch, g, dev, P_, ps, cfg.kv_heads, cfg.head_dim, bits)
    q = torch.randn((B, cfg.n_heads, cfg.head_dim), generator=g, device=dev)
    perm = torch.randperm(P_ - 1, generator=g, device=dev)[: B * nb] + 1
    bt = perm.reshape(B, nb).to(torch.int32).contiguous()
    pos = torch.tensor([n + MAX_NEW - 1 for n in PROMPT_LENS], dtype=torch.int32, device=dev)
    return q, k, ks, v, vs, pos, bt


def check_paged_attn(torch, dev, cfg, report):
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = 0.0
    for bits in (None, 8, 4):
        q, k, ks, v, vs, pos, bt = attn_case(torch, dev, cfg, bits, g)
        for window in (None, 100):
            kw = dict(bits=bits, block_table=bt, window=window)
            a = ops.paged_attn(q, k, ks, v, vs, pos, impl="cuda", **kw)
            b = ops.paged_attn(q, k, ks, v, vs, pos, impl="torch", **kw)
            torch.cuda.synchronize()
            err = float((a - b).abs().max())
            tol = ATTN_TOL * (1 + float(b.abs().max()))
            log(f"paged_attn bits={bits} window={window}: max |kernel - plain| = {err:.3e}")
            if not torch.isfinite(a).all() or err > tol:
                raise AssertionError(f"paged_attn bits={bits} window={window}: err {err} > {tol}")
            worst = max(worst, err)
        # the dense slot layout through the identity-table view
        dk = k[1:].reshape(N_SLOTS, S_MAX, *k.shape[2:])
        dks = None if ks is None else ks[1:].reshape(N_SLOTS, S_MAX, *ks.shape[2:])
        dv = v[1:].reshape(N_SLOTS, S_MAX, *v.shape[2:])
        dvs = None if vs is None else vs[1:].reshape(N_SLOTS, S_MAX, *vs.shape[2:])
        a = ops.paged_attn(q, dk, dks, dv, dvs, pos, bits=bits, impl="cuda")
        b = ops.paged_attn(q, dk, dks, dv, dvs, pos, bits=bits, impl="torch")
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        if err > ATTN_TOL * (1 + float(b.abs().max())):
            raise AssertionError(f"paged_attn dense view bits={bits}: err {err}")
        worst = max(worst, err)
    report["paged_attn"] = {"max_abs_err": worst, "tol": ATTN_TOL}


def mla_case(torch, dev, mcfg, bits, g, pos=None):
    """paged_mla_attn at the MLA path's shapes: 4 slots, H 128, C 512, dr 64,
    a shuffled pool of 16-row pages, positions as after the serving run
    (prompt + max_new - 1) unless ``pos`` is given."""
    from repro_torch.models import attention as A

    B, ps = N_SLOTS, PAGE_SIZE
    nb = S_MAX // ps
    P_ = B * nb + 1
    H, C, dr = mcfg.n_heads, mcfg.kv_lora, mcfg.d_rope
    c, cs = A.kv_quantize(torch.randn((P_, ps, 1, C), generator=g, device=dev), bits)
    r = torch.randn((P_, ps, 1, dr), generator=g, device=dev).to(torch.bfloat16)
    q_lat = torch.randn((B, H, C), generator=g, device=dev)
    q_rope = torch.randn((B, H, dr), generator=g, device=dev)
    perm = torch.randperm(P_ - 1, generator=g, device=dev)[: B * nb] + 1
    bt = perm.reshape(B, nb).to(torch.int32).contiguous()
    if pos is None:
        pos = [n + MAX_NEW - 1 for n in PROMPT_LENS]
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q_lat, q_rope, c, cs, r, pos, bt


def check_paged_mla_attn(torch, dev, mcfg, report):
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    scale = 1.0 / (mcfg.d_nope + mcfg.d_rope) ** 0.5
    worst = 0.0
    # the serving run's positions (page-aligned ends), then ragged ones that
    # end mid-page; every slot has masked pages after its last position
    for pos in (None, [0, 37, 600, 1000]):
        for bits in (None, 8, 4):
            q_lat, q_rope, c, cs, r, p, bt = mla_case(torch, dev, mcfg, bits, g, pos)
            kw = dict(bits=bits, scale=scale)
            a = ops.paged_mla_attn(q_lat, q_rope, c, cs, r, p, block_table=bt, impl="cuda", **kw)
            b = ops.paged_mla_attn(q_lat, q_rope, c, cs, r, p, block_table=bt, impl="torch", **kw)
            # the dense slot layout through the identity-table view
            dense = lambda x: None if x is None else x[bt.long()].reshape(  # noqa: E731
                N_SLOTS, S_MAX, *x.shape[2:])
            d = ops.paged_mla_attn(q_lat, q_rope, dense(c), dense(cs), dense(r), p, impl="cuda",
                                   **kw)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()), float((d - b).abs().max()))
            tol = ATTN_TOL * (1 + float(b.abs().max()))
            log(f"paged_mla_attn bits={bits} pos={p.tolist()}: max |kernel - plain| = {err:.3e}")
            if not (torch.isfinite(a).all() and torch.isfinite(d).all()) or err > tol:
                raise AssertionError(f"paged_mla_attn bits={bits} pos={p.tolist()}: "
                                     f"err {err} > {tol}")
            worst = max(worst, err)
    report["paged_mla_attn"] = {"max_abs_err": worst, "tol": ATTN_TOL}


def check_paged_scatter(torch, dev, cfg, report):
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    nb = S_MAX // PAGE_SIZE
    P_ = N_SLOTS * nb + 1
    leaves = ((torch.int8, (cfg.kv_heads, cfg.head_dim)), (torch.float32, (cfg.kv_heads,)),
              (torch.bfloat16, (cfg.kv_heads, cfg.head_dim)))
    for dtype, tail in leaves:
        pool = torch.randn((P_, PAGE_SIZE, *tail), generator=g, device=dev).mul(40)
        pool = pool.clamp(-100, 100).to(dtype)
        for S_new in (1, 16):
            new = torch.randn((N_SLOTS, S_new, *tail), generator=g, device=dev).mul(40)
            new = new.clamp(-100, 100).to(dtype)
            bt = torch.randperm(P_ - 1, generator=g, device=dev)[: N_SLOTS * nb] + 1
            bt = bt.reshape(N_SLOTS, nb).to(torch.int32)
            bt[0, 5:] = 0  # unallocated entries land in the scratch page
            # slot 2's rows run past its table
            pos = torch.tensor([0, 37, S_MAX - 8, 70], dtype=torch.int32, device=dev)
            a = ops.paged_scatter(pool.clone(), new, pos, bt, impl="cuda")
            b = ops.paged_scatter(pool.clone(), new, pos, bt, impl="torch")
            torch.cuda.synchronize()
            if not torch.equal(a[1:], b[1:]):
                raise AssertionError(f"paged_scatter mismatch dtype={dtype} S_new={S_new}")
    report["paged_scatter"] = {"max_abs_err": 0.0}
    log("paged_scatter: bit-exact on int8 / f32 / bf16 leaves (scratch page excluded)")


def ref_layer() -> tuple:
    """The paper's Reference Layer as (H, W, C, Cout)."""
    from repro_torch.configs import REFCONV as r

    return r.H, r.W, r.C_in, r.C_out


def conv_operands(torch, g, dev, H, W, C, Cout, xb, wb, yb):
    """Random packed operands of one conv cell, and requant parameters that
    spread its accumulators over the output range."""
    from repro_torch.core import pack as P
    from repro_torch.core import quant as Q
    from repro_torch.kernels.ref import im2col

    x = torch.randint(0, 1 << xb, (H, W, C), generator=g, device=dev, dtype=torch.int32)
    w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (Cout, 9 * C), generator=g, device=dev,
                      dtype=torch.int32)
    x_p, w_p = P.pack(x.to(torch.uint8), xb), P.pack(w.to(torch.int8), wb)
    phi = im2col(x_p, xb).double() @ w.double().T
    levels = 1 << yb
    r = levels / 2 / (float(phi.std()) + 1.0)
    r = min(r, 1.0) if yb == 8 else r
    rq = Q.make_requant_params(y_bits=yb, eps_phi=r, eps_y=1.0,
                               lam=levels / 2 / r - float(phi.mean()))
    return x_p, w_p, rq


def check_conv2d(torch, dev, report):
    from repro_torch.core.policy import PERMUTATIONS
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    n = 0
    # the Reference Layer, and a ragged shape: W = 7, C = 12 (staged to 12),
    # Cout = 68 (a partial tile of 4 channels past the first 64)
    for H, W, C, Cout in (ref_layer(), (5, 7, 12, 68)):
        for xb, wb, yb in PERMUTATIONS:
            x_p, w_p, rq = conv_operands(torch, g, dev, H, W, C, Cout, xb, wb, yb)
            bits = dict(x_bits=xb, w_bits=wb, y_bits=yb)
            a = ops.conv2d(x_p, w_p, rq, impl="cuda", **bits)
            b = ops.conv2d(x_p, w_p, rq, impl="torch", **bits)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"conv2d mismatch cell {(xb, wb, yb)} shape {(H, W, C, Cout)}")
            n += 1
    report["conv2d"] = {"max_abs_err": 0.0, "checks": n}
    log(f"conv2d: {n} comparisons bit-exact (27 cells at {ref_layer()} and at (5, 7, 12, 68))")


def check_qntpack(torch, dev, report):
    from repro_torch.core import quant as Q
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    for yb in (8, 4, 2):
        phi = torch.randint(-(1 << 20), 1 << 20, TAB1, generator=g, device=dev, dtype=torch.int32)
        # accumulators at the int32 edges: acc + bias wraps, as JAX's add does
        phi[0] = (1 << 31) - 1 - torch.arange(TAB1[1], dtype=torch.int32, device=dev)
        phi[1] = -(1 << 31) + torch.arange(TAB1[1], dtype=torch.int32, device=dev)
        rq = Q.make_requant_params(y_bits=yb, eps_phi=(1 << yb) / 2.0**21, eps_y=1.0,
                                   lam=float(1 << 20))
        a = ops.qntpack(phi, rq, y_bits=yb, impl="cuda")
        b = ops.qntpack(phi, rq, y_bits=yb, impl="torch")
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"qntpack mismatch y_bits={yb}")
    report["qntpack"] = {"max_abs_err": 0.0}
    log(f"qntpack: bit-exact on y = 8, 4, 2 at (M, N) = {TAB1}, int32-edge accumulators included")


def check_paged_gather(torch, dev, cfg, report):
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    nb = S_MAX // PAGE_SIZE
    P_ = N_SLOTS * nb + 1
    hkv, d = cfg.kv_heads, cfg.head_dim
    leaves = {"int8": (torch.int8, (hkv, d)), "packed int4": (torch.int8, (hkv, d // 2)),
              "bf16": (torch.bfloat16, (hkv, d)), "f32 scales": (torch.float32, (hkv,))}
    bt = (torch.randperm(P_ - 1, generator=g, device=dev)[: N_SLOTS * nb] + 1)
    bt = bt.reshape(N_SLOTS, nb).to(torch.int32)
    bt[0, 5:] = 0  # unallocated entries read the scratch page
    bt[1, 3] = P_ + 5  # past the pool: clamped onto the last page
    bt[2, 7] = -1  # negative: counts from the end
    cases = [(name, (P_, PAGE_SIZE, *tail), dtype, bt) for name, (dtype, tail) in leaves.items()]
    cases.append(("15-byte pages", (9, 3, 5), torch.int8, bt[:2, :4].remainder(9).contiguous()))
    for name, shape, dtype, table in cases:
        pool = torch.randn(shape, generator=g, device=dev).mul(40).clamp(-100, 100).to(dtype)
        a = ops.paged_gather(pool, table, impl="cuda")
        b = ops.paged_gather(pool, table, impl="torch")
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"paged_gather mismatch on {name} leaves")
    report["paged_gather"] = {"max_abs_err": 0.0}
    log("paged_gather: bit-exact on int8 / packed int4 / bf16 / f32-scale leaves and 15-byte "
        "pages, ids past the pool and negative ids included")


# ------------------------------------------------------------- phase 3 - 6


def requests(cfg, Request):
    import numpy as np

    rng = np.random.RandomState(SEED)
    return [Request(rid=i, prompt=rng.randint(1, cfg.vocab, size=n).astype(np.int32),
                    max_new=MAX_NEW) for i, n in enumerate(PROMPT_LENS)]


def serve(torch, dev, cfg, policy, params, cache, fused_attn=True):
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(params, cfg, policy, n_slots=N_SLOTS, s_max=S_MAX, cache=cache,
                      page_size=PAGE_SIZE if cache == "paged" else None,
                      fused_attn=fused_attn, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.run(requests(cfg, Request))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m = eng.metrics()
    toks = m["tokens_generated"]
    log(f"serve[{cache}{'' if fused_attn else ', unfused'}]: {toks} tokens in {dt:.3f} s ({toks / dt:.2f} tokens/s end to end), "
        f"{m['decode_steps']} decode steps, step EMA {m['step_ema_s'] * 1e3:.2f} ms, "
        f"TTFT p50 {m['slo/ttft_p50_s']:.3f} s, TPOT p50 {m['slo/tpot_p50_s'] * 1e3:.2f} ms, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for rid, t in out.items():
        if len(t) != MAX_NEW or not all(0 <= x < cfg.vocab_padded for x in t):
            raise AssertionError(f"request {rid}: bad output {t}")
    return out, m


def reference_layer_path(torch, dev):
    """Phase 4: the quickstart and the 27-cell sweep on the card against
    their CPU runs, then the three phases unfused against the fused conv.
    Returns the launch counts of the card runs."""
    from repro_torch.core import pack as P
    from repro_torch.examples import mixed_precision_sweep, quickstart
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import im2col

    cpu_q = quickstart.main(device="cpu")
    cpu_s = mixed_precision_sweep.main(device="cpu")
    build.reset_launches()  # the Reference-Layer path starts here
    q = quickstart.main(device=dev)
    rows = mixed_precision_sweep.main(device=dev)
    for row in rows:  # im2col -> MatMul (int32 out) -> QntPack, unfused
        b = row["bits"]
        cols_p = P.pack(im2col(row["x_p"], b["x_bits"]).to(torch.uint8), b["x_bits"])
        phi = ops.mpmm(cols_p, row["w_p"], row["rq"], out_kind="int32", **b)
        y3 = ops.qntpack(phi, row["rq"], y_bits=b["y_bits"]).reshape(row["y_p"].shape)
        if not torch.equal(y3, row["y_p"]):
            raise AssertionError(f"three phases unfused differ from the fused conv2d: {row['name']}")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # the Reference-Layer path ends here
    worst = abs(q["err"] - cpu_q["err"])
    if not torch.equal(q["y_p"].cpu(), cpu_q["y_p"]):
        raise AssertionError("quickstart: card and CPU ofmaps differ")
    for a, c in zip(rows, cpu_s, strict=True):
        if not torch.equal(a["y_p"].cpu(), c["y_p"]):
            raise AssertionError(f"sweep {a['name']}: card and CPU ofmaps differ")
        worst = max(worst, abs(a["err"] - c["err"]))
    if worst > 1e-6:
        raise AssertionError(f"card and CPU mean errors differ by {worst}")
    log(f"reference layer: quickstart + 27-cell sweep on the card equal the CPU run bit for bit "
        f"(largest mean-error difference {worst:.3g}); three phases unfused equal the fused "
        f"conv2d on all 27 cells; launches {launches}")
    for name in ("conv2d", "qntpack", "mpmm"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the Reference-Layer path")
    return launches


def teacher_forced(torch, dev, cfg, policy, params, report, key="teacher_forced"):
    """One decode step from the same prefilled cache, kernel path vs plain."""
    from repro_torch.models import model as M
    from repro_torch.serve import Request
    from repro_torch.serve.cache import SlotCache
    from repro_torch.serve.prefill import ChunkedPrefill

    cache = SlotCache(cfg, policy, N_SLOTS, S_MAX, device=dev)
    pre = ChunkedPrefill(params, cfg, policy, chunk=16, device=dev)
    reqs = requests(cfg, Request)
    for s, r in enumerate(reqs):
        cache.acquire(len(r.prompt) + MAX_NEW)
        pre.prefill(cache, s, r.prompt)
    toks = torch.tensor([[int(r.prompt[-1])] for r in reqs], dtype=torch.int32, device=dev)
    pos = torch.from_numpy(cache.pos.copy()).to(dev)
    out = {}
    for impl in ("auto", "torch"):
        caches = [{k: a.clone() for k, a in layer.items()} for layer in cache.caches]
        out[impl] = M.decode_step(params, toks, pos, caches, cfg, policy, impl=impl,
                                  fused_attn=True)[:, -1].float()
    torch.cuda.synchronize()
    a, b = out["auto"], out["torch"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("teacher-forced logits are not finite")
    diff = float((a - b).abs().max())
    agree = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    log(f"{key} ({cfg.name}, {cfg.n_layers} layers, full width): max |logit kernel - plain| = "
        f"{diff:.4g}, argmax agree: {agree}, logit scale {float(b.abs().max()):.4g}")
    report[key] = {"max_logit_diff": diff, "argmax_agree": agree}


# ---------------------------------------------------------------- phase 5


def device_ms(fn, reps: int = 5, warmup: int = 2) -> tuple[float, float, str]:
    """Medians over ``reps`` calls of ``fn()``: the device time of the
    kernels it launches (torch.profiler, CUPTI, one window per call) and the
    wall time between CUDA events. On the card the profiler loses the first
    few device events of a window, so each window is a profiler schedule
    whose first (warm-up) step runs ``fn`` untimed and whose second step is
    read; the result names the kernels seen against the kernels the port's
    wrappers launched. Falls back to the events where no window shows
    device time."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import build

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    walls, devs = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end))
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            n0 = sum(build.LAUNCHES.values())
            fn()
            torch.cuda.synchronize()
            launched = sum(build.LAUNCHES.values()) - n0
            prof.step()
        seen = [e for e in prof.key_averages()
                if (getattr(e, "self_device_time_total", 0) or 0) > 0]
        devs.append((sum(e.count for e in seen),
                     sum(e.self_device_time_total for e in seen) / 1e3, launched))
    wall = statistics.median(walls)
    most = max(n for n, _, _ in devs)
    if most == 0:
        return wall, wall, "events"
    kept = [t for n, t, _ in devs if n == most]
    launched = devs[0][2]
    return (statistics.median(kept), wall,
            f"profiler, {len(kept)}/{reps} windows of {most} kernels, {launched} launched")


def linears(params):
    """Every projection of one decode step, in call order: (params, K)."""
    out = []
    for layer in params["layers"]:
        a, m = layer["attn"], layer["mlp"]
        out += [a["wq"], a["wk"], a["wv"], a["wo"], m["up"], m["gate"], m["down"]]
    return out + [params["head"]]


def kernel_table(torch, dev, cfg, params, launches, report):
    """Per decode step (4 slots): each kernel's calls timed on the card over
    the step's real operands (every layer's own weights and cache, so the
    50 MB L2 holds none of them between uses), beside their bound and their
    plain version's time."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    B, L = N_SLOTS, cfg.n_layers
    rows = []

    # mpmm: the 169 projections of one decode step, cell (8, 4, 8), f32 out
    lin = linears(params)

    def mm_step(M, impl):
        xs = {}
        for p in lin:
            K = p["w_packed"].shape[1] * 2
            if K not in xs:
                xs[K] = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                                      dtype=torch.int32).to(torch.int8)
        kw = dict(x_bits=8, w_bits=4, y_bits=8, x_signed=True, out_kind="f32")
        return lambda: [ops.mpmm(xs[p["w_packed"].shape[1] * 2], p["w_packed"], None,
                                 out_scale=p["eps_w"], impl=impl, **kw) for p in lin]

    for N, K, calls in main_path_mm_shapes(cfg):
        p = next(q for q in lin if tuple(q["w_packed"].shape) == (N, K // 2))
        for M in (B, 16):
            x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
            one, _, _ = device_ms(lambda: ops.mpmm(
                x, p["w_packed"], None, x_bits=8, w_bits=4, y_bits=8, x_signed=True,
                out_kind="f32", out_scale=p["eps_w"], impl="cuda"))
            log(f"  mpmm M={M} N={N} K={K}: {one * 1e3:.1f} us device per call "
                f"(weights L2-warm), x{calls} per decode step")
    t, tw, how = device_ms(mm_step(B, "cuda"))
    tp, tpw, _ = device_ms(mm_step(B, "torch"), reps=3, warmup=1)
    t16, t16w, _ = device_ms(mm_step(16, "cuda"))
    log(f"  mpmm, one decode step (169 calls, M={B}): {t:.3f} ms device ({how}), {tw:.3f} ms "
        f"wall; plain {tp:.3f} ms device, {tpw:.3f} ms wall; at M=16 (a prefill chunk's "
        f"shapes): {t16:.3f} ms device, {t16w:.3f} ms wall")
    nbytes = sum(B * p["w_packed"].shape[1] * 2 + p["w_packed"].numel()
                 + B * p["w_packed"].shape[0] * 4 + 4 for p in lin)
    nops = sum(2 * B * p["w_packed"].shape[0] * p["w_packed"].shape[1] * 2 for p in lin)
    rows.append(dict(name="mpmm", route="cuda", source="src/repro_torch/csrc/mpmm.cu",
                     replaces="src/repro/kernels/mpmm.py:122", ms=t, plain_ms=tp,
                     bytes=nbytes, ops=nops, peak=INT8_OPS_PER_S, library_ms=None))

    # paged_attn: one call per layer at kv8, each layer on its own page pool
    cases = [attn_case(torch, dev, cfg, 8, g) for _ in range(L)]
    kw = dict(bits=8)

    def attn_step(impl):
        return lambda: [ops.paged_attn(q, k, ks, v, vs, pos, block_table=bt, impl=impl, **kw)
                        for q, k, ks, v, vs, pos, bt in cases]

    t, tw, how = device_ms(attn_step("cuda"))
    tp, tpw, _ = device_ms(attn_step("torch"), reps=3, warmup=1)
    pos = cases[0][5]
    valid = sum(int(p) + 1 for p in pos.tolist())
    row_bytes = cfg.kv_heads * (cfg.head_dim + 4)  # int8 row + f32 scale, per token
    q, bt = cases[0][0], cases[0][6]
    nbytes = L * (2 * valid * row_bytes + 2 * q.numel() * 4 + bt.numel() * 4 + B * 4)
    nops = L * 4 * cfg.n_heads * cfg.head_dim * valid
    log(f"  paged_attn kv8, one decode step ({L} calls, B={B}, {valid} cached rows per "
        f"layer): {t:.3f} ms device ({how}), {tw:.3f} ms wall; plain {tp:.3f} ms device, "
        f"{tpw:.3f} ms wall")
    rows.append(dict(name="paged_attn", route="cuda", source="src/repro_torch/csrc/paged_attn.cu",
                     replaces="src/repro/kernels/paged_attn.py:142", ms=t, plain_ms=tp,
                     bytes=nbytes, ops=nops, peak=F32_FLOPS_PER_S, library_ms=None))

    # paged_scatter: the 4 leaves of every layer's pool take one new row per slot
    news = [torch.ones((B, 1, *a.shape[2:]), dtype=a.dtype, device=dev)
            for c in cases for a in (c[1], c[2], c[3], c[4])]
    leaves = [(a, c[5], c[6]) for c in cases for a in (c[1], c[2], c[3], c[4])]

    def scatter_step(impl):
        return lambda: [ops.paged_scatter(a, n, p, b, impl=impl)
                        for (a, p, b), n in zip(leaves, news)]

    idx = []
    for a, p, b in leaves:
        page = b.long().gather(1, (p.long() // PAGE_SIZE)[:, None])[:, 0]
        idx.append((page, p.long() % PAGE_SIZE))
    lib_step = lambda: [a.index_put_(ix, n[:, 0])  # noqa: E731
                        for (a, _, _), n, ix in zip(leaves, news, idx)]
    t, tw, how = device_ms(scatter_step("cuda"))
    tp, tpw, _ = device_ms(scatter_step("torch"))
    tl, tlw, _ = device_ms(lib_step)
    nbytes = sum(2 * n.numel() * n.element_size() + B * 8 for n in news)
    log(f"  paged_scatter, one decode step ({len(leaves)} calls): {t:.4f} ms device ({how}), "
        f"{tw:.3f} ms wall; plain {tp:.4f} ms device, {tpw:.3f} ms wall; index_put_ "
        f"{tl:.4f} ms device, {tlw:.3f} ms wall")
    rows.append(dict(name="paged_scatter", route="cuda",
                     source="src/repro_torch/csrc/paged_scatter.cu",
                     replaces="src/repro/kernels/paged_gather.py:91", ms=t, plain_ms=tp,
                     bytes=nbytes, ops=0, peak=F32_FLOPS_PER_S, library_ms=tl))

    # paged_gather: the unfused step reads the 4 leaves of every layer's pool
    # through the block table (B = 4, 64 pages each)
    gleaves = [(a, c[6]) for c in cases for a in (c[1], c[2], c[3], c[4])]

    def gather_step(impl):
        return lambda: [ops.paged_gather(a, b, impl=impl) for a, b in gleaves]

    lib_gather = lambda: [a.index_select(0, b.flatten())  # noqa: E731
                          for a, b in gleaves]
    t, tw, how = device_ms(gather_step("cuda"))
    tp, tpw, _ = device_ms(gather_step("torch"))
    tl, tlw, _ = device_ms(lib_gather)
    nbytes = sum(2 * b.numel() * a[0].numel() * a.element_size() + b.numel() * 4
                 for a, b in gleaves)
    log(f"  paged_gather, one unfused decode step ({len(gleaves)} calls, {nbytes / 1e6:.1f} MB "
        f"moved): {t:.4f} ms device ({how}), {tw:.3f} ms wall; plain {tp:.4f} ms device, "
        f"{tpw:.3f} ms wall; index_select {tl:.4f} ms device, {tlw:.3f} ms wall")
    rows.append(dict(name="paged_gather", route="cuda",
                     source="src/repro_torch/csrc/paged_gather.cu",
                     replaces="src/repro/kernels/paged_gather.py:52", ms=t, plain_ms=tp,
                     bytes=nbytes, ops=0, peak=F32_FLOPS_PER_S, library_ms=tl))

    # qntpack and conv2d: per call, timed over CALLS back-to-back launches
    # of the kernel's wrapper with the requant vector already on the card
    # (one launch alone is below what the profiler resolves; ops.* would add
    # the vector's host-to-device copy to every call)
    from repro_torch.core import quant as Q
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.kernels.mpmm import requant_vector
    from repro_torch.kernels.qntpack import qntpack_cuda
    from repro_torch.kernels.ref import conv2d_ref, qntpack_ref

    def per_call(fn):
        t, tw, how = device_ms(lambda: [fn() for _ in range(CALLS)])
        return t / CALLS, tw / CALLS, how

    # qntpack at the Tab. 1 shape, y = 4 (the quickstart's width)
    phi = torch.randint(-(1 << 20), 1 << 20, TAB1, generator=g, device=dev, dtype=torch.int32)
    rq = Q.make_requant_params(y_bits=4, eps_phi=2.0**-17, eps_y=1.0, lam=float(1 << 20))
    rqv = requant_vector(rq).to(dev)
    t, tw, how = per_call(lambda: qntpack_cuda(phi, rqv, y_bits=4))
    tp, tpw, _ = per_call(lambda: qntpack_ref(phi, rq, y_bits=4))
    M_, N_ = TAB1
    log(f"  qntpack y=4 at (M, N) = {TAB1}: {t * 1e3:.2f} us device per call ({how}), "
        f"{tw * 1e3:.2f} us wall; plain {tp * 1e3:.2f} us device, {tpw * 1e3:.2f} us wall")
    rows.append(dict(name="qntpack", route="cuda", source="src/repro_torch/csrc/qntpack.cu",
                     replaces="src/repro/kernels/qntpack.py:28", ms=t, plain_ms=tp,
                     bytes=4 * M_ * N_ + M_ * N_ // 2 + rqv.numel() * 4, ops=15 * M_ * N_,
                     peak=F32_FLOPS_PER_S, library_ms=None))

    # conv2d: the quickstart's cell (8, 4, 4) at the paper's shape, and at
    # 224 x 224 with the paper's widths (C 32 -> 64)
    paper = ref_layer()
    for H, W, C, Cout in (paper, (224, 224, *paper[2:])):
        x_p, w_p, rq = conv_operands(torch, g, dev, H, W, C, Cout, 8, 4, 4)
        rqv = requant_vector(rq).to(dev)
        bits = dict(x_bits=8, w_bits=4, y_bits=4)
        t, tw, how = per_call(lambda: conv2d_cuda(x_p, w_p, rqv, **bits))
        tp, tpw, _ = per_call(lambda: conv2d_ref(x_p, w_p, rq, **bits))
        nbytes = x_p.numel() + w_p.numel() + H * W * Cout // 2 + rqv.numel() * 4
        nops = 2 * H * W * Cout * 9 * C
        bound = max(nbytes / HBM_BYTES_PER_S, nops / INT8_OPS_PER_S) * 1e3
        log(f"  conv2d (8, 4, 4) at {H}x{W}, {C} -> {Cout}: {t * 1e3:.2f} us device per call "
            f"({how}), {tw * 1e3:.2f} us wall; plain {tp * 1e3:.1f} us device, "
            f"{tpw * 1e3:.1f} us wall; bound {bound * 1e3:.4f} us")
        if (H, W) == paper[:2]:
            rows.append(dict(name="conv2d", route="cuda", source="src/repro_torch/csrc/conv2d.cu",
                             replaces="src/repro/kernels/conv2d.py:71", ms=t, plain_ms=tp,
                             bytes=nbytes, ops=nops, peak=INT8_OPS_PER_S, library_ms=None))

    return [kernel_row(r, launches, report) for r in rows]


def kernel_row(r, launches, report) -> dict:
    """One entry of the kernels line: the bound from the row's bytes and
    operations, the launches of its path, its check's largest error."""
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = r["ops"] / r["peak"] * 1e3
    return {
        "name": r["name"], "route": r["route"], "source": r["source"],
        "replaces": r["replaces"], "launches": int(launches.get(r["name"], 0)),
        "max_abs_err": report[r["name"]]["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": r["library_ms"],
    }


#: device kernels the step breakdown names (everything else is PyTorch's)
KERNEL_NAMES = ("mpmm_kernel", "paged_mla_attn_kernel", "paged_attn_kernel",
                "paged_scatter_kernel", "paged_gather_kernel")


def step_breakdown(torch, dev, cfg, policy, params):
    """Profile one full-width decode step on the kernel path: wall time,
    device busy time (so the idle share), and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    caches = M.init_cache(cfg, policy, N_SLOTS, S_MAX, device=dev)
    toks = torch.ones((N_SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([n + MAX_NEW - 1 for n in PROMPT_LENS], dtype=torch.int32, device=dev)
    step = lambda: M.decode_step(params, toks, pos, caches, cfg, policy,  # noqa: E731
                                 fused_attn=True)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by: dict = {}
    ops_ms: dict = {}
    n_kernels = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        n_kernels += e.count
        key = next((k for k in KERNEL_NAMES if k in e.key), "other (PyTorch ops)")
        by[key] = by.get(key, 0.0) + us / 1e3
        ops_ms[e.key[:60]] = ops_ms.get(e.key[:60], 0.0) + us / 1e3
    busy = sum(by.values())
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    top = "; ".join(f"{k} {v:.3f} ms" for k, v in
                    sorted(ops_ms.items(), key=lambda kv: -kv[1])[:6])
    log(f"decode step breakdown ({cfg.name}, {cfg.n_layers} layers, slot cache, 4 slots at "
        f"159..543 cached rows): wall "
        f"{wall:.2f} ms (no profiler), device busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle), {n_kernels} device kernels; {parts}")
    log(f"  top device ops: {top}")


def mla_path(torch, dev, policy, report) -> tuple[dict, dict]:
    """Phase 8: serve DeepSeek-V3 (three MLA-dense layers, full width) on the
    slot and paged caches, fused then unfused; the teacher-forced step, the
    step breakdown and paged_mla_attn's timing row. Returns (the raw kernel
    row, paged_mla_attn's launches on the fused runs)."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import build, ops
    from repro_torch.models import model as M

    cfg = dataclasses.replace(configs.get_arch(MLA_ARCH), n_layers=MLA_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.init_params(gen, cfg, policy, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    log(f"params: {cfg.name} cut to {cfg.n_layers} layers ({M._layer_kinds(cfg)}), w4a8, "
        f"{nbytes / 1e9:.2f} GB, {time.perf_counter() - t0:.1f} s to draw on the card")

    build.reset_launches()  # the fused MLA serving path starts here
    out_slot, _ = serve(torch, dev, cfg, policy, params, "slot")
    out_paged, _ = serve(torch, dev, cfg, policy, params, "paged")
    fused_launches = dict(build.LAUNCHES)  # the fused MLA serving path ends here
    log(f"launches on the fused MLA path: {fused_launches}")
    if out_slot != out_paged:
        raise AssertionError("MLA: slot and paged token streams differ")
    for name in ("mpmm", "paged_mla_attn", "paged_scatter"):
        if fused_launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the fused MLA path")
    build.reset_launches()  # the unfused MLA serving path starts here
    unf_slot, _ = serve(torch, dev, cfg, policy, params, "slot", fused_attn=False)
    unf_paged, _ = serve(torch, dev, cfg, policy, params, "paged", fused_attn=False)
    unf_launches = dict(build.LAUNCHES)  # the unfused MLA serving path ends here
    log(f"launches on the unfused MLA path: {unf_launches}")
    if unf_slot != unf_paged:
        raise AssertionError("MLA: unfused slot and unfused paged token streams differ")
    if unf_launches.get("paged_gather", 0) == 0 or unf_launches.get("paged_mla_attn", 0):
        raise AssertionError(f"MLA unfused path: paged_gather must run, paged_mla_attn not: "
                             f"{unf_launches}")
    same = sum(a == b for rid in out_paged for a, b in zip(out_paged[rid], unf_paged[rid]))
    log(f"MLA: slot and paged streams identical, fused and unfused; {same} of "
        f"{sum(len(t) for t in out_paged.values())} tokens of the unfused streams equal the "
        f"fused ones (not gated: the two softmax sum in another order)")

    teacher_forced(torch, dev, cfg, policy, params, report, key="teacher_forced_mla")
    step_breakdown(torch, dev, cfg, policy, params)

    # paged_mla_attn per decode step: one call per layer at kv8, each layer
    # on its own latent pool, at the serving run's positions. The window
    # times COLD_STEPS steps over distinct pools (more bytes than the 50 MB
    # L2 holds), as a real step finds its latents cold behind mpmm's weight
    # stream; the times are per step
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    scale = 1.0 / (cfg.d_nope + cfg.d_rope) ** 0.5
    L, B, H, C, dr = cfg.n_layers, N_SLOTS, cfg.n_heads, cfg.kv_lora, cfg.d_rope
    cases = [mla_case(torch, dev, cfg, 8, g) for _ in range(L * COLD_STEPS)]

    def step(impl, cs=cases, bits=8):
        return lambda: [ops.paged_mla_attn(ql, qr, c, s_, r, p, bits=bits, scale=scale,
                                           block_table=bt, impl=impl)
                        for ql, qr, c, s_, r, p, bt in cs]

    def per_step(fn, **kw):
        t_dev, t_wall, how = device_ms(fn, **kw)
        return t_dev / COLD_STEPS, t_wall / COLD_STEPS, how

    t, tw, how = per_step(step("cuda"))
    tp, tpw, _ = per_step(step("torch"), reps=3, warmup=1)
    pos = cases[0][5]
    valid = sum(int(p) + 1 for p in pos.tolist())
    row_bytes = C + 4 + 2 * dr  # int8 latent row, its f32 scale, the bf16 rope row
    nbytes = L * (valid * row_bytes + B * H * (C + dr) * 4 + B * H * C * 4
                  + cases[0][6].numel() * 4 + B * 4)
    nops = L * H * valid * (2 * (C + dr) + 2 * C)
    log(f"  paged_mla_attn kv8, one decode step ({L} calls, B={B}, H={H}, {valid} cached rows "
        f"per layer; L2-cold): {t:.4f} ms device ({how}), {tw:.3f} ms wall; plain {tp:.3f} ms "
        f"device, {tpw:.3f} ms wall")
    warm = [cases[0]] * L  # the same pool three times: L2-warm
    tww, _, _ = device_ms(step("cuda", warm))
    log(f"  paged_mla_attn kv8, the same step L2-warm (one pool, {L} calls): {tww:.4f} ms device")

    # the library yardstick: SDPA on the bf16 cell over the dense slot view,
    # q = [q_lat | q_rope], k = [c | r] (one key row shared by all heads),
    # v = c, the same scale, a boolean mask from pos; f32 throughout
    bcases = [mla_case(torch, dev, cfg, None, g) for _ in range(L * COLD_STEPS)]
    tb = per_step(step("cuda", bcases, None))[0]
    sdpa_in, worst = [], 0.0
    for ql, qr, c, _s, r, p, bt in bcases:
        dense = lambda x: x[bt.long()].reshape(B, S_MAX, *x.shape[2:])  # noqa: E731
        cd, rd = dense(c)[:, :, 0].float(), dense(r)[:, :, 0].float()
        q = torch.cat([ql, qr], dim=-1)[:, :, None]  # (B, H, 1, C + dr)
        k = torch.cat([cd, rd], dim=-1)[:, None].expand(B, H, S_MAX, C + dr)
        v = cd[:, None].expand(B, H, S_MAX, C)
        mask = (torch.arange(S_MAX, device=dev)[None] <= p[:, None].long())[:, None, None]
        sdpa_in.append((q, k, v, mask))
    sdpa = lambda: [F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)  # noqa: E731
                    for q, k, v, m in sdpa_in]
    for lib, kern in zip(sdpa(), step("cuda", bcases, None)()):
        worst = max(worst, float((lib[:, :, 0] - kern).abs().max()))
    tl, tlw, _ = per_step(sdpa)
    log(f"  paged_mla_attn bf16 cell, one decode step (L2-cold): {tb:.4f} ms device; "
        f"F.scaled_dot_product_attention (f32, dense view, boolean mask) {tl:.4f} ms device, "
        f"{tlw:.3f} ms wall; max |SDPA - kernel| = {worst:.3e}")
    del params, cases, bcases, sdpa_in
    row = dict(name="paged_mla_attn", route="cuda",
               source="src/repro_torch/csrc/paged_mla_attn.cu",
               replaces="src/repro/kernels/paged_attn.py:299", ms=t, plain_ms=tp,
               bytes=nbytes, ops=nops, peak=F32_FLOPS_PER_S, library_ms=tl)
    return row, {"paged_mla_attn": fused_launches["paged_mla_attn"]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"gpu: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.ensure_built()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.BUILD_SECONDS:.1f} s)")
    for name, text in build.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"  ptxas[{name}]: {line.strip()}")

    cfg = configs.get_arch("internlm2-1.8b")
    policy = get_policy("w4a8")
    report: dict = {}
    check_mpmm(torch, dev, cfg, report)
    check_paged_scatter(torch, dev, cfg, report)
    check_paged_attn(torch, dev, cfg, report)
    check_conv2d(torch, dev, report)
    check_qntpack(torch, dev, report)
    check_paged_gather(torch, dev, cfg, report)
    check_paged_mla_attn(torch, dev, configs.get_arch(MLA_ARCH), report)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.init_params(gen, cfg, policy, device=dev)
    torch.cuda.synchronize()
    log(f"params: internlm2-1.8b w4a8, {time.perf_counter() - t0:.1f} s to draw on the card")

    build.reset_launches()  # the serving path starts here
    out_slot, _ = serve(torch, dev, cfg, policy, params, "slot")
    slot_launches = dict(build.LAUNCHES)
    out_paged, _ = serve(torch, dev, cfg, policy, params, "paged")
    launches = dict(build.LAUNCHES)  # the serving path ends here
    log(f"launches on the serving path: slot {slot_launches}, slot + paged {launches}")
    if out_slot != out_paged:
        raise AssertionError("slot and paged token streams differ")
    log("slot and paged token streams identical")
    for name in ("mpmm", "paged_attn", "paged_scatter"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")

    ref_launches = reference_layer_path(torch, dev)

    build.reset_launches()  # the unfused paged read starts here
    unf_slot, _ = serve(torch, dev, cfg, policy, params, "slot", fused_attn=False)
    unf_paged, _ = serve(torch, dev, cfg, policy, params, "paged", fused_attn=False)
    unf_launches = dict(build.LAUNCHES)  # the unfused paged read ends here
    log(f"launches on the unfused path: {unf_launches}")
    if unf_slot != unf_paged:
        raise AssertionError("unfused slot and unfused paged token streams differ")
    if unf_launches.get("paged_gather", 0) == 0:
        raise AssertionError("kernel paged_gather was not launched on the unfused paged path")
    same = sum(a == b for rid in out_paged for a, b in zip(out_paged[rid], unf_paged[rid]))
    log(f"unfused slot and unfused paged token streams identical; {same} of "
        f"{sum(len(t) for t in out_paged.values())} tokens equal the fused paged streams "
        f"(not gated: the fused and unfused softmax sum in another order)")
    launches.update({k: ref_launches.get(k, 0) for k in ("conv2d", "qntpack")})
    launches["paged_gather"] = unf_launches["paged_gather"]

    teacher_forced(torch, dev, cfg, policy, params, report)
    step_breakdown(torch, dev, cfg, policy, params)
    rows = kernel_table(torch, dev, cfg, params, launches, report)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mla_row, mla_launches = mla_path(torch, dev, policy, report)
    rows.append(kernel_row(mla_row, mla_launches, report))
    log(gpu_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
