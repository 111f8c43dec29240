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
     a window (tolerance ATTN_TOL), each call twice bit-identical and each
     slot's output the same alone, in the batch and beside other positions;
     conv2d on all 27 cells at the paper's
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
     conv2d, also at 224 x 224, and qntpack; wdqmm's and flash_mha's rows
     are timed at the end of phases 10 and 11, after their paths ran);
     paged_attn per step at kv8 (the row), kv4 and on the bf16 cell; kv8
     and the bf16 cell each beside ``F.scaled_dot_product_attention`` in
     f32 over their K/V dequantized ahead of time (kv8 the row's library
     time, bf16 printed);
  8. the MLA serving path: ServeEngine serving DeepSeek-V3 at its published
     widths cut to its three dense (MLA) layers, policy w4a8 with an 8-bit
     latent cache, the same 4 greedy requests, on the slot cache and then
     the paged cache (fused decode: paged_mla_attn), then both again with
     ``fused_attn=False`` (the paged read through paged_gather); slot and
     paged streams identical, fused and unfused; then phase 9's five
     requests on a cold paged engine and on a prefix engine (streams
     identical, paged_copy launched); then a teacher-forced MLA
     decode step (kernel vs plain), the MLA step's breakdown, and
     paged_mla_attn's time per decode step beside its bound, its plain
     version and ``F.scaled_dot_product_attention`` on the bf16 cell.
     Phase 2 holds paged_mla_attn against its plain version on bf16 / kv8 /
     kv4 at H 128, C 512, dr 64, pages of 16 (tolerance ATTN_TOL). Then
     one more run: the same three layers weight-only w4 (WO_POLICY, the
     w4a8 weights with each ``beta`` dropped) with the 8-bit latent cache,
     slot then paged, fused: streams identical, wdqmm launched, mpmm not;
     then its teacher-forced step (kernel vs plain);
  9. the prefix path (run right after phase 5, on internlm2's weights):
     a 360-token shared system prompt (22 full pages and 8 rows) drawn from
     SEED and five requests: (a) shared + 152 unique tokens, (b) shared + 24
     other ones (diverging inside the partial page: a COW clone), (c) (a)
     again (the S-1 cap), (d) the shared prompt's first 256 tokens, (e) an
     unrelated 512-token prompt; served on a cold paged engine and then on a
     prefix engine. The streams must be identical, paged_copy must have
     launched, the hit rate must be above 0, at least 3 COW clones made and
     fewer prefill calls spent. Phase 2 holds paged_copy bit-exact against
     its plain version on every internlm2 kv8 and DeepSeek-V3 latent leaf
     (disjoint, overlapping and self-copies; host and device ids), and
     phase 7 times one COW clone (all 96 leaves);
 10. the weight-only path (run right after phase 7, on internlm2's weights):
     policy WO_POLICY (every projection and the head weight-only w4, bf16
     activations, 8-bit KV cache) over the w4a8 packed weights with each
     ``beta`` dropped, the 4 requests of phase 3 on the slot and then the
     paged cache, then phase 9's five requests on a cold paged and a prefix
     engine. Slot and paged streams identical, prefix streams identical to
     the cold paged ones; wdqmm, paged_attn, paged_scatter and paged_copy
     launched, mpmm not. Then a teacher-forced step (kernel vs plain), the
     step breakdown, and wdqmm's time per decode step (169 calls at M = 4)
     beside its bound, its plain version and one ``F.linear`` a projection
     over the same weights dequantized to bf16 ahead of time (the
     unquantized deployment). Phase 2 holds wdqmm against its plain version
     at w 8, 4 and 2 on internlm2's five main-path (N, K) and its head and
     on every (N, K) of DeepSeek-V3's MLA-dense path (wq_a, wq_b, wkv_a, wo,
     up and gate, down, head; wq_b's K 1536 ends in a partial staging
     chunk) at M = 4 and 16, and on a ragged shape (M 5, N 37, K 44: the scalar path), within WDQMM_TOL * sum_k |x w|,
     the same call twice bit-identical;
 11. whole-prompt prefill and whole-sequence scoring (run right after phase
     10, on internlm2's w4a8 weights): four prompts of PREFILL_LEN (512)
     tokens drawn from SEED; ``model.prefill_step`` writes them into a fresh
     dense cache (``init_cache(cfg, policy, 4, 1024)``) in one forward
     (flash_mha over the fresh bf16 k/v, the cache written kv8), then 32
     greedy fused decode steps run from that cache (paged_attn); then
     ``model.forward(mode="serve")`` scores the same tokens. Gates: flash_mha
     launched once a layer (24) in each call; forward's last-position
     logits bit-identical to prefill_step's; prefill_step on the kernel path
     against the plain path from the same tokens, argmax agreeing on all four
     prompts. Printed, not gated: both calls' wall time beside chunked
     prefill of the same prompts (ChunkedPrefill, chunks of 16), how far
     the greedy streams after the two prefills agree, and prefill_step's
     device time by kernel. Then flash_mha's time
     per prefill_step (24 calls at B 4, S 512, 16 / 8 heads, D 128) beside
     its bound (q . k at the bf16 rate, P . V as three bf16 products at the
     bf16 rate), its plain version and ``F.scaled_dot_product_attention``.
     Phase 2 holds flash_mha against its plain version (ATTN_TOL, each call
     twice bit-identical) on the reference test's shapes in f32 and bf16,
     internlm2's full shape in bf16 and f32 and in bf16 at the model's
     sizes, ragged Sq != Sk both ways, strided operands, a window whose last
     row sees one key and operands off 16-byte boundaries (the 4-byte
     staging path, bit-identical to the 16-byte one); a window that leaves
     rows with no key is refused by both; the bf16 kernel's SASS holds
     tensor-core instructions;
 12. decode attention over a dense quantized cache (run right after phase
     11): ``prefill_step`` writes phase 11's four prompts into a fresh kv8
     dense cache, one fused greedy decode step records each layer's query,
     cache and paged_attn output, and ``kernels.qkv_decode.qkv_decode`` (the
     module API, its only path, as in the reference) runs every layer's
     attention again at the shared pos PREFILL_LEN (24 launches). Gates,
     within ``row_tol`` (ATTN_TOL scaled to each attention row's score and
     value sizes; the elementwise ATTN_TOL is printed): qkv_decode against
     its plain version and against dequantize-then-attend in f32;
     paged_attn against the same with the bf16 rounding of the dequantized
     cache (the reference's oracle). Then
     qkv_decode's time per call (B 4, S 1024, 16 / 8 heads, D 128, pos 1023,
     kv8 and kv4) beside its bound, its plain version and
     ``F.scaled_dot_product_attention`` over K/V dequantized ahead of time.
     Phase 2 holds qkv_decode against its plain version (ATTN_TOL, each
     call twice bit-identical) on the reference test's shapes with pos at
     its edges (-1, 0, block ends) and at internlm2's full shape (kv8 and
     kv4, pos 0, 511, 1023);
 13. the sampled serving path (run right after phase 12, on internlm2's
     w4a8 weights): phase 3's four requests at temperature 0.8, top-k 40,
     top-p 0.95, request i with seed 1000 + i, on the slot and the paged
     cache; phase 9's five requests sampled the same way on a cold paged
     and a prefix engine; the four with request 0 greedy beside three
     sampled; the four at top-k 1. Gates: slot and paged streams identical,
     prefix identical to cold paged; the mixed batch's sampled streams equal
     their first run's and its greedy one phase 3's; top-k 1 equal to phase
     3's greedy streams or first parting at a token whose two best logits
     tie (read from the logits the engine sampled); mpmm, paged_attn and
     paged_scatter launched. Printed: a sampled decode step's device and
     wall time beside a greedy step's from the same cache, and the
     sampler's own device time.

Phases 3, 4, 5, 8, 9, 10, 11, 12 and 13 each start with every launch count
at 0 (phase 8 once for its fused runs, once for its unfused runs, once for
its weight-only runs and once for its prefix run; phase 10 once for its slot
and paged runs and once for its prefix run; phase 11 once for prefill_step
and its decode steps and once for forward; phase 13 once for its slot and
paged runs and once for its prefix run) and read the counts at their end;
the kernels line gives each kernel the count of its own path (paged_copy:
phase 9's prefix run; wdqmm: phase 10's slot and paged runs; flash_mha:
phase 11's prefill_step; qkv_decode: phase 12).

The line before the last is the kernels JSON, the last line the result
JSON.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
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
#: phase 11: four prompts of this many tokens, prefilled whole
PREFILL_LEN = 512
#: the prefix path: a shared system prompt of 22 full pages and 8 rows, and
#: the unique tail lengths of requests (a) and (b)
SHARED_LEN, UNIQ_A, UNIQ_B = 360, 152, 24
N_SLOTS, S_MAX, PAGE_SIZE = 4, 1024, 16
SEED = 0
#: the paper's Tab. 1 QntPack shape (M, N)
TAB1 = (256, 64)
#: launches per timed window for the per-call kernel times
CALLS = 50
#: phase 13: how the sampled requests decode, and the greedy / sampled
#: decode steps whose walls are compared
SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95)
STEP_PAIRS = 10


def wo_policy():
    """Every projection and the head weight-only w4 (bf16 activations),
    routers bf16, an 8-bit KV cache: the reference's ``_uniform`` with
    x = y = None."""
    from repro_torch.core.policy import BF16, LayerPrecision, PrecisionPolicy

    return PrecisionPolicy(name="w4only", default=LayerPrecision(None, 4, None),
                           per_class={"router": BF16}, kv_cache_bits=8)


def weight_only(params):
    """The same tree without each linear's ``beta``: a w4a8 model's packed
    weights served weight-only, with no second draw."""
    if isinstance(params, dict):
        return {k: weight_only(v) for k, v in params.items() if k != "beta"}
    if isinstance(params, list):
        return [weight_only(v) for v in params]
    return params


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


def mla_mm_shapes(mcfg):
    """(N, K) of every projection wdqmm serves on DeepSeek-V3's MLA-dense
    path: wq_a, wq_b, wkv_a, wo, up and gate, down, and the head (wkv_b is
    dequantized whole, not multiplied)."""
    from repro_torch.models import model as M

    a, f = mcfg.mla_cfg, M._mlp_cfg(mcfg, "mla_dense").d_ff
    H = a.n_heads
    return [(a.q_lora, a.d_model), (H * (a.d_nope + a.d_rope), a.q_lora),
            (a.kv_lora + a.d_rope, a.d_model), (a.d_model, H * a.d_v), (f, a.d_model),
            (a.d_model, f), (mcfg.vocab_padded, a.d_model)]


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


def check_wdqmm(torch, dev, cfg, mcfg, report):
    """wdqmm against its plain version (bf16 activations) at w 8, 4 and 2:
    the main-path (N, K) of internlm2 and of DeepSeek-V3's MLA-dense layers,
    heads included, at M = 4 and 16, and a ragged shape on the scalar path;
    within WDQMM_TOL * sum_k |x w| of the plain version, and the same call
    twice bit-identical."""
    from repro_torch.core import pack as P
    from repro_torch.kernels import ops
    from repro_torch.kernels.wdqmm import TOL

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    eps = torch.tensor(3.7e-3, device=dev)
    shapes = [(N, K) for N, K, _ in main_path_mm_shapes(cfg)]
    shapes += mla_mm_shapes(mcfg)  # wq_b's K 1536 ends in a partial staging chunk
    cases = [(M, N, K) for M in (N_SLOTS, 16) for N, K in shapes] + [(5, 37, 44)]
    worst = ratio = 0.0
    n = 0
    for wb in (8, 4, 2):
        for M, N, K in cases:
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            w_p = torch.randint(-128, 128, (N, K * wb // 8), generator=g, device=dev,
                                dtype=torch.int32).to(torch.int8)
            a = ops.wdqmm(x, w_p, eps, w_bits=wb, impl="cuda")
            again = ops.wdqmm(x, w_p, eps, w_bits=wb, impl="cuda")
            b = ops.wdqmm(x, w_p, eps, w_bits=wb, impl="torch")
            scale = x.float().abs() @ (P.unpack(w_p, wb, signed=True).float() * eps).abs().T
            torch.cuda.synchronize()
            err = (a - b).abs()
            if not torch.equal(a, again):
                raise AssertionError(f"wdqmm w={wb} {(M, N, K)}: two calls differ")
            if not torch.isfinite(a).all() or bool((err > TOL * scale).any()):
                raise AssertionError(f"wdqmm w={wb} {(M, N, K)}: |kernel - plain| "
                                     f"{float(err.max())} above {TOL} * sum |x w|")
            worst = max(worst, float(err.max()))
            ratio = max(ratio, float((err / scale.clamp_min(1e-30)).max()))
            n += 1
            del scale
    report["wdqmm"] = {"max_abs_err": worst, "tol": TOL, "max_err_ratio": ratio, "checks": n}
    log(f"wdqmm: {n} comparisons within {TOL:.3g} * sum |x w| of the plain version (largest "
        f"|kernel - plain| {worst:.3e}, at most {ratio:.3e} * sum |x w|), each call twice "
        f"bit-identical (w 8/4/2; internlm2 and DeepSeek-V3 main-path shapes and heads, "
        f"M = 4 and 16; ragged (5, 37, 44))")


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
        # the same call again, and each slot served alone or beside other
        # positions: the same bits (fixed splits, a fixed merge order)
        kw = dict(bits=bits, block_table=bt, window=100)
        a = ops.paged_attn(q, k, ks, v, vs, pos, impl="cuda", **kw)
        if not torch.equal(a, ops.paged_attn(q, k, ks, v, vs, pos, impl="cuda", **kw)):
            raise AssertionError(f"paged_attn bits={bits}: two calls differ")
        full = ops.paged_attn(q, k, ks, v, vs, pos, bits=bits, block_table=bt, impl="cuda")
        other = pos.clone()
        other[0], other[2] = int(pos[3]), 5
        moved = ops.paged_attn(q, k, ks, v, vs, other, bits=bits, block_table=bt, impl="cuda")
        alone = [ops.paged_attn(q[i:i + 1], k, ks, v, vs, pos[i:i + 1], bits=bits,
                                block_table=bt[i:i + 1], impl="cuda") for i in range(N_SLOTS)]
        if not (all(torch.equal(full[i:i + 1], x) for i, x in enumerate(alone))
                and torch.equal(full[1::2], moved[1::2])):
            raise AssertionError(f"paged_attn bits={bits}: a slot's output depends on the "
                                 f"other slots")
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
    log("paged_attn: each call twice bit-identical; each slot's output the same alone, in the "
        "batch and beside other positions")


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


def check_paged_copy(torch, dev, cfg, mcfg, report):
    """paged_copy against its plain version on every leaf of an internlm2
    kv8 layer and a DeepSeek-V3 latent layer, pages of 16: disjoint ids on
    the host (one launch), an overlap (a dst page read later as a src reads
    the original bits) and a self-copy, on host and on device ids (two
    launches through the staging buffer)."""
    from repro_torch.kernels import build, ops

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    P_ = N_SLOTS * (S_MAX // PAGE_SIZE) + 1
    hkv, d = cfg.kv_heads, cfg.head_dim
    leaves = {"k/v int8": (torch.int8, (hkv, d)), "k_s/v_s f32": (torch.float32, (hkv,)),
              "c int8": (torch.int8, (1, mcfg.kv_lora)), "c_s f32": (torch.float32, (1,)),
              "r bf16": (torch.bfloat16, (1, mcfg.d_rope))}
    cases = (([3, 17], [40, 41]), ([1, 2], [2, 3]), ([5, 7], [5, 9]))
    n = 0
    for name, (dtype, tail) in leaves.items():
        pool = torch.randn((P_, PAGE_SIZE, *tail), generator=g, device=dev).mul(40)
        pool = pool.clamp(-100, 100).to(dtype)
        for src, dst in cases:
            s_, d_ = (torch.tensor(x, dtype=torch.int32) for x in (src, dst))
            want = ops.paged_copy(pool.clone(), s_, d_, impl="torch")
            for ids in ((s_, d_), (s_.to(dev), d_.to(dev))):
                got = ops.paged_copy(pool.clone(), *ids, impl="cuda")
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"paged_copy mismatch on {name} src={src} dst={dst} "
                                         f"ids on {ids[0].device}")
                n += 1
    if build.LAUNCHES["paged_copy"] == 0:
        raise AssertionError("paged_copy was not launched in its check")
    report["paged_copy"] = {"max_abs_err": 0.0, "checks": n}
    log(f"paged_copy: {n} comparisons bit-exact ({', '.join(leaves)} leaves at pages of "
        f"{PAGE_SIZE}; disjoint, overlapping and self-copies; host and device ids)")


def flash_case(torch, g, dev, B, Sq, Sk, Hq, Hkv, D, dtype, layout="bshd", scales=(1, 1, 1),
               offset=0):
    """Random q, k, v in the model's (B, S, H, D) layout, each drawn from
    N(0, 1) times its entry of ``scales``; ``layout="bhsd"`` gives the same
    shapes as transposed views of (B, H, S, D) storage (the Pallas kernel's
    layout), which the kernel reads through its strides; ``offset`` bytes
    past a 16-byte boundary puts every operand's rows there (the kernel's
    4-byte staging path)."""
    def one(S, H, x):
        if layout == "bhsd":
            t = torch.randn((B, H, S, D), generator=g, device=dev).mul(x).to(dtype)
            return t.transpose(1, 2)
        t = torch.randn((B, S, H, D), generator=g, device=dev).mul(x).to(dtype)
        if offset:
            flat = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8, device=dev)
            nb = t.numel() * t.element_size()
            t = flat[offset:offset + nb].view(dtype).view(t.shape).copy_(t)
        return t

    return one(Sq, Hq, scales[0]), one(Sk, Hkv, scales[1]), one(Sk, Hkv, scales[2])


def sass_counts(lib, marker):
    """Per kernel function of a built library whose name holds ``marker``,
    the count of tensor-core (HMMA) and f32 FMA (FFMA) instructions in its
    SASS (``cuobjdump -sass``)."""
    from repro_torch.kernels import build

    tool = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            fn = name if marker in name else None
            if fn:
                counts[fn] = {"HMMA": 0, "FFMA": 0}
        elif fn:
            for op in ("HMMA", "FFMA"):
                counts[fn][op] += f" {op}." in line or f" {op} " in line
    return counts


def check_flash_mha(torch, dev, cfg, report):
    """flash_mha against its plain version on the card within ATTN_TOL
    (atol = rtol), each call twice bit-identical: the reference test's
    shapes (tests/test_ssm_attn.py: B 2, S 35, D 16; GQA 1 and 2; causal,
    full, window 10; f32, and bf16 causal and windowed), internlm2's full
    shape (B 4, S 512, 16 / 8 heads, D 128, causal; bf16 as the model passes
    it, and f32; bf16 also at the model's sizes: scores up to ~20, |v| up to
    ~14), a ragged Sq != Sk, operands read through (B, H, S, D) strides, a
    window whose last row sees one key (Sq = Sk + window - 1), and bf16
    operands 4 bytes past a 16-byte boundary (the 4-byte staging path; also
    bit-identical to the 16-byte path on the same values). Both refuse a
    window that leaves a row with no key (Sq 300, Sk 100, window 50). The
    bf16 kernel's SASS must hold tensor-core (HMMA) instructions, the f32
    kernel's none."""
    from repro_torch.kernels import build, ops

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    Hq, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    f32, bf16 = torch.float32, torch.bfloat16
    model = dict(scales=(2.0, 2.0, 2.8))  # scores up to ~20, |v| up to ~14
    cases = [((2, 35, 35, 2 * gqa, 2, 16, f32, "bshd"), causal, window, {})
             for gqa, causal, window in ((1, True, None), (2, True, None), (1, False, None),
                                         (1, True, 10))]
    cases += [((N_SLOTS, 512, 512, Hq, Hkv, D, bf16, "bshd"), True, None, {}),
              ((N_SLOTS, 512, 512, Hq, Hkv, D, f32, "bshd"), True, None, {}),
              ((2, 100, 300, Hq, Hkv, D, bf16, "bshd"), True, None, {}),
              ((2, 300, 100, Hq, Hkv, D, bf16, "bshd"), True, None, {}),
              ((2, 200, 200, Hq, Hkv, D, bf16, "bhsd"), True, 70, {}),
              ((2, 300, 100, Hq, Hkv, D, bf16, "bshd"), True, 201, {}),
              ((2, 35, 35, 4, 2, 16, bf16, "bshd"), True, None, {}),
              ((2, 130, 130, 4, 2, 16, bf16, "bhsd"), True, 10, {}),
              ((N_SLOTS, 512, 512, Hq, Hkv, D, bf16, "bshd"), True, None, model),
              ((2, 150, 150, Hq, Hkv, D, bf16, "bshd"), True, 70, dict(offset=4)),
              ((2, 130, 130, 4, 2, 16, bf16, "bshd"), True, 10, dict(offset=4))]
    worst = 0.0
    for (B, Sq, Sk, hq, hkv, d, dtype, layout), causal, window, extra in cases:
        q, k, v = flash_case(torch, g, dev, B, Sq, Sk, hq, hkv, d, dtype, layout, **extra)
        kw = dict(causal=causal, window=window)
        a = ops.flash_mha(q, k, v, impl="cuda", **kw)
        again = ops.flash_mha(q, k, v, impl="cuda", **kw)
        b = ops.flash_mha(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        err = (a - b).abs()
        name = (f"flash_mha B={B} Sq={Sq} Sk={Sk} {hq}/{hkv} heads D={d} {str(dtype)[6:]} "
                f"{layout} causal={causal} window={window}"
                + "".join(f" {key}={val}" for key, val in extra.items()))
        if not torch.equal(a, again):
            raise AssertionError(f"{name}: two calls differ")
        if extra.get("offset"):
            if q.data_ptr() % 16 == 0:
                raise AssertionError(f"{name}: operands on a 16-byte boundary")
            wide = ops.flash_mha(*(t.clone() for t in (q, k, v)), impl="cuda", **kw)
            if not torch.equal(a, wide):
                raise AssertionError(f"{name}: the 4-byte and 16-byte staging paths differ")
        if not torch.isfinite(a).all() or bool((err > ATTN_TOL * (1 + b.abs())).any()):
            raise AssertionError(f"{name}: max |kernel - plain| {float(err.max())} above "
                                 f"{ATTN_TOL} (atol = rtol)")
        share = float((err / (ATTN_TOL * (1 + b.abs()))).max())
        log(f"{name}: max |kernel - plain| = {float(err.max()):.3e} ({share:.4f} of the "
            f"tolerance), twice bit-identical")
        worst = max(worst, float(err.max()))
    q, k, v = flash_case(torch, g, dev, 2, 300, 100, Hq, Hkv, D, bf16)
    for impl in ("cuda", "torch"):
        try:
            ops.flash_mha(q, k, v, causal=True, window=50, impl=impl)
        except ValueError as e:
            log(f"flash_mha impl={impl} Sq=300 Sk=100 window=50: refused ({e})")
        else:
            raise AssertionError(f"flash_mha impl={impl} took rows that see no key")
    report["flash_mha"] = {"max_abs_err": worst, "tol": ATTN_TOL, "checks": len(cases) + 2}
    lib = build.library_path("flash_mha")
    for fn, c in sass_counts(lib, "flash_mha").items():
        log(f"  sass[{fn}]: {c['HMMA']} HMMA, {c['FFMA']} FFMA")
        if ("f32_kernel" in fn) == (c["HMMA"] > 0):
            raise AssertionError(f"{fn}: {c['HMMA']} tensor-core instructions; the bf16 "
                                 f"kernel must have some, the f32 kernel none")


def qkv_case(torch, g, dev, B, S, Hq, Hkv, D, bits):
    """q (B, Hq, D) and a dense cache of S rows quantized by the port's
    ``kv_quantize`` (int8 or packed int4 codes, f32 scales)."""
    from repro_torch.models import attention as A

    kq, ks = A.kv_quantize(torch.randn((B, S, Hkv, D), generator=g, device=dev), bits)
    vq, vs = A.kv_quantize(torch.randn((B, S, Hkv, D), generator=g, device=dev), bits)
    return torch.randn((B, Hq, D), generator=g, device=dev), kq, ks, vq, vs


def check_qkv_decode(torch, dev, cfg, report):
    """qkv_decode against its plain version on the card within ATTN_TOL
    (atol = rtol), each call twice bit-identical: the reference test's
    shapes (tests/test_ssm_attn.py: B 2, S 32, Hkv 2, D 16, bs 8; GQA 1 and
    2; kv8 and kv4) with pos at its edges (-1: nothing visible, the mean of
    v; 0; a block's last and the next block's first key), and internlm2's
    full shape (B 4, S 1024, 16 / 8 heads, D 128, kv8 and kv4, pos 0, 511
    and 1023)."""
    from repro_torch.kernels import qkv_decode as QD

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    Hq, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    cases = [(2, 32, 2 * gqa, 2, 16, bits, pos, bs)
             for bits, gqa, pos, bs in ((8, 1, 30, 8), (8, 2, 12, 8), (4, 1, 31, 8), (8, 2, -1, 8),
                                        (4, 2, 0, 32), (8, 1, 7, 8), (4, 2, 8, 8))]
    cases += [(N_SLOTS, S_MAX, Hq, Hkv, D, bits, pos, 512) for bits in (8, 4)
              for pos in (0, 511, 1023)]
    worst = 0.0
    for B, S, hq, hkv, d, bits, pos, bs in cases:
        q, kq, ks, vq, vs = qkv_case(torch, g, dev, B, S, hq, hkv, d, bits)
        a = QD.qkv_decode(q, kq, ks, vq, vs, pos, bits=bits, bs=bs)
        again = QD.qkv_decode(q, kq, ks, vq, vs, pos, bits=bits, bs=bs)
        b = QD.qkv_decode_plain(q, kq, ks, vq, vs, pos, bits=bits, bs=bs)
        torch.cuda.synchronize()
        err = (a - b).abs()
        name = f"qkv_decode B={B} S={S} {hq}/{hkv} heads D={d} kv{bits} pos={pos} bs={bs}"
        if not torch.equal(a, again):
            raise AssertionError(f"{name}: two calls differ")
        if not torch.isfinite(a).all() or bool((err > QD.TOL * (1 + b.abs())).any()):
            raise AssertionError(f"{name}: max |kernel - plain| {float(err.max())} above "
                                 f"{QD.TOL} (atol = rtol)")
        log(f"{name}: max |kernel - plain| = {float(err.max()):.3e}, twice bit-identical")
        worst = max(worst, float(err.max()))
    report["qkv_decode"] = {"max_abs_err": worst, "tol": QD.TOL, "checks": len(cases)}


# ------------------------------------------------------------- phase 3 - 6


def requests(cfg, Request):
    import numpy as np

    rng = np.random.RandomState(SEED)
    return [Request(rid=i, prompt=rng.randint(1, cfg.vocab, size=n).astype(np.int32),
                    max_new=MAX_NEW) for i, n in enumerate(PROMPT_LENS)]


def prefix_requests(cfg, Request):
    """Phase 9's five requests over one shared system prompt."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    shared = rng.randint(1, cfg.vocab, size=SHARED_LEN)
    a = np.concatenate([shared, rng.randint(1, cfg.vocab, size=UNIQ_A)])
    b = np.concatenate([shared, rng.randint(1, cfg.vocab, size=UNIQ_B)])
    e = rng.randint(1, cfg.vocab, size=512)
    if a[SHARED_LEN] == b[SHARED_LEN]:
        raise AssertionError("requests (a) and (b) must diverge inside the partial page")
    prompts = [a, b, a.copy(), shared[:256].copy(), e]
    return [Request(rid=i, prompt=p.astype(np.int32), max_new=MAX_NEW)
            for i, p in enumerate(prompts)]


def sampled_requests(reqs, greedy=(), **over):
    """The same requests sampled as phase 13 samples them (SAMPLING, request
    i with seed 1000 + i; ``over`` replaces fields), except the rids in
    ``greedy``."""
    from repro_torch.serve import SamplingParams

    for r in reqs:
        if r.rid not in greedy:
            r.params = SamplingParams(max_new=r.max_new, seed=1000 + r.rid,
                                      **{**SAMPLING, **over})
    return reqs


def serve(torch, dev, cfg, policy, params, cache, fused_attn=True, reqs=None, ties=None):
    """Serve ``reqs`` (default: phase 3's four greedy requests). With a dict
    ``ties``, record in it for each token a request draws whether the two
    best logits it was drawn from tie: {(rid, index): bool}."""
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(params, cfg, policy, n_slots=N_SLOTS, s_max=S_MAX, cache=cache,
                      page_size=PAGE_SIZE if cache != "slot" else None,
                      fused_attn=fused_attn, device=dev)
    shared = [0]

    def peak_shared(rid, tok):
        shared[0] = max(shared[0], eng.cache.pages_shared())

    sample_tokens = M.sample_tokens

    def recording(logits, *lanes):
        top = logits.float().topk(2, dim=-1).values.tolist()
        if logits.shape[0] == 1:  # admission: the request that has no token yet
            live = [next(r for r in eng.slot_req if r is not None and not r.out)]
        else:
            live = eng.slot_req
        for r, (a, b) in zip(live, top):
            if r is not None:
                ties[r.rid, len(r.out)] = a == b
        return sample_tokens(logits, *lanes)

    if ties is not None:
        M.sample_tokens = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = eng.run(reqs if reqs is not None else requests(cfg, Request),
                      on_token=peak_shared if cache == "prefix" else None)
    finally:
        M.sample_tokens = sample_tokens
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m = eng.metrics()
    m["peak_pages_shared"] = shared[0]
    toks = m["tokens_generated"]
    pages = (f", {m['prefill_jit_calls']} prefill calls, {m['cache/pages_drawn']} pages drawn"
             if cache != "slot" else "")
    if cache == "prefix":
        pages += (f", at most {shared[0]} pages shared by live requests, hit rate "
                  f"{m['cache/prefix_hit_rate']:.4f}, {m['cache/cow_copies']} COW clones")
    mode = "" if reqs is None or all(r.params is None or r.params.greedy for r in reqs) else (
        ", sampled")
    log(f"serve[{cfg.name}, {policy.name}, {cache}{'' if fused_attn else ', unfused'}{mode}]: {toks} tokens in {dt:.3f} s ({toks / dt:.2f} tokens/s end to end), "
        f"{m['decode_steps']} decode steps, step EMA {m['step_ema_s'] * 1e3:.2f} ms, "
        f"TTFT p50 {m['slo/ttft_p50_s']:.3f} s, TPOT p50 {m['slo/tpot_p50_s'] * 1e3:.2f} ms, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{pages}")
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


def prefix_path(torch, dev, cfg, policy, params, key="", sampled=False) -> tuple[dict, dict]:
    """Phase 9 (and phase 8's prefix run, and phase 13's with ``sampled``):
    the five requests on a cold paged engine, then on a prefix engine.
    Returns the prefix run's launch counts and the two engines' metrics."""
    from repro_torch.kernels import build
    from repro_torch.serve import Request

    def reqs():
        out = prefix_requests(cfg, Request)
        return sampled_requests(out) if sampled else out

    cold, mc = serve(torch, dev, cfg, policy, params, "paged", reqs=reqs())
    build.reset_launches()  # the prefix path starts here
    warm, mw = serve(torch, dev, cfg, policy, params, "prefix", reqs=reqs())
    launches = dict(build.LAUNCHES)  # the prefix path ends here
    log(f"launches on the {key}prefix path: {launches}")
    if warm != cold:
        raise AssertionError(f"{key}prefix streams differ from the cold paged streams")
    if launches.get("paged_copy", 0) == 0:
        raise AssertionError(f"kernel paged_copy was not launched on the {key}prefix path")
    if not (mw["cache/prefix_hit_rate"] > 0 and mw["cache/cow_copies"] >= 3):
        raise AssertionError(f"{key}prefix path: hit rate {mw['cache/prefix_hit_rate']}, "
                             f"{mw['cache/cow_copies']} COW clones (want > 0 and >= 3)")
    if not mw["prefill_jit_calls"] < mc["prefill_jit_calls"]:
        raise AssertionError(f"{key}prefix path: {mw['prefill_jit_calls']} prefill calls, cold "
                             f"{mc['prefill_jit_calls']}")
    log(f"{key}prefix streams identical to the cold paged streams; prefill calls "
        f"{mc['prefill_jit_calls']} -> {mw['prefill_jit_calls']}, pages drawn "
        f"{mc['cache/pages_drawn']} -> {mw['cache/pages_drawn']}, TTFT p50 "
        f"{mc['slo/ttft_p50_s']:.3f} -> {mw['slo/ttft_p50_s']:.3f} s")
    return launches, {"paged": mc, "prefix": mw}


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


def device_ms(fn, reps: int = 5, warmup: int = 2, names=None) -> tuple[float, float, str]:
    """Medians over ``reps`` calls of ``fn()``: the device time of the
    kernels it launches (torch.profiler, CUPTI, one window per call; only
    the device events whose name holds one of ``names``, when given) and
    the wall time between CUDA events. On the card the profiler loses the
    first few device events of a window, so each window is a profiler
    schedule whose first (warm-up) step runs ``fn`` untimed and whose second
    step is read; the result names the kernels seen against the kernels the
    port's wrappers launched. Falls back to the events where no window
    shows device time."""
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
                if (getattr(e, "self_device_time_total", 0) or 0) > 0
                and (names is None or any(n in e.key for n in names))]
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
                     bytes=nbytes, work=[(nops, INT8_OPS_PER_S)], library_ms=None))

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
    q, bt = cases[0][0], cases[0][6]

    def attn_bytes(row_bytes):  # K and V rows (and scales) once, q in, out, table, pos
        return L * (2 * valid * cfg.kv_heads * row_bytes + 2 * q.numel() * 4 + bt.numel() * 4
                    + B * 4)

    nbytes = attn_bytes(cfg.head_dim + 4)  # int8 row + f32 scale, per token and head
    nops = L * 4 * cfg.n_heads * cfg.head_dim * valid
    log(f"  paged_attn kv8, one decode step ({L} calls, B={B}, {valid} cached rows per "
        f"layer): {t:.4f} ms device ({how}), {tw:.3f} ms wall; plain {tp:.3f} ms device, "
        f"{tpw:.3f} ms wall")
    tl = paged_attn_library_ms(torch, dev, cfg, cases, 8)
    for bits, row_bytes in ((4, cfg.head_dim // 2 + 4), (None, 2 * cfg.head_dim)):
        other = [attn_case(torch, dev, cfg, bits, g) for _ in range(L)]
        tb, tbw, howb = device_ms(lambda other=other, bits=bits: [
            ops.paged_attn(q_, k, ks, v, vs, p_, bits=bits, block_table=b_, impl="cuda")
            for q_, k, ks, v, vs, p_, b_ in other])
        tag = "bf16 cell" if bits is None else f"kv{bits}"
        log(f"  paged_attn {tag}, one decode step ({L} calls): {tb:.4f} ms device ({howb}), "
            f"{tbw:.3f} ms wall; bound {attn_bytes(row_bytes) / HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"(bytes)")
        if bits is None:
            paged_attn_library_ms(torch, dev, cfg, other, None)
        del other
    rows.append(dict(name="paged_attn", route="cuda", source="src/repro_torch/csrc/paged_attn.cu",
                     replaces="src/repro/kernels/paged_attn.py:142", ms=t, plain_ms=tp,
                     bytes=nbytes, work=[(nops, F32_FLOPS_PER_S)], library_ms=tl))

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
                     bytes=nbytes, work=[], library_ms=tl))

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
                     bytes=nbytes, work=[], library_ms=tl))

    # paged_copy: one COW clone as the prefix cache makes it, one page on
    # every leaf of every layer (4 x 24 = 96 calls), host ids (one launch a
    # leaf, after the ids' upload); the kernel's own device time, then the
    # whole clone's (uploads included)
    from repro_torch.kernels.paged_gather import paged_copy_cuda, paged_copy_ref

    src, dst = torch.tensor([1], dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    cow = [(a, src, dst) for c in cases for a in (c[1], c[2], c[3], c[4])]
    cow_dev = [(a, s_.to(dev), d_.to(dev)) for a, s_, d_ in cow]
    t, tw, how = device_ms(lambda: [paged_copy_cuda(a, s_, d_) for a, s_, d_ in cow],
                           names=("paged_copy_kernel",))
    tall, _, _ = device_ms(lambda: [paged_copy_cuda(a, s_, d_) for a, s_, d_ in cow])
    tp, tpw, _ = device_ms(lambda: [paged_copy_ref(a, s_, d_) for a, s_, d_ in cow])
    tl, tlw, _ = device_ms(lambda: [a.index_copy_(0, d_.long(), a.index_select(0, s_.long()))
                                    for a, s_, d_ in cow_dev])
    nbytes = sum(2 * a[0].numel() * a.element_size() + 8 for a, _, _ in cow)
    log(f"  paged_copy, one COW clone ({len(cow)} calls, {nbytes / 1e6:.3f} MB moved): "
        f"{t * 1e3:.2f} us device in the kernel ({how}), {tall * 1e3:.2f} us with the ids' "
        f"uploads, {tw:.3f} ms wall; plain {tp:.4f} ms device, {tpw:.3f} ms wall; "
        f"index_select + index_copy_ (ids on the card) {tl:.4f} ms device, {tlw:.3f} ms wall")
    rows.append(dict(name="paged_copy", route="cuda", source="src/repro_torch/csrc/paged_copy.cu",
                     replaces="src/repro/kernels/paged_gather.py:141", ms=t, plain_ms=tp,
                     bytes=nbytes, work=[], library_ms=tl))

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
                     bytes=4 * M_ * N_ + M_ * N_ // 2 + rqv.numel() * 4,
                     work=[(15 * M_ * N_, F32_FLOPS_PER_S)], library_ms=None))

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
                             bytes=nbytes, work=[(nops, INT8_OPS_PER_S)], library_ms=None))

    return [kernel_row(r, launches, report) for r in rows]


def paged_attn_library_ms(torch, dev, cfg, cases, bits) -> float:
    """paged_attn's library yardstick, as paged_mla_attn's and qkv_decode's:
    one decode step (a call per layer, each on its own pool) of
    ``F.scaled_dot_product_attention`` in f32 over the dense view of the
    same pages, dequantized ahead of time with the kernel's rounding (kv
    heads repeated, a boolean mask from pos, the same scale). Returns SDPA's
    device ms per step."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attn import _dequant

    B, G = N_SLOTS, cfg.n_heads // cfg.kv_heads
    sdpa_in = []
    for q, k, ks, v, vs, pos, bt in cases:
        def dense(x, s_):
            pages = bt.long().flatten()
            x = _dequant(x[pages], None if s_ is None else s_[pages], bits)
            return x.reshape(B, S_MAX, *x.shape[2:]).repeat_interleave(G, dim=2).transpose(
                1, 2).contiguous()
        mask = (torch.arange(S_MAX, device=dev)[None] <= pos[:, None].long())[:, None, None]
        sdpa_in.append((q[:, :, None], dense(k, ks), dense(v, vs), mask))
    sdpa = lambda: [F.scaled_dot_product_attention(q, k, v, attn_mask=m)  # noqa: E731
                    for q, k, v, m in sdpa_in]
    kern = [ops.paged_attn(q, k, ks, v, vs, pos, bits=bits, block_table=bt, impl="cuda")
            for q, k, ks, v, vs, pos, bt in cases]
    worst = max(float((lib[:, :, 0] - out).abs().max()) for lib, out in zip(sdpa(), kern))
    tl, tlw, _ = device_ms(sdpa)
    tag = "bf16 cell" if bits is None else f"kv{bits}"
    log(f"  paged_attn {tag}: F.scaled_dot_product_attention (f32 over K/V dequantized ahead "
        f"of time, dense view, kv heads repeated, boolean mask), one decode step "
        f"({len(cases)} calls, L2-cold): {tl:.4f} ms device, {tlw:.3f} ms wall; max |SDPA - "
        f"kernel| = {worst:.3e}")
    return tl


def kernel_row(r, launches, report) -> dict:
    """One entry of the kernels line: the bound from the row's bytes and
    its work, a list of (operations, peak rate of their type) whose times
    add; the launches of its path, its check's largest error."""
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / peak for n, peak in r["work"]) * 1e3
    return {
        "name": r["name"], "route": r["route"], "source": r["source"],
        "replaces": r["replaces"], "launches": int(launches.get(r["name"], 0)),
        "max_abs_err": report[r["name"]]["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": r["library_ms"],
    }


#: device kernels the step breakdown names (everything else is PyTorch's)
KERNEL_NAMES = ("mpmm_kernel", "wdqmm_kernel", "paged_mla_attn_kernel", "paged_attn_kernel",
                "paged_attn_merge_kernel", "flash_mha_kernel", "paged_scatter_kernel",
                "paged_gather_kernel", "qkv_decode_kernel")


def step_breakdown(torch, dev, cfg, policy, params):
    """Profile one full-width decode step on the kernel path: wall time,
    device busy time (so the idle share), and device time by kernel."""
    from repro_torch.models import model as M

    caches = M.init_cache(cfg, policy, N_SLOTS, S_MAX, device=dev)
    toks = torch.ones((N_SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([n + MAX_NEW - 1 for n in PROMPT_LENS], dtype=torch.int32, device=dev)
    step = lambda: M.decode_step(params, toks, pos, caches, cfg, policy,  # noqa: E731
                                 fused_attn=True)
    profile_breakdown(torch, step, f"decode step breakdown ({cfg.name}, {policy.name}, "
                      f"{cfg.n_layers} layers, slot cache, 4 slots at 159..543 cached rows)")


def profile_breakdown(torch, step, label: str, reps: int = 3):
    """Wall time of ``step`` (mean of ``reps`` after two warm-up calls, no
    profiler), then one profiled call: device busy time (so the idle
    share), device time by kernel and the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
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
    log(f"{label}: wall {wall:.2f} ms (no profiler), device busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle), {n_kernels} device kernels; {parts}")
    log(f"  top device ops: {top}")


def wdqmm_step_row(torch, dev, cfg, params) -> dict:
    """wdqmm per decode step (4 slots): the 169 projections at M = 4 with
    bf16 activations over every layer's own w4 weights (0.85 GB: the 50 MB
    L2 holds none of them between uses), its plain version, and one
    ``F.linear`` a projection over the same weights dequantized to bf16
    ahead of time (the unquantized deployment weight-only serving is for);
    per call at each main-path shape too (weights L2-warm)."""
    import torch.nn.functional as F

    from repro_torch.core import pack as P
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    B = N_SLOTS
    lin = linears(params)

    def K_of(p):
        return p["w_packed"].shape[1] * 2

    def step(M, impl):
        xs = {K: torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
              for K in {K_of(p) for p in lin}}
        return lambda: [ops.wdqmm(xs[K_of(p)], p["w_packed"], p["eps_w"], w_bits=4, impl=impl)
                        for p in lin]

    for N, K, calls in main_path_mm_shapes(cfg):
        p = next(q for q in lin if tuple(q["w_packed"].shape) == (N, K // 2))
        for M in (B, 16):
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            one, _, _ = device_ms(lambda: [ops.wdqmm(x, p["w_packed"], p["eps_w"], w_bits=4,
                                                     impl="cuda") for _ in range(CALLS)],
                                  names=("wdqmm_kernel",))
            log(f"  wdqmm w4 M={M} N={N} K={K}: {one / CALLS * 1e3:.1f} us device per call "
                f"({CALLS} back to back, weights L2-warm; bound "
                f"{(N * K / 2) / HBM_BYTES_PER_S * 1e6:.2f} us), x{calls} per decode step")
    t, tw, how = device_ms(step(B, "cuda"))
    tp, tpw, _ = device_ms(step(B, "torch"), reps=3, warmup=1)
    t16, t16w, _ = device_ms(step(16, "cuda"))
    xs = {K: torch.randn((B, K), generator=g, device=dev).to(torch.bfloat16)
          for K in {K_of(p) for p in lin}}
    deq = [(P.unpack(p["w_packed"], 4, signed=True).to(torch.float32) * p["eps_w"]).to(
        torch.bfloat16) for p in lin]
    tl, tlw, _ = device_ms(lambda: [F.linear(xs[w.shape[1]], w) for w in deq])
    gb = sum(w.numel() * 2 for w in deq) / 1e9
    del deq
    log(f"  wdqmm w4, one decode step (169 calls, M={B}): {t:.4f} ms device ({how}), {tw:.3f} "
        f"ms wall; plain {tp:.3f} ms device, {tpw:.3f} ms wall; at M=16 (a prefill chunk's "
        f"shapes): {t16:.4f} ms device, {t16w:.3f} ms wall; F.linear over the weights "
        f"dequantized to bf16 ahead of time ({gb:.2f} GB, the unquantized deployment): {tl:.4f} ms "
        f"device, {tlw:.3f} ms wall")
    nbytes = sum(B * K_of(p) * 2 + p["w_packed"].numel() + B * p["w_packed"].shape[0] * 4 + 4
                 for p in lin)
    nops = sum(2 * B * p["w_packed"].shape[0] * K_of(p) for p in lin)
    return dict(name="wdqmm", route="cuda", source="src/repro_torch/csrc/wdqmm.cu",
                replaces="src/repro/kernels/wdqmm.py:45", ms=t, plain_ms=tp, bytes=nbytes,
                work=[(nops, F32_FLOPS_PER_S)], library_ms=tl)


def weight_only_path(torch, dev, cfg, params, report) -> tuple[dict, dict]:
    """Phase 10: internlm2 at full width served weight-only w4 over the
    w4a8 packed weights (each ``beta`` dropped): slot, paged, then the
    prefix path; the teacher-forced step, the step breakdown and wdqmm's
    timing row. Returns (the raw kernel row, wdqmm's launches on the slot
    and paged runs)."""
    from repro_torch.kernels import build

    policy, wparams = wo_policy(), weight_only(params)
    build.reset_launches()  # the weight-only serving path starts here
    out_slot, _ = serve(torch, dev, cfg, policy, wparams, "slot")
    out_paged, _ = serve(torch, dev, cfg, policy, wparams, "paged")
    launches = dict(build.LAUNCHES)  # the weight-only serving path ends here
    log(f"launches on the weight-only serving path: {launches}")
    if out_slot != out_paged:
        raise AssertionError("weight-only: slot and paged token streams differ")
    if launches.get("mpmm", 0) or not all(
            launches.get(k, 0) for k in ("wdqmm", "paged_attn", "paged_scatter")):
        raise AssertionError(f"weight-only serving path: wdqmm, paged_attn and paged_scatter "
                             f"must run, mpmm not: {launches}")
    log("weight-only slot and paged token streams identical")
    prefix_launches, _ = prefix_path(torch, dev, cfg, policy, wparams, key="weight-only ")
    if prefix_launches.get("mpmm", 0) or not prefix_launches.get("wdqmm", 0):
        raise AssertionError(f"weight-only prefix path: wdqmm must run, mpmm not: "
                             f"{prefix_launches}")
    teacher_forced(torch, dev, cfg, policy, wparams, report, key="teacher_forced_w4only")
    step_breakdown(torch, dev, cfg, policy, wparams)
    return wdqmm_step_row(torch, dev, cfg, wparams), {"wdqmm": launches["wdqmm"]}


def flash_step_row(torch, dev, cfg) -> dict:
    """flash_mha per prefill_step of N_SLOTS x PREFILL_LEN tokens: one causal
    call a layer over the layer's own bf16 q, k, v (24 sets of 16.8 MB, so
    each call finds its operands in device memory, not in the 50 MB L2; in a
    real prefill the projections have just written them), beside its bound,
    its plain version and one ``F.scaled_dot_product_attention`` a layer
    (f32, is_causal, kv heads repeated, (B, H, S, D); TF32 off)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    B, S, L = N_SLOTS, PREFILL_LEN, cfg.n_layers
    Hq, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    sets = [flash_case(torch, g, dev, B, S, S, Hq, Hkv, D, torch.bfloat16) for _ in range(L)]

    def step(impl):
        return lambda: [ops.flash_mha(q, k, v, causal=True, impl=impl) for q, k, v in sets]

    t, tw, how = device_ms(step("cuda"))
    tp, tpw, _ = device_ms(step("torch"), reps=3, warmup=1)
    G = Hq // Hkv
    lib_in = [(q.float().transpose(1, 2).contiguous(),
               k.float().repeat_interleave(G, dim=2).transpose(1, 2).contiguous(),
               v.float().repeat_interleave(G, dim=2).transpose(1, 2).contiguous())
              for q, k, v in sets]
    sdpa = lambda: [F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
                    for q, k, v in lib_in]
    worst = max(float((lib.transpose(1, 2) - kern).abs().max())
                for lib, kern in zip(sdpa(), step("cuda")()))
    tl, tlw, _ = device_ms(sdpa)
    del lib_in
    nbytes = L * (B * S * Hq * D * 2 + 2 * B * S * Hkv * D * 2 + B * S * Hq * D * 4)
    # q . k multiplies bf16 by bf16 and sums in f32, which a bf16 tensor-core
    # product does; P . V multiplies f32 probabilities by bf16 values, which
    # three bf16 tensor-core products do at f32 precision (each p split
    # exactly into bf16 hi + mid + lo, every product exact, the sums in f32)
    half = L * 2 * B * Hq * D * (S * (S + 1) // 2)
    work = [(half, BF16_FLOPS_PER_S), (3 * half, BF16_FLOPS_PER_S)]
    log(f"  flash_mha, one prefill_step ({L} calls, causal, B={B}, S={S}, {Hq}/{Hkv} heads, "
        f"D={D}, bf16 in, f32 out; operands L2-cold): {t:.4f} ms device ({how}), {tw:.3f} ms "
        f"wall; plain {tp:.3f} ms device, {tpw:.3f} ms wall; F.scaled_dot_product_attention "
        f"(f32, is_causal, kv heads repeated) {tl:.4f} ms device, {tlw:.3f} ms wall; max |SDPA "
        f"- kernel| = {worst:.3e}; {half / 1e9:.1f} GFLOP q . k at bf16 "
        f"({half / BF16_FLOPS_PER_S * 1e3:.4f} ms) + 3 x {half / 1e9:.1f} GFLOP P . V at bf16 "
        f"({3 * half / BF16_FLOPS_PER_S * 1e3:.4f} ms), {nbytes / 1e6:.0f} MB "
        f"({nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return dict(name="flash_mha", route="cuda", source="src/repro_torch/csrc/flash_mha.cu",
                replaces="src/repro/kernels/flash.py:79", ms=t, plain_ms=tp, bytes=nbytes,
                work=work, library_ms=tl)


def whole_prompts(torch, dev, cfg):
    """Phase 11's four prompts of PREFILL_LEN tokens, drawn from SEED."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    toks = rng.randint(1, cfg.vocab, size=(N_SLOTS, PREFILL_LEN)).astype(np.int32)
    return torch.from_numpy(toks).to(dev)


def greedy_decode(torch, dev, cfg, policy, params, caches, logits, steps=MAX_NEW):
    """``steps`` greedy fused decode steps for every slot from a cache that
    holds PREFILL_LEN rows, starting from the prefill's last logits. Returns
    the streams, one list a slot."""
    from repro_torch.models import model as M

    out = [[] for _ in range(N_SLOTS)]
    for i in range(steps):
        toks = M.sample_tokens(logits[:, -1], [0.0] * N_SLOTS)[:, None]
        for s, t in enumerate(toks[:, 0].tolist()):
            out[s].append(t)
        if i + 1 < steps:
            pos = torch.full((N_SLOTS,), PREFILL_LEN + i, dtype=torch.int32, device=dev)
            logits = M.decode_step(params, toks, pos, caches, cfg, policy, fused_attn=True)
    return out


def whole_prompt_path(torch, dev, cfg, policy, params, report) -> tuple[dict, dict]:
    """Phase 11: internlm2 at full width, w4a8 with kv8. ``prefill_step``
    writes four prompts of PREFILL_LEN tokens into a fresh dense cache in one
    forward (flash_mha over the fresh k/v), then MAX_NEW greedy fused decode
    steps run from it; ``forward(mode="serve")`` scores the same tokens.
    Gates: flash_mha launched once a layer in each call, forward's last
    position bit-identical to prefill_step's logits, the kernel path's
    prefill_step against the plain path's with argmax agreeing. Printed: the
    wall time of both prefills beside chunked prefill of the same prompts
    (ChunkedPrefill, chunks of 16), how far the greedy streams agree, and
    prefill_step's breakdown (device busy, time by kernel).
    Returns (flash_mha's raw kernel row, its launches on the prefill path)."""
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serve.cache import SlotCache
    from repro_torch.serve.prefill import ChunkedPrefill

    toks = whole_prompts(torch, dev, cfg)
    L = cfg.n_layers

    def prefill(impl="auto"):
        caches = M.init_cache(cfg, policy, N_SLOTS, S_MAX, device=dev)
        logits, _ = M.prefill_step(params, {"tokens": toks}, caches, cfg, policy, impl=impl)
        return logits, caches

    prefill()  # warm-up: the first full-width shapes' allocations and library handles
    torch.cuda.synchronize()
    build.reset_launches()  # the whole-prompt prefill path starts here
    t0 = time.perf_counter()
    logits, caches = prefill()
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    streams = greedy_decode(torch, dev, cfg, policy, params, caches, logits)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # the whole-prompt prefill path ends here
    log(f"launches on the whole-prompt prefill path (prefill_step + {MAX_NEW - 1} decode "
        f"steps): {launches}")
    if launches.get("flash_mha", 0) != L:
        raise AssertionError(f"prefill_step launched flash_mha {launches.get('flash_mha', 0)} "
                             f"times, want {L} (one a layer)")
    for name in ("mpmm", "paged_attn"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the whole-prompt path")

    build.reset_launches()  # the whole-sequence forward starts here
    t0 = time.perf_counter()
    full, _ = M.forward(params, {"tokens": toks}, cfg, policy, mode="serve")
    torch.cuda.synchronize()
    t_forward = time.perf_counter() - t0
    fwd_launches = dict(build.LAUNCHES)  # the whole-sequence forward ends here
    log(f"launches on forward(mode='serve'): {fwd_launches}")
    if fwd_launches.get("flash_mha", 0) != L:
        raise AssertionError(f"forward launched flash_mha {fwd_launches.get('flash_mha', 0)} "
                             f"times, want {L}")
    if tuple(full.shape) != (N_SLOTS, PREFILL_LEN, cfg.vocab_padded) or not bool(
            torch.isfinite(full.float()).all()):
        raise AssertionError(f"forward logits: shape {tuple(full.shape)} or not finite")
    if not torch.equal(full[:, -1:], logits):
        d = float((full[:, -1:].float() - logits.float()).abs().max())
        raise AssertionError(f"forward's last-position logits differ from prefill_step's by {d}")
    log(f"forward(mode='serve') over {N_SLOTS} x {PREFILL_LEN} tokens: logits "
        f"{tuple(full.shape)} in {t_forward:.3f} s wall; last position bit-identical to "
        f"prefill_step's")
    del full

    plain, _ = prefill(impl="torch")
    torch.cuda.synchronize()
    a, b = logits[:, -1].float(), plain[:, -1].float()
    diff = float((a - b).abs().max())
    agree = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    log(f"teacher_forced_prefill ({cfg.name}, {L} layers, full width, {N_SLOTS} x "
        f"{PREFILL_LEN} tokens): max |logit kernel - plain| = {diff:.4g}, argmax agree: "
        f"{agree}, logit scale {float(b.abs().max()):.4g}")
    report["teacher_forced_prefill"] = {"max_logit_diff": diff, "argmax_agree": agree}
    if not agree:
        raise AssertionError("whole-prompt prefill: kernel and plain argmax differ")

    cache = SlotCache(cfg, policy, N_SLOTS, S_MAX, device=dev)
    pre = ChunkedPrefill(params, cfg, policy, chunk=16, device=dev)
    lasts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s_, p in enumerate(toks.cpu().numpy()):
        cache.acquire(PREFILL_LEN + MAX_NEW)
        lasts.append(pre.prefill(cache, s_, p))
    torch.cuda.synchronize()
    t_chunked = time.perf_counter() - t0
    chunked = greedy_decode(torch, dev, cfg, policy, params, cache.caches, torch.cat(lasts))
    same = sum(a_ == b_ for x, y in zip(streams, chunked) for a_, b_ in zip(x, y))
    prefix = [next((i for i, (a_, b_) in enumerate(zip(x, y)) if a_ != b_), MAX_NEW)
              for x, y in zip(streams, chunked)]
    log(f"whole-prompt prefill_step of {N_SLOTS} x {PREFILL_LEN} tokens: {t_prefill:.3f} s "
        f"wall; chunked prefill of the same prompts (ChunkedPrefill, chunks of 16, "
        f"{pre.jit_calls} calls): {t_chunked:.3f} s wall")
    log(f"greedy streams after whole-prompt vs chunked prefill (not gated: whole-prompt "
        f"attends over the fresh bf16 k/v, chunked over the dequantized kv8 cache): {same} of "
        f"{N_SLOTS * MAX_NEW} tokens equal, first difference at steps {prefix}")
    del cache, pre, lasts, caches
    profile_breakdown(torch, lambda: prefill()[0], f"prefill_step breakdown ({cfg.name}, "
                      f"{policy.name}, {L} layers, {N_SLOTS} x {PREFILL_LEN} tokens)", reps=2)
    return flash_step_row(torch, dev, cfg), {"flash_mha": launches["flash_mha"]}


def dense_cache_path(torch, dev, cfg, policy, params, report) -> tuple[dict, dict]:
    """Phase 12: qkv_decode over the dense kv8 cache that ``prefill_step``
    wrote for phase 11's four 512-token prompts. One fused greedy decode
    step from that cache (every sequence at position PREFILL_LEN, so one
    scalar pos serves them all) records, for every layer, the query and the
    cache leaves it handed to paged_attn and paged_attn's output; then
    qkv_decode runs each layer's attention again (one launch a layer: the
    path whose launches the kernels line counts). Gates, each within
    ``row_tol``: qkv_decode against its plain version and against
    dequantize-then-attend in f32 (``dense_attention``, one softmax over all
    visible keys); paged_attn's recorded output against the same with the
    dequantized cache rounded through bf16 (``qkv_decode_ref``, the
    reference's oracle), which shows that qkv_decode and paged_attn read the
    same query and cache and part only by that rounding. Phase 2's
    elementwise ATTN_TOL (atol = rtol) is printed beside, not gated: at the
    model's scores (|s| up to ~17) the orders of the f32 sums move an output
    near 0 by more than 1e-5 while its row averages values of ~5. The gap
    between qkv_decode and paged_attn is printed beside the reference test's
    5e-3, which holds on its unit-variance inputs, not at the model's
    scores. Returns (qkv_decode's raw kernel row, its launches)."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import qkv_decode as QD
    from repro_torch.models import model as M

    toks = whole_prompts(torch, dev, cfg)
    caches = M.init_cache(cfg, policy, N_SLOTS, S_MAX, device=dev)
    logits, _ = M.prefill_step(params, {"tokens": toks}, caches, cfg, policy)
    nxt = M.sample_tokens(logits[:, -1], [0.0] * N_SLOTS)[:, None]
    pos = torch.full((N_SLOTS,), PREFILL_LEN, dtype=torch.int32, device=dev)
    seen, paged_attn = [], ops.paged_attn

    def record(q, k, k_s, v, v_s, p, **kw):
        out = paged_attn(q, k, k_s, v, v_s, p, **kw)
        if kw.get("block_table") is None and kw.get("bits") == 8:
            seen.append((q, k, k_s, v, v_s, out))
        return out

    ops.paged_attn = record
    try:
        M.decode_step(params, nxt, pos, caches, cfg, policy, fused_attn=True)
    finally:
        ops.paged_attn = paged_attn
    if len(seen) != cfg.n_layers:
        raise AssertionError(f"recorded {len(seen)} dense kv8 paged_attn calls, want "
                             f"{cfg.n_layers}")
    build.reset_launches()  # the qkv_decode path starts here
    outs = [QD.qkv_decode(q, k, ks, v, vs, PREFILL_LEN, bits=8) for q, k, ks, v, vs, _ in seen]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # the qkv_decode path ends here
    log(f"launches on the qkv_decode path ({cfg.n_layers} layers of the prefilled dense kv8 "
        f"cache, pos {PREFILL_LEN}): {launches}")
    if launches.get("qkv_decode", 0) != cfg.n_layers:
        raise AssertionError(f"qkv_decode launched {launches.get('qkv_decode', 0)} times, want "
                             f"{cfg.n_layers}")
    worst = {"plain": 0.0, "f32 oracle": 0.0, "paged_attn vs bf16 oracle": 0.0}
    elementwise = {k: 0.0 for k in worst}  # max |a - b| / (1 + |b|), against ATTN_TOL
    gap = within = 0.0
    for i, (out, (q, k, ks, v, vs, pa)) in enumerate(zip(outs, seen)):
        tol = row_tol(torch, q, k, ks, v, vs, PREFILL_LEN)
        pairs = {"plain": (out, QD.qkv_decode_plain(q, k, ks, v, vs, PREFILL_LEN, bits=8)),
                 "f32 oracle": (out, dense_attention(torch, q, k, ks, v, vs, PREFILL_LEN)),
                 "paged_attn vs bf16 oracle": (pa, QD.qkv_decode_ref(q, k, ks, v, vs,
                                                                     PREFILL_LEN, bits=8))}
        for what, (a, b) in pairs.items():
            err = (a - b).abs()
            if not torch.isfinite(a).all() or bool((err > tol).any()):
                j = int((err / tol).argmax())
                raise AssertionError(f"layer {i}: {what}: difference {float(err.flatten()[j])} "
                                     f"above its bound {float(tol.expand_as(err).flatten()[j])}")
            worst[what] = max(worst[what], float((err / tol).max()))
            elementwise[what] = max(elementwise[what], float((err / (1 + b.abs())).max()))
        gap = max(gap, float((out - pa).abs().max()))
        within = max(within, float(((out - pa).abs() / (1 + pa.abs())).max()))
    scale = max(float(pa.abs().max()) for *_, pa in seen)
    log(f"qkv_decode over the prefilled dense kv8 cache ({cfg.n_layers} layers, B={N_SLOTS}, "
        f"S={S_MAX}, pos {PREFILL_LEN}), largest difference over its row_tol bound: "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
        + "; largest |a - b| / (1 + |b|) (elementwise, against ATTN_TOL, not gated): "
        + ", ".join(f"{k} {v:.3e}" for k, v in elementwise.items())
        + f"; |qkv_decode - paged_attn| up to {gap:.3e} (f32 against bf16 dequantization; "
        f"{within:.3e} of 1 + |out|, the reference test's bound 5e-3 "
        f"{'met' if within <= 5e-3 else 'not met'}; attention outputs up to {scale:.4g})")
    report["qkv_decode_model_cache"] = {"err_over_row_tol": worst, "elementwise": elementwise}
    del seen, outs, caches
    return qkv_decode_row(torch, dev, cfg), {"qkv_decode": launches["qkv_decode"]}


def row_tol(torch, q, kq, ks, vq, vs, pos):
    """ATTN_TOL scaled to one attention row's own sizes, for outputs
    computed from the model's cache: ATTN_TOL * (1 + A) * (1 + V), where A
    is the row's largest ``scale * sum_d |q_d k_d|`` over its visible keys
    (a score's rounding grows with it, and an output moves by about the
    score error times the values' spread) and V the largest |v| it
    averages. Returns (B, Hq, 1)."""
    G = q.shape[1] // kq.shape[2]
    k = (kq.float() * ks[..., None])[:, : pos + 1].repeat_interleave(G, dim=2)
    v = (vq.float() * vs[..., None])[:, : pos + 1].repeat_interleave(G, dim=2)
    a = torch.einsum("bhd,bshd->bhs", q.float().abs(), k.abs()).amax(dim=-1) / q.shape[-1] ** 0.5
    return (ATTN_TOL * (1 + a) * (1 + v.abs().amax(dim=(1, 3))))[..., None]


def dense_attention(torch, q, kq, ks, vq, vs, pos):
    """Dequantize-then-attend in f32 for an int8 dense cache: ``code *
    scale`` with no bf16 step, kv heads repeated, one softmax over the keys
    0..pos. An implementation of qkv_decode's function independent of its
    running softmax. Returns (B, Hq, D) f32."""
    G = q.shape[1] // kq.shape[2]
    k = (kq.float() * ks[..., None])[:, : pos + 1].repeat_interleave(G, dim=2)
    v = (vq.float() * vs[..., None])[:, : pos + 1].repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) / q.shape[-1] ** 0.5
    return torch.einsum("bhs,bshd->bhd", torch.softmax(s, dim=-1), v)


def qkv_decode_row(torch, dev, cfg) -> dict:
    """qkv_decode per call at B 4, S 1024, 16 / 8 heads, D 128, pos 1023, kv8
    and kv4: COLD_STEPS calls over distinct caches a window (8 x 8.65 MB at
    kv8 exceeds the 50 MB L2), beside its bound, its plain version and one
    ``F.scaled_dot_product_attention`` a call (f32 over K/V dequantized
    ahead of time, kv heads repeated, (B, H, S, D), a boolean mask from
    pos). The row is kv8's; kv4's numbers are printed."""
    import torch.nn.functional as F

    from repro_torch.core import pack as P
    from repro_torch.kernels import qkv_decode as QD

    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    B, S, Hq, Hkv, D = N_SLOTS, S_MAX, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    pos, G = S - 1, Hq // Hkv
    out = {}
    for bits in (8, 4):
        sets = [qkv_case(torch, g, dev, B, S, Hq, Hkv, D, bits) for _ in range(COLD_STEPS)]

        def calls(fn, sets=sets, bits=bits):
            return lambda: [fn(q, kq, ks, vq, vs, pos, bits=bits) for q, kq, ks, vq, vs in sets]

        t, tw, how = device_ms(calls(QD.qkv_decode_cuda))
        tp, _, _ = device_ms(calls(QD.qkv_decode_plain), reps=3, warmup=1)
        lib_in = []
        for q, kq, ks, vq, vs in sets:
            deq = lambda c, s_: (P.unpack(c, bits, signed=True).float() * s_[..., None]  # noqa: E731
                                 ).repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
            mask = (torch.arange(S, device=dev) <= pos)[None, None, None]
            lib_in.append((q[:, :, None], deq(kq, ks), deq(vq, vs), mask))
        sdpa = lambda: [F.scaled_dot_product_attention(q, k, v, attn_mask=m)  # noqa: E731
                        for q, k, v, m in lib_in]
        worst = max(float((lib[:, :, 0] - kern).abs().max())
                    for lib, kern in zip(sdpa(), calls(QD.qkv_decode_cuda)()))
        tl, _, _ = device_ms(sdpa)
        del lib_in
        nbytes = (2 * B * S * Hkv * D * bits // 8 + 2 * B * S * Hkv * 4 + 2 * B * Hq * D * 4)
        nops = 4 * B * Hq * D * S
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS_PER_S) * 1e3
        n = COLD_STEPS
        log(f"  qkv_decode kv{bits} per call (B={B}, S={S}, {Hq}/{Hkv} heads, D={D}, pos {pos}; "
            f"{n} distinct caches a window, L2-cold): {t / n * 1e3:.2f} us device ({how}), "
            f"{tw / n * 1e3:.2f} us wall; plain {tp / n * 1e3:.1f} us device; "
            f"F.scaled_dot_product_attention (f32, K/V dequantized ahead of time, kv heads "
            f"repeated, boolean mask) {tl / n * 1e3:.2f} us device, max |SDPA - kernel| = "
            f"{worst:.3e}; bound {bound * 1e3:.3f} us ({nbytes / 1e6:.2f} MB)")
        out[bits] = dict(name="qkv_decode", route="cuda", source="src/repro_torch/csrc/qkv_decode.cu",
                         replaces="src/repro/kernels/qkv_decode.py:72", ms=t / n, plain_ms=tp / n,
                         bytes=nbytes, work=[(nops, F32_FLOPS_PER_S)], library_ms=tl / n)
    return out[8]


def sampled_path(torch, dev, cfg, policy, params, greedy_out) -> dict:
    """Phase 13: the serving path with seeded sampling (SAMPLING, request i
    with seed 1000 + i), internlm2 w4a8 kv8 at full width. Phase 3's four
    requests on the slot and the paged cache; phase 9's five on a cold
    paged and a prefix engine; the four again with request 0 greedy beside
    three sampled; the four at top-k 1. Gates: slot and paged streams
    identical, prefix identical to cold paged; in the mixed batch the
    sampled requests repeat their first run's streams (run to run, and
    whatever their neighbours) and the greedy one equals its stream in
    phase 3's all-greedy batch (``greedy_out``); top-k 1 equals phase 3's
    greedy streams, or first differs at a token whose two best logits tie
    (top-k 1 keeps ties, greedy takes the first; the tie is read from the
    logits the engine sampled); mpmm, paged_attn and paged_scatter launched.
    Printed: a sampled decode step's wall and device time beside a greedy
    step's from the same cache (walls: medians of STEP_PAIRS steps of each,
    taken in turns), and the sampler's device time. Returns the launches of
    the slot and paged runs."""
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serve import Request

    build.reset_launches()  # the sampled serving path starts here
    out_slot, _ = serve(torch, dev, cfg, policy, params, "slot",
                        reqs=sampled_requests(requests(cfg, Request)))
    out_paged, _ = serve(torch, dev, cfg, policy, params, "paged",
                         reqs=sampled_requests(requests(cfg, Request)))
    launches = dict(build.LAUNCHES)  # the sampled serving path ends here
    log(f"launches on the sampled serving path: {launches}")
    if out_slot != out_paged:
        raise AssertionError("sampled: slot and paged token streams differ")
    for name in ("mpmm", "paged_attn", "paged_scatter"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the sampled serving path")
    same = sum(a == b for rid in out_slot for a, b in zip(out_slot[rid], greedy_out[rid]))
    log(f"sampled slot and paged token streams identical; {same} of "
        f"{sum(len(t) for t in out_slot.values())} tokens equal the greedy streams")
    prefix_path(torch, dev, cfg, policy, params, key="sampled ", sampled=True)

    mixed, _ = serve(torch, dev, cfg, policy, params, "slot",
                     reqs=sampled_requests(requests(cfg, Request), greedy=(0,)))
    if mixed[0] != greedy_out[0]:
        raise AssertionError("a greedy request beside sampled ones left its greedy stream")
    if any(mixed[r] != out_slot[r] for r in (1, 2, 3)):
        raise AssertionError("sampled streams changed from run to run or with their neighbours")
    log("mixed batch (request 0 greedy, 1-3 sampled): the greedy stream equals phase 3's, the "
        "sampled ones their first run's")
    ties: dict = {}
    top1, _ = serve(torch, dev, cfg, policy, params, "paged", ties=ties,
                    reqs=sampled_requests(requests(cfg, Request), top_k=1))
    parts = {}
    for rid, (a, b) in enumerate(zip(top1.values(), greedy_out.values())):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is not None:
            if not ties[rid, i]:
                raise AssertionError(f"top-k 1 request {rid} parts from greedy at token {i}, "
                                     f"where the two best logits do not tie")
            parts[rid] = i
    log(f"top-k 1 streams equal the greedy ones"
        + (f", except from a tie of the two best logits (request: first token) {parts}"
           if parts else "") + f"; {sum(ties.values())} of {len(ties)} drawn tokens had tied "
        f"best logits")

    caches = M.init_cache(cfg, policy, N_SLOTS, S_MAX, device=dev)
    toks = torch.ones((N_SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([n + MAX_NEW - 1 for n in PROMPT_LENS], dtype=torch.int32, device=dev)
    lanes = ([SAMPLING["temperature"]] * N_SLOTS, [SAMPLING["top_k"]] * N_SLOTS,
             [SAMPLING["top_p"]] * N_SLOTS, [1000 + i for i in range(N_SLOTS)], [5] * N_SLOTS)

    def step(sampled):
        logits = M.decode_step(params, toks, pos, caches, cfg, policy, fused_attn=True)
        return M.sample_tokens(logits[:, -1], *(lanes if sampled else ([0.0] * N_SLOTS,)))

    tg, _, how = device_ms(lambda: step(False))
    ts, _, _ = device_ms(lambda: step(True))
    walls: dict = {False: [], True: []}
    for i in range(2 * STEP_PAIRS):
        sampled = bool(i % 2) != bool(i // 2 % 2)  # greedy, sampled, sampled, greedy, ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(sampled)
        torch.cuda.synchronize()
        walls[sampled].append((time.perf_counter() - t0) * 1e3)
    tgw, tsw = (statistics.median(walls[k]) for k in (False, True))
    logits = M.decode_step(params, toks, pos, caches, cfg, policy, fused_attn=True)[:, -1]
    tsamp, tsampw, _ = device_ms(lambda: M.sample_tokens(logits, *lanes))
    tgreedy, _, _ = device_ms(lambda: M.sample_tokens(logits, [0.0] * N_SLOTS))
    log(f"decode step + sampler ({cfg.name}, {policy.name}, slot cache, 4 slots at 159..543 "
        f"cached rows; {how}; walls the medians of {STEP_PAIRS} steps each, in turns): greedy "
        f"{tg:.3f} ms device, {tgw:.3f} ms wall; sampled "
        f"(temperature {SAMPLING['temperature']}, top-k {SAMPLING['top_k']}, top-p "
        f"{SAMPLING['top_p']}) {ts:.3f} ms device, {tsw:.3f} ms wall; the sampler alone over "
        f"(4, {logits.shape[-1]}) logits: {tsamp:.4f} ms device, {tsampw:.3f} ms wall "
        f"(greedy argmax {tgreedy:.4f} ms device)")
    return launches


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
    wo, wparams = wo_policy(), weight_only(params)
    build.reset_launches()  # the weight-only MLA path starts here
    wo_slot, _ = serve(torch, dev, cfg, wo, wparams, "slot")
    wo_paged, _ = serve(torch, dev, cfg, wo, wparams, "paged")
    wo_launches = dict(build.LAUNCHES)  # the weight-only MLA path ends here
    log(f"launches on the weight-only MLA path: {wo_launches}")
    if wo_slot != wo_paged:
        raise AssertionError("MLA weight-only: slot and paged token streams differ")
    if wo_launches.get("mpmm", 0) or not all(
            wo_launches.get(k, 0) for k in ("wdqmm", "paged_mla_attn", "paged_scatter")):
        raise AssertionError(f"MLA weight-only path: wdqmm, paged_mla_attn and paged_scatter "
                             f"must run, mpmm not: {wo_launches}")
    same = sum(a == b for rid in out_paged for a, b in zip(out_paged[rid], wo_paged[rid]))
    log(f"MLA weight-only: slot and paged streams identical; {same} of "
        f"{sum(len(t) for t in out_paged.values())} tokens equal the w4a8 streams (not gated)")
    teacher_forced(torch, dev, cfg, wo, wparams, report, key="teacher_forced_mla_w4only")
    del wparams
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

    prefix_path(torch, dev, cfg, policy, params, key="MLA ")

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
               bytes=nbytes, work=[(nops, F32_FLOPS_PER_S)], library_ms=tl)
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
    check_paged_copy(torch, dev, cfg, configs.get_arch(MLA_ARCH), report)
    check_wdqmm(torch, dev, cfg, configs.get_arch(MLA_ARCH), report)
    check_flash_mha(torch, dev, cfg, report)
    check_qkv_decode(torch, dev, cfg, report)

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

    prefix_launches, _ = prefix_path(torch, dev, cfg, policy, params)
    launches["paged_copy"] = prefix_launches["paged_copy"]

    teacher_forced(torch, dev, cfg, policy, params, report)
    step_breakdown(torch, dev, cfg, policy, params)
    rows = kernel_table(torch, dev, cfg, params, launches, report)
    wo_row, wo_launches = weight_only_path(torch, dev, cfg, params, report)
    rows.insert(1, kernel_row(wo_row, wo_launches, report))
    flash_row, flash_launches = whole_prompt_path(torch, dev, cfg, policy, params, report)
    rows.insert(3, kernel_row(flash_row, flash_launches, report))
    qkv_row, qkv_launches = dense_cache_path(torch, dev, cfg, policy, params, report)
    sampled_path(torch, dev, cfg, policy, params, out_slot)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mla_row, mla_launches = mla_path(torch, dev, policy, report)
    rows.append(kernel_row(mla_row, mla_launches, report))
    rows.append(kernel_row(qkv_row, qkv_launches, report))
    log(gpu_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
