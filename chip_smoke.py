#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order (any failure ends the run with a nonzero exit):
  1. the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/csrc/`` with nvcc (sm_90a) and report the build time;
  2. hold each kernel against its plain PyTorch version on the card:
     mpmm on all 27 cells x 3 output kinds at a small shape and on the five
     main-path (N, K) at M = 4, 16, 20 (a speculative verify), 64 (a
     continuous mixed step) and 2048, and mixed_paper's 8-bit cell at its
     attn_out and head shapes at M = 4 and 20 (bit-exact); paged_scatter
     (bit-exact, scratch page excluded; S_new 1, 5 (a speculative verify's
     rows) and 16 (a mixed step's), at ragged per-slot positions, one
     slot's rows past its table, and again with one lane at the speculative
     sentinel 2**30) one leaf at a time and one launch a group on
     every internlm2 and DeepSeek-V3 leaf set at kv8 / kv4 / bf16 (the
     layer's k, v, k_s, v_s or c, c_s, r); paged_attn on bf16 / kv8 / kv4, with and without
     a window (tolerance ATTN_TOL), each call twice bit-identical and each
     slot's output the same alone, in the batch and beside other positions;
     conv2d on all 27 cells at the paper's
     Reference Layer, at two ragged shapes, at a shape whose blocks take two
     rows and one whose rows take two blocks, and on three cells at 224 x 224
     (its SASS holding IMMA), qntpack on every output width at
     the Tab. 1 shape and a ragged one, phi aligned and off the 16-byte
     grid, ascending and shuffled thresholds, paged_gather on every cache
     leaf and one launch a group on the same leaf sets (all bit-exact);
     mpmm over experts (one launch a call, bit-exact to the plain version
     applied expert by expert) at EXPERT_SHAPES on cells (8, 4, 8) and
     (8, 2, 8); flash_mha and qkv_decode at D 64 (below);
  3. the serving path: ServeEngine serving internlm2-1.8b at full width under
     policy w4a8 with an 8-bit KV cache (weights from a seeded
     torch.Generator on the card), 4 greedy requests, first on the slot cache
     and then on the paged cache; the token streams must be identical,
     mpmm, paged_attn and paged_scatter must have launched, paged_scatter
     once a layer and decode step (24 a step); then the paged cache's decode
     step breakdown, fused and unfused (after the slot cache's, phase 6);
  4. the Reference-Layer path: ``repro_torch.examples.quickstart`` and
     ``mixed_precision_sweep`` (27 cells) on the card, their packed ofmaps
     equal to the CPU run's and their mean errors within 1e-6; then the
     paper's three phases unfused (im2col, mpmm int32 out, qntpack) equal to
     the fused conv2d; conv2d and qntpack must have launched;
  5. the unfused paged read: the serving path again with
     ``fused_attn=False``, slot then paged cache; the two streams must be
     identical, paged_gather and paged_scatter must have launched once a
     layer and decode step of the paged run, rowinv_bmm (the unfused read's
     q . k and p . v) twice a layer a decode step or prefill chunk of both
     runs (agreement with the fused streams is printed, not gated: the
     softmax sums in another order);
  6. a teacher-forced decode step at full width, kernel path against plain
     path from the same cache (largest logit difference, argmax agreement);
  7. each kernel's time beside its bound and its plain version's time (per
     decode step for the serving kernels, rowinv_bmm per unfused decode step
     beside ``torch.bmm`` over its operands laid out ahead of time; per call at the paper's shape for
     conv2d, also at 224 x 224, beside ``F.conv2d`` in f32 over the codes
     unpacked ahead of time (TF32 allowed; whether it is exact is printed),
     and qntpack at the Tab. 1 shape and at the 224 x 224 Reference
     Layer's accumulators, beside ``torch.bucketize``, ``ops.qntpack``
     copying nothing to the card (gated); paged_scatter and paged_gather
     one group a layer as the model calls them, beside the same leaves one
     launch each, an ``index_put_`` / ``index_select`` a leaf (the library
     time) and one empty kernel's time (the launch floor, printed);
     paged_copy, one COW clone in one launch, beside the same leaves one
     launch each and an ``index_select`` + ``index_copy_`` a leaf, a clone
     after the set's first copying nothing to the card (gated); wdqmm's row, and flash_mha's
     and mpmm's prefill_step rows, are timed at the end of phases 10 and
     11, after their paths ran);
     paged_attn per step at kv8 (the row), kv4 and on the bf16 cell; kv8
     and the bf16 cell each beside ``F.scaled_dot_product_attention`` in
     f32 over their K/V dequantized ahead of time (kv8 the row's library
     time, bf16 printed);
  8. the MLA serving path: ServeEngine serving DeepSeek-V3 at its published
     widths cut to its three dense (MLA) layers, policy w4a8 with an 8-bit
     latent cache, the same 4 greedy requests, on the slot cache and then
     the paged cache (fused decode: paged_mla_attn), then both again with
     ``fused_attn=False`` (the paged read through paged_gather); slot and
     paged streams identical, fused and unfused, paged_scatter once a layer
     and decode step of the paged runs (3 a step) and paged_gather of the
     unfused paged run; then phase 9's five
     requests on a cold paged engine and on a prefix engine (streams
     identical, paged_copy launched once a COW clone); then a teacher-forced MLA
     decode step (kernel vs plain), the MLA step's breakdowns (slot cache,
     paged cache fused and unfused), and
     paged_mla_attn's time per decode step (its split pass and its merge
     apart) beside its bound, its plain version and
     ``F.scaled_dot_product_attention`` over the latent dequantized ahead of
     time, at kv8 (the row's library time) and on the bf16 cell.
     Phase 2 holds paged_mla_attn against its plain version on bf16 / kv8 /
     kv4 at H 128, C 512, dr 64, pages of 16 (tolerance ATTN_TOL), each
     call twice bit-identical and each slot's output the same alone, in the
     batch and beside other positions; at the model's scale (scores up to
     ~20) also within ATTN_TOL of the exact (f64) attention. Then
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
     launched once a COW clone (one launch over every leaf of every layer),
     the hit rate must be above 0, at least 3 COW clones made and fewer
     prefill calls spent. Phase 2 holds paged_copy's group bit-exact
     against its plain version on every leaf of an internlm2 and a
     DeepSeek-V3 clone at kv8, kv4 and bf16 and on 15-byte pages
     (disjoint, negative, out-of-range, overlapping and self-copies; host
     and device ids; one launch for disjoint host ids, else two), and
     phase 7 times one COW clone (all 96 leaves in one launch);
 10. the weight-only path (run right after phase 7, on internlm2's weights):
     policy WO_POLICY (every projection and the head weight-only w4, bf16
     activations, 8-bit KV cache) over the w4a8 packed weights with each
     ``beta`` dropped, the 4 requests of phase 3 on the slot and then the
     paged cache, then phase 9's five requests on a cold paged and a prefix
     engine (the model cut to CUT_LAYERS (8) layers at full width). Slot and
     paged streams identical, prefix streams identical to
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
     bf16 rate), its plain version and ``F.scaled_dot_product_attention``;
     and mpmm's time per prefill_step (169 calls at M = 2048; prefill_step
     must launch it once a projection) beside its bound (int8 operations),
     its plain version and ``torch._int_mm`` over the weights unpacked to
     int8 ahead of time. Phase 2 holds flash_mha against its plain version (ATTN_TOL, each call
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
     kv8 and kv4; its split pass and merge apart) beside its bound, its plain
     version and
     ``F.scaled_dot_product_attention`` over K/V dequantized ahead of time.
     Phase 2 holds qkv_decode against its plain version (ATTN_TOL, each
     call twice bit-identical) on the reference test's shapes with pos at
     its edges (-1, 0, block ends), at internlm2's full shape (kv8 and
     kv4, pos 0, 511, 900, 1023) and on one run of keys;
 13. the sampled serving path (run right after phase 12, on internlm2's
     w4a8 weights cut to CUT_LAYERS layers): phase 3's four requests greedy
     (the reference of this phase's gates), then at temperature 0.8, top-k
     40, top-p 0.95, request i with seed 1000 + i, on the slot and the paged
     cache; phase 9's five requests sampled the same way on a cold paged
     and a prefix engine; the four with request 0 greedy beside three
     sampled; the four at top-k 1. Gates: slot and paged streams identical,
     prefix identical to cold paged; the mixed batch's sampled streams equal
     their first run's and its greedy one the greedy run's; top-k 1 equal to
     the greedy streams or first parting at a token whose two best logits
     tie (read from the logits the engine sampled); mpmm, paged_attn and
     paged_scatter launched. Printed (at full depth): a sampled decode
     step's device and wall time beside a greedy step's from the same
     cache, and the sampler's own device time.
 14. continuous batching (run right after phase 13, on phase 3's internlm2
     w4a8 kv8 weights at full width and depth; its DeepSeek-V3 runs right
     after phase 8's prefix run, on phase 8's weights): ``ServeEngine(...,
     mixed=True, mixed_budget=MIXED_BUDGET (16), inflight=INFLIGHT (2))``,
     4 slots, s_max 1024, pages of 16. A mixed step reads the cache
     unfused, so the continuous runs whose streams are held read it
     unfused in every step and each of their streams must equal
     (``held_equal``) the stream of a serialized run that reads it unfused
     too: phase 3's four greedy requests on slot and paged against phase
     5's runs, phase 9's five on prefix and phase 13's sampled four on paged
     (both at CUT_LAYERS layers) against serialized runs made here,
     DeepSeek-V3's three MLA layers on phase 3's four (paged) against phase
     8's unfused paged run. On the card the unfused read's f32 products run
     through the row-invariant rowinv_bmm kernel, so a query row has the
     same bits in a decode step (S = 1) as among a mixed step's rows. The
     witness (``mixed_witness``): from one full-width serving state, one
     unfused decode step and one mixed step of the same four decode lanes,
     their logits bit-equal on the card (gated, internlm2 and DeepSeek-V3)
     and, for DeepSeek-V3, on the CPU (gated; the card's against the CPU's
     printed); each of the unfused read's products (two GQA, five MLA) for
     one query row alone and among 16 through rowinv_bmm bit-equal (gated),
     what ``torch.einsum`` gives there and an RMS norm printed. One more continuous run each, fused
     (pure-decode steps through paged_attn / paged_mla_attn), on phase 3's
     requests on paged: launches and syncs gated, streams printed against
     the fused serialized ones (a mix of unfused mixed and fused
     pure-decode steps that no serialized run computes). Gates on every
     continuous run: mixed steps ran and ``inflight`` is 0 after
     ``drain()``; the in-flight depth, read after every dispatch and from
     ``on_token``, never exceeds 2; every admission and every dispatch,
     mixed and pure decode, makes zero host syncs
     (``serve.boundary.counting_syncs``, with a control: a window around one
     ``.item()`` must count one); mpmm launches 169 times a step,
     paged_scatter once a layer a step, paged_gather once a layer a mixed
     step (a step, unfused), rowinv_bmm twice (GQA) or five times (MLA) a
     layer a mixed step (a step, unfused), paged_attn / paged_mla_attn once
     a layer a pure-decode step when fused, paged_copy once a COW clone. Printed: each
     engine's step EMA, TPOT and TTFT p50 and tokens/s, the syncs of one
     retire beside its event wait, the device-idle share of 8 profiled
     fused paged steps of each engine (serialized decode steps, continuous
     mixed steps and its last pure-decode steps), mpmm's time per mixed
     step (168 calls at M = 64) beside its bound, its plain version and
     ``torch._int_mm``, and the phase's own seconds.
 15. checkpoints (run right after phase 16, on phase 3's internlm2 weights;
     its DeepSeek-V3 round trip right after phase 14's MLA run, on phase
     8's weights): ``checkpoint.store.save`` of ``{"params":
     bridge.params_to_reference(params, cfg)}`` under a fresh temporary
     directory (deleted after), ``store.load`` into a meta-device template
     (``init_params(..., device="meta")``) onto the card, every leaf
     bit-equal to the saved params (keys, dtypes, shapes, bytes); printed:
     the bytes on disk, the save and load seconds and the load's GB/s,
     beside the card's name and power limit. internlm2 at full depth,
     serve mode, round-tripped whole; phase 3's four requests served from
     the loaded params on the slot and the paged cache, the streams equal
     to phase 3's, mpmm, paged_attn and paged_scatter launched
     (paged_scatter once a layer and decode step). internlm2 at full width cut to 4 layers, train mode (a
     float ``w`` a linear): saved, loaded and converted by
     ``convert_model_to_serving``, every packed linear bit-equal to
     ``convert_linear_to_serving`` of the same ``w``, and the converted
     tree's greedy streams (slot) equal to the unconverted tree's, which
     converts on the fly. DeepSeek-V3's three MLA layers and MTP params,
     serve mode: the round trip alone.
 16. speculative decoding (run right after phase 14, on phase 3's internlm2
     w4a8 kv8 weights; its DeepSeek-V3 run right after phase 14's MLA run):
     ``ServeEngine(..., spec=..., spec_k=SPEC_K (4))``, 4 slots, s_max 1024,
     pages of 16. A round drafts SPEC_K tokens (chained unfused decode
     steps) and verifies the k+1 positions in one ``spec_verify_step`` (its
     attention over all k+1 rows in one call a product, through
     rowinv_bmm); both read the cache unfused, so every run's streams must
     equal (``held_equal``) a serialized unfused run's: self4 at full depth on slot and paged
     (phase 3's four, against phase 5's runs); ``mixed_paper`` at CUT_LAYERS,
     self4 on paged and on prefix (phase 9's five), against serialized runs
     made here (truncates > 0, the page pool conserved after every step);
     phase 13's sampled four at CUT_LAYERS, self4 on paged, equal to phase
     14's sampled serialized run; ``DraftModel()`` (its reduced draft at the
     full vocab) on paged at CUT_LAYERS, phase 3's two shortest requests
     with their prompts cut to 40 and 56 tokens; DeepSeek-V3's three MLA layers,
     self4 on paged, against phase 8's unfused run. Gates on every run
     (``gate_spec``): rounds ran; each round makes at most one host sync
     (``serve.boundary.counting_syncs``, with its ``.item()`` control);
     each draft step and each verify launches mpmm 7 L + 1 times (169 at
     full depth; a DraftModel step its own model's count), paged_scatter
     and paged_gather once a layer on a paged cache, rowinv_bmm twice (GQA)
     or five times (MLA) a layer; paged_attn and paged_mla_attn never. Printed: acceptance, mean accepted length,
     truncates, step EMA, TPOT / TTFT p50 and tokens/s beside the
     serialized fused and unfused runs, the device ms of one round's draft
     steps and of its verify, mpmm per verify (169 calls at M = 20) beside
     its bound, its plain version and ``torch._int_mm``, the phase's
     seconds and the card.
 17. the dense variants (run last, after phase 8's MLA path, on weights of
     their own, norms and biases redrawn from a seed): h2o-danube-1.8b at
     published widths and full depth (24 layers, 32 / 8 heads of 80, window
     4096), w4a8 with kv8: phase 3's four requests on slot and paged, fused
     (streams equal; mpmm at least seven times a layer a decode step,
     paged_attn once a layer a decode step, paged_scatter once a layer a
     decode step of the paged run), then unfused (streams equal;
     paged_gather once a layer a decode step, rowinv_bmm twice a layer a
     step or prefill chunk); fused against unfused printed, not gated. One
     whole-prompt ``prefill_step`` of phase 11's four prompts (flash_mha at
     D 80, once a layer) and ``qkv_decode`` at D 80 on that dense cache
     (once a layer, within ``row_tol`` of its plain version); flash_mha's
     time per prefill_step and qkv_decode's per call at danube's heads (the
     kernels line's D 80 rows). qwen1.5-4b (q / k / v biases, vocab 152064
     padded) and stablelm-3b (LayerNorm, vocab 50432 padded) at published
     widths cut to CUT_LAYERS: slot and paged, fused, streams equal. Every
     run prints its step EMA, TPOT / TTFT p50, tokens/s and peak memory;
     the phase its seconds and the card. Phase 2 holds flash_mha and
     qkv_decode at D 80 (kv8 and kv4) within ATTN_TOL of their plain
     versions and twice bit-identical, paged_attn (kv8, kv4, bf16) and
     flash_mha at the window of 4096 over WINDOW_KEYS (4608) keys, and the
     page movers on danube's D 80 leaves at kv8 and kv4; and rowinv_bmm at
     the seven products' serving shapes with 1, 5, 16 and 64 query rows
     (the first row bit-identical, within 1e-5 * (1 + max |einsum|)).
 18. the Mixture-of-Experts (run last, on weights of its own, norms
     redrawn): granite-moe-1b-a400m at published widths and full depth (24
     layers, 32 experts top-8 of width 512, 16 / 8 heads of 64, vocab 49155
     padded to 49408), w4a8 with kv8: phase 3's four requests on slot and
     paged, fused, then unfused (streams equal in each pair; three batched
     expert launches a MoE layer for each decode step and prefill chunk);
     the decode step's breakdown and the batched products' device time a
     decode step against their bound (the kernels line's mpmm_experts
     row); one whole-prompt ``prefill_step`` of phase 11's four prompts
     (flash_mha at D 64, the grouped dispatch: 32 groups, the experts at M
     = 768) and ``qkv_decode`` at D 64 on that dense cache (the D 64 rows);
     granite under mixed_paper (experts at w2) at CUT_LAYERS, slot and
     paged, fused, streams equal; DeepSeek-V3 at published widths cut to
     its three dense layers and its first expert layer (256 experts top-8,
     a shared expert), w4a8 with the 8-bit latent cache, slot and paged,
     fused, streams equal, its expert layer's batched products a decode
     step against their bytes bound. Phase 2 holds flash_mha and
     qkv_decode at granite's heads (D 64; kv8 and kv4) within ATTN_TOL of
     their plain versions and twice bit-identical.

Phases 3, 4, 5, 8, 9, 10, 11, 12, 13 and 15 each start with every launch count
at 0 (phase 8 once for its fused runs, once for its unfused runs, once for
its weight-only runs and once for its prefix run; phase 10 once for its slot
and paged runs and once for its prefix run; phase 11 once for prefill_step
and its decode steps and once for forward; phase 13 once for its slot and
paged runs and once for its prefix run; phase 15 once for its runs served
from disk and once for its train-to-serve runs) and read the counts at
their end;
the kernels line gives each kernel the count of its own path (paged_copy:
phase 9's prefix run; wdqmm: phase 10's slot and paged runs; flash_mha:
phase 11's prefill_step; qkv_decode: phase 12; rowinv_bmm: phase 5's
unfused runs, whose count is gated; the D 80 rows of flash_mha and
qkv_decode: phase 17's prefill_step and qkv_decode calls; the D 64 rows:
phase 18's; mpmm_experts: phase 18's fused granite runs and its
DeepSeek-V3 runs, each reset before it). Each of phase 14's
continuous runs starts at 0 too, and so does each of phase 16's two
full-depth runs. mpmm has four rows, told apart by their "at": per decode
step (phase 3's launches), per prefill_step (phase 11's prefill_step
launches), per mixed step (the launches of phase 14's three full-depth greedy
internlm2 runs) and per verify step (the launches of phase 16's two full-depth
runs).

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
#: (MLA) layers (phase 18 adds its first expert layer)
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 3
#: phase 18: granite-moe-1b-a400m at published widths and full depth (32
#: experts top-8 of width 512, 16 / 8 heads of 64), then DeepSeek-V3 cut to
#: its three dense layers and its first expert layer (256 experts top-8 and
#: a shared expert)
MOE_ARCH, MOE_MLA_LAYERS = "granite-moe-1b-a400m", 4
#: phase 2: the MoE's batched expert products (E, M, K, N): granite's gate /
#: up and down at a decode step (capacity 4) and at a whole 4 x 512
#: prefill_step (32 groups of 24 rows), DeepSeek-V3's at a decode step
EXPERT_SHAPES = ((32, 4, 1024, 512), (32, 4, 512, 1024), (32, 768, 1024, 512),
                 (256, 4, 7168, 2048), (256, 4, 2048, 7168))
#: phase 17: the dense variants. h2o-danube-1.8b at full depth (head dim 80,
#: a sliding window of 4096), qwen1.5-4b and stablelm-3b at CUT_LAYERS
D80_ARCH = "h2o-danube-1.8b"
VARIANTS = ("h2o-danube-1.8b", "qwen1.5-4b", "stablelm-3b")
#: phase 2: danube's window exercised over more keys than it covers
WINDOW_KEYS = 4608
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
#: the paper's Tab. 1 QntPack shape (M, N), and the accumulators of the
#: Reference Layer's conv at 224 x 224 (H * W, C_out)
TAB1 = (256, 64)
REF224_PHI = (224 * 224, 64)
#: launches per timed window for the per-call kernel times
CALLS = 50
#: phase 13: how the sampled requests decode, and the greedy / sampled
#: decode steps whose walls are compared
SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95)
STEP_PAIRS = 10
#: phase 14: the continuous engine's token budget a mixed step and its
#: steps in flight
MIXED_BUDGET, INFLIGHT = 16, 2
#: phase 16: draft tokens a speculation round; a verify scores SPEC_K + 1
#: positions a slot, so its projections run at M = N_SLOTS * (SPEC_K + 1)
SPEC_K = 4
#: phase 16's DraftModel run: its two prompts' lengths (the draft enters a
#: prompt one token a step; off the page grid, so rounds cross page ends)
DRAFT_PROMPTS = (40, 56)
#: the depth (at full width) of the runs that are held only to another run
#: of the same model: phase 10's weight-only prefix run against its cold
#: paged run, phase 13's serving runs against its own greedy run (and
#: prefix against cold paged), phase 14's sampled continuous run against its
#: serialized one, and phase 16's mixed_paper, sampled and DraftModel runs
#: against serialized runs made at this depth. Every gate on them
#: holds at any depth; the cut keeps the script within its time limit as
#: phases are added
CUT_LAYERS = 4


def cut(cfg, params):
    """``cfg`` and ``params`` cut to their first CUT_LAYERS layers at full
    width (the same tensors, no copy)."""
    return (dataclasses.replace(cfg, n_layers=CUT_LAYERS),
            dict(params, layers=params["layers"][:CUT_LAYERS]))


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
    """mpmm against its plain version, bit-exact: all 27 cells x 3 output
    kinds x signedness at three ragged shapes (the decode tiles, K % 16 != 0,
    the prefill tiles), the main path's cell at its shapes at M = 4, 16, 64
    (a continuous mixed step) and 2048; every built mpmm kernel's SASS holds
    tensor-core (IMMA) instructions."""
    from repro_torch.core import pack as P
    from repro_torch.core import quant as Q
    from repro_torch.core.policy import PERMUTATIONS
    from repro_torch.kernels import build, ops

    g = torch.Generator(device=dev).manual_seed(SEED)

    def operands(M, N, K, xb, wb):
        x = torch.randint(0, 1 << xb, (M, K), generator=g, device=dev, dtype=torch.int32)
        w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (N, K), generator=g, device=dev,
                          dtype=torch.int32)
        return P.pack(x.to(torch.uint8), xb), P.pack(w.to(torch.int8), wb)

    worst = 0
    n = 0
    # all cells x kinds x signedness at a small ragged shape, at K % 16 != 0,
    # and at a ragged shape of the prefill tiles (M > 16; a partial second
    # row tile, a partial column tile, a partial K stage staged by bytes)
    for (M, N, K) in ((37, 40, 96), (3, 24, 44), (150, 72, 200)):
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
    # the main path's cell (8, 4, 8), signed, f32 out, at its shapes: a
    # decode step, a prefill chunk, a speculative verify, a continuous mixed
    # step and a whole-prompt prefill_step; then mixed_paper's 8-bit cell
    # (8, 8, 8) at its attn_out and head shapes, a decode step and a verify
    M_verify = N_SLOTS * (SPEC_K + 1)
    d = cfg.d_model
    cases = [(M, N, K, 4) for M in (4, 16, M_verify, N_SLOTS * MIXED_BUDGET,
                                    N_SLOTS * PREFILL_LEN)
             for N, K, _ in main_path_mm_shapes(cfg)]
    cases += [(M, N, K, 8) for M in (4, M_verify)
              for N, K in ((d, cfg.n_heads * cfg.head_dim), (cfg.vocab_padded, d))]
    for M, N, K, wb in cases:
        x_p, w_p = operands(M, N, K, 8, wb)
        kw = dict(x_bits=8, w_bits=wb, y_bits=8, x_signed=True, out_kind="f32",
                  out_scale=torch.tensor(3.1e-4, device=dev))
        a = ops.mpmm(x_p, w_p, None, impl="cuda", **kw)
        b = ops.mpmm(x_p, w_p, None, impl="torch", **kw)
        torch.cuda.synchronize()
        worst = max(worst, float((a - b).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"mpmm mismatch at main-path shape M={M} N={N} K={K} w{wb}")
        n += 1
        del a, b
    report["mpmm"] = {"max_abs_err": worst, "checks": n}
    log(f"mpmm: {n} comparisons bit-exact (27 cells x 3 kinds x signedness at (37, 40, 96), "
        f"(3, 24, 44) and (150, 72, 200); main-path shapes at M = 4, 16, {M_verify}, "
        f"{N_SLOTS * MIXED_BUDGET} and {N_SLOTS * PREFILL_LEN}; mixed_paper's 8-bit attn_out "
        f"and head at M = 4 and {M_verify})")
    imma = {fn: c["IMMA"] for fn, c in sass_counts(build.library_path("mpmm"),
                                                    "mpmm_kernel").items()}
    log(f"  sass: {len(imma)} mpmm kernels, {min(imma.values())}-{max(imma.values())} IMMA each")
    if not imma or min(imma.values()) == 0:
        raise AssertionError(f"mpmm kernels without tensor-core (IMMA) instructions: {imma}")


def check_mpmm_experts(torch, dev, report):
    """mpmm over experts against its plain version (``mpmm_ref`` applied
    expert by expert), bit-exact, one launch a call: EXPERT_SHAPES on the
    expert cells of w4a8 (8, 4, 8) and mixed_paper (8, 2, 8), signed 8-bit
    activations, f32 out, each expert with its own out-scale."""
    from repro_torch.kernels import build, ops

    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    n, worst = 0, 0.0
    for E, M_, K, N in EXPERT_SHAPES:
        for wb in (4, 2):
            x_p = torch.randint(-128, 128, (E, M_, K), generator=g, device=dev,
                                dtype=torch.int32).to(torch.int8)
            w_p = torch.randint(-128, 128, (E, N, K * wb // 8), generator=g, device=dev,
                                dtype=torch.int32).to(torch.int8)
            scale = torch.rand((E,), generator=g, device=dev) * 1e-3
            kw = dict(x_bits=8, w_bits=wb, y_bits=8, x_signed=True, out_kind="f32",
                      out_scale=scale)
            n0 = build.LAUNCHES["mpmm_experts"]
            a = ops.mpmm(x_p, w_p, None, impl="cuda", **kw)
            launched = build.LAUNCHES["mpmm_experts"] - n0
            b = ops.mpmm(x_p, w_p, None, impl="torch", **kw)
            torch.cuda.synchronize()
            if launched != 1 or tuple(a.shape) != (E, M_, N) or not torch.equal(a, b):
                raise AssertionError(f"mpmm over experts (E, M, K, N) = {(E, M_, K, N)} w{wb}: "
                                     f"{launched} launches, shape {tuple(a.shape)}, bit-exact "
                                     f"{torch.equal(a, b)}")
            n += 1
            worst = max(worst, float((a - b).abs().max()))
            del x_p, w_p, a, b
    report["mpmm_experts"] = {"max_abs_err": worst, "checks": n}
    log(f"mpmm over experts: {n} comparisons bit-exact, one launch each ((E, M, K, N) in "
        f"{EXPERT_SHAPES}, cells (8, 4, 8) and (8, 2, 8))")


def check_wdqmm(torch, dev, cfg, mcfg, report):
    """wdqmm against its plain version (bf16 activations) at w 8, 4 and 2:
    the main-path (N, K) of internlm2 and of DeepSeek-V3's MLA-dense layers,
    heads included, at M = 4 and 16, internlm2's five projections at M =
    2048 (the prefill tiles), and a ragged shape (one partial chunk, byte
    staging); within WDQMM_TOL * sum_k |x w| of the plain version, the same
    call twice bit-identical, and each M = 2048 call's first four rows
    bit-identical to an M = 4 call on them. The largest error over sum |x w|
    is printed per K (up to DeepSeek-V3's 18432). The bf16 kernels' SASS
    holds tensor-core (HMMA) instructions, the f32 kernels' none."""
    from repro_torch.core import pack as P
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.wdqmm import TOL

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    eps = torch.tensor(3.7e-3, device=dev)
    shapes = [(N, K) for N, K, _ in main_path_mm_shapes(cfg)]
    shapes += mla_mm_shapes(mcfg)  # wq_b's K 1536 ends in a partial stage
    cases = [(M, N, K) for M in (N_SLOTS, 16) for N, K in shapes] + [(5, 37, 44)]
    cases += [(N_SLOTS * PREFILL_LEN, N, K) for N, K in shapes[:5]]
    worst = ratio = 0.0
    by_k: dict = {}
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
            if M > 16 and not torch.equal(
                    a[:N_SLOTS], ops.wdqmm(x[:N_SLOTS], w_p, eps, w_bits=wb, impl="cuda")):
                raise AssertionError(f"wdqmm w={wb} {(M, N, K)}: rows differ from an M = "
                                     f"{N_SLOTS} call on them")
            if not torch.isfinite(a).all() or bool((err > TOL * scale).any()):
                raise AssertionError(f"wdqmm w={wb} {(M, N, K)}: |kernel - plain| "
                                     f"{float(err.max())} above {TOL} * sum |x w|")
            r = float((err / scale.clamp_min(1e-30)).max())
            worst, ratio = max(worst, float(err.max())), max(ratio, r)
            by_k[K] = max(by_k.get(K, 0.0), r)
            n += 1
            del a, again, b, scale, err
    report["wdqmm"] = {"max_abs_err": worst, "tol": TOL, "max_err_ratio": ratio, "checks": n}
    log(f"wdqmm: {n} comparisons within {TOL:.3g} * sum |x w| of the plain version (largest "
        f"|kernel - plain| {worst:.3e}, at most {ratio:.3e} * sum |x w|), each call twice "
        f"bit-identical, rows at M = {N_SLOTS * PREFILL_LEN} identical to M = {N_SLOTS} (w "
        f"8/4/2; internlm2 and DeepSeek-V3 main-path shapes and heads, M = 4 and 16; "
        f"internlm2's five at M = {N_SLOTS * PREFILL_LEN}; ragged (5, 37, 44))")
    log("  max_err_ratio by K (|kernel - plain| / sum |x w|, in units of TOL): " + ", ".join(
        f"K {k}: {v / TOL:.4f}" for k, v in sorted(by_k.items())))
    sass = sass_counts(build.library_path("wdqmm"), "wdqmm")
    for kind, mark in (("bf16 (tensor-core)", True), ("f32 (CUDA-core)", False)):
        got = {fn: c for fn, c in sass.items() if ("mma_kernel" in fn) == mark}
        hmma = [c["HMMA"] for c in got.values()]
        log(f"  sass: {len(got)} {kind} wdqmm kernels, {min(hmma)}-{max(hmma)} HMMA, "
            f"{min(c['FFMA'] for c in got.values())}-{max(c['FFMA'] for c in got.values())} "
            f"FFMA each")
        if not got or (min(hmma) > 0) != mark or (max(hmma) > 0) != mark:
            raise AssertionError(f"wdqmm {kind} kernels: HMMA counts {hmma}; the bf16 kernels "
                                 f"must have some, the f32 kernels none")


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
    # h2o-danube-1.8b (32 / 8 heads of 80) at its published window over more
    # keys than it covers: slots at the last of WINDOW_KEYS rows, past the
    # window's first slide and at its edge
    from repro_torch import configs

    dcfg = configs.get_arch(D80_ARCH)
    nb = WINDOW_KEYS // PAGE_SIZE
    P_ = 3 * nb + 1
    for bits in (8, 4, None):
        k, ks = make_pool(torch, g, dev, P_, PAGE_SIZE, dcfg.kv_heads, dcfg.head_dim, bits)
        v, vs = make_pool(torch, g, dev, P_, PAGE_SIZE, dcfg.kv_heads, dcfg.head_dim, bits)
        q = torch.randn((3, dcfg.n_heads, dcfg.head_dim), generator=g, device=dev)
        bt = (torch.randperm(P_ - 1, generator=g, device=dev)[: 3 * nb] + 1).reshape(3, nb)
        bt = bt.to(torch.int32).contiguous()
        pos = torch.tensor([WINDOW_KEYS - 1, dcfg.window + 4, dcfg.window - 1],
                           dtype=torch.int32, device=dev)
        kw = dict(bits=bits, block_table=bt, window=dcfg.window)
        a = ops.paged_attn(q, k, ks, v, vs, pos, impl="cuda", **kw)
        again = ops.paged_attn(q, k, ks, v, vs, pos, impl="cuda", **kw)
        b = ops.paged_attn(q, k, ks, v, vs, pos, impl="torch", **kw)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        name = (f"paged_attn {D80_ARCH} D={dcfg.head_dim} bits={bits} window={dcfg.window} over "
                f"{WINDOW_KEYS} keys, pos {pos.tolist()}")
        if not torch.equal(a, again):
            raise AssertionError(f"{name}: two calls differ")
        if not torch.isfinite(a).all() or err > ATTN_TOL * (1 + float(b.abs().max())):
            raise AssertionError(f"{name}: err {err}")
        log(f"{name}: max |kernel - plain| = {err:.3e}, twice bit-identical")
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
    # the same call again, and each slot served alone or beside other
    # positions: the same bits (fixed splits and head groups, a fixed merge
    # order)
    for bits in (None, 8, 4):
        q_lat, q_rope, c, cs, r, p, bt = mla_case(torch, dev, mcfg, bits, g)
        call = lambda ql, qr, p_, b_: ops.paged_mla_attn(  # noqa: E731
            ql, qr, c, cs, r, p_, block_table=b_, bits=bits, scale=scale, impl="cuda")
        a = call(q_lat, q_rope, p, bt)
        if not torch.equal(a, call(q_lat, q_rope, p, bt)):
            raise AssertionError(f"paged_mla_attn bits={bits}: two calls differ")
        other = p.clone()
        other[0], other[2] = int(p[3]), 5
        moved = call(q_lat, q_rope, other, bt)
        alone = [call(q_lat[i:i + 1], q_rope[i:i + 1], p[i:i + 1], bt[i:i + 1])
                 for i in range(N_SLOTS)]
        if not (all(torch.equal(a[i:i + 1], x) for i, x in enumerate(alone))
                and torch.equal(a[1::2], moved[1::2])):
            raise AssertionError(f"paged_mla_attn bits={bits}: a slot's output depends on the "
                                 f"other slots")
    log("paged_mla_attn: each call twice bit-identical; each slot's output the same alone, in "
        "the batch and beside other positions")
    # the model's scale: the queries scaled by 2.7, so that the scores reach
    # ~20, where two f32 orders of sums part by about ATTN_TOL elementwise;
    # the kernel must stay within it of the exact attention (f64)
    from repro_torch.kernels.paged_attn import paged_mla_attn_f64

    def over(x, y):  # the largest |x - y| / (ATTN_TOL * (1 + |y|))
        return float(((x.double() - y).abs() / (ATTN_TOL * (1 + y.abs()))).max())

    for bits in (None, 8, 4):
        q_lat, q_rope, c, cs, r, p, bt = mla_case(torch, dev, mcfg, bits, g)
        args = (q_lat * 2.7, q_rope * 2.7, c, cs, r, p)
        kw = dict(bits=bits, scale=scale)
        a = ops.paged_mla_attn(*args, block_table=bt, impl="cuda", **kw)
        b = ops.paged_mla_attn(*args, block_table=bt, impl="torch", **kw)
        ex = paged_mla_attn_f64(*args, bt, **kw)
        err = float((a - b).abs().max())
        tol = ATTN_TOL * (1 + float(b.abs().max()))
        log(f"paged_mla_attn bits={bits} at the model's scale: kernel {over(a, ex):.3f}, plain "
            f"{over(b, ex):.3f} of ATTN_TOL from the exact attention (elementwise); max |kernel "
            f"- plain| = {err:.3e}")
        if not torch.isfinite(a).all() or err > tol or over(a, ex) > 1:
            raise AssertionError(f"paged_mla_attn bits={bits} at the model's scale: err {err} "
                                 f"> {tol}, or {over(a, ex)} x ATTN_TOL from the exact value")
        worst = max(worst, err)
    report["paged_mla_attn"] = {"max_abs_err": worst, "tol": ATTN_TOL}


def seeded(torch, g, a):
    """``a`` filled in place with seeded values of its dtype (any byte for
    int8 codes and packed int4)."""
    if a.dtype == torch.int8:
        return a.copy_(torch.randint(-128, 128, a.shape, generator=g, device=a.device,
                                     dtype=torch.int32))
    return a.copy_(torch.randn(a.shape, generator=g, device=a.device).mul(40).clamp(-100, 100))


def leaf_sets(torch, g, dev, cfg, mcfg, P_):
    """The leaf sets a layer's cache write and unfused read move as one
    group, as the model lays them out, (P_, PAGE_SIZE, ...) pools filled with
    seeded values: internlm2's K/V leaves and DeepSeek-V3's latent leaves at
    kv8, kv4 and on the bf16 cell, h2o-danube-1.8b's (head dim 80: 640-byte
    K / V rows at kv8, 320 at kv4) at kv8 and kv4."""
    from repro_torch import configs
    from repro_torch.models import attention as A

    dcfg = configs.get_arch(D80_ARCH)
    out = {}
    for bits in (8, 4, None):
        tag = "bf16" if bits is None else f"kv{bits}"
        out[f"internlm2 {tag}"] = A.cache_init(P_, PAGE_SIZE, cfg.kv_heads, cfg.head_dim, bits,
                                               dev)
        out[f"DeepSeek-V3 {tag}"] = A.mla_cache_init(P_, PAGE_SIZE, mcfg.mla_cfg, bits, dev)
        if bits is not None:
            out[f"{D80_ARCH} {tag}"] = A.cache_init(P_, PAGE_SIZE, dcfg.kv_heads, dcfg.head_dim,
                                                    bits, dev)
    return {k: [seeded(torch, g, a) for a in v.values()] for k, v in out.items()}


def same_bytes(torch, a, b) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def check_paged_scatter(torch, dev, cfg, mcfg, report):
    """paged_scatter against its plain version, bit-exact (the scratch page
    excluded): one leaf at a time on int8 / f32 / bf16 leaves, then one
    launch a group on every internlm2 and DeepSeek-V3 leaf set; unallocated
    entries and rows past the table included. S_new 16 at ragged per-slot
    positions is a continuous mixed step's write (MIXED_BUDGET rows a
    lane), S_new SPEC_K + 1 a speculative verify's; the second position set
    holds a lane at the speculative sentinel OUT_OF_RANGE (a draft step's
    lane that takes no part, whose rows go past the table) and a lane whose
    last rows run past its table."""
    from repro_torch.serve.spec import OUT_OF_RANGE
    from repro_torch.kernels import build, ops

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    nb = S_MAX // PAGE_SIZE
    P_ = N_SLOTS * nb + 1

    def table():
        bt = torch.randperm(P_ - 1, generator=g, device=dev)[: N_SLOTS * nb] + 1
        bt = bt.reshape(N_SLOTS, nb).to(torch.int32)
        bt[0, 5:] = 0  # unallocated entries land in the scratch page
        return bt

    # slot 2's rows run past its table; in the second set slot 2 sits at the
    # sentinel and slot 3's last rows run past
    positions = [torch.tensor(p, dtype=torch.int32, device=dev)
                 for p in ([0, 37, S_MAX - 8, 70], [0, 37, OUT_OF_RANGE, S_MAX - 3])]
    widths = (1, SPEC_K + 1, MIXED_BUDGET)
    cases = [(pos, S_new) for pos in positions for S_new in widths]
    leaves = ((torch.int8, (cfg.kv_heads, cfg.head_dim)), (torch.float32, (cfg.kv_heads,)),
              (torch.bfloat16, (cfg.kv_heads, cfg.head_dim)))
    for dtype, tail in leaves:
        pool = torch.randn((P_, PAGE_SIZE, *tail), generator=g, device=dev).mul(40)
        pool = pool.clamp(-100, 100).to(dtype)
        for pos, S_new in cases:
            new = torch.randn((N_SLOTS, S_new, *tail), generator=g, device=dev).mul(40)
            new = new.clamp(-100, 100).to(dtype)
            bt = table()
            a = ops.paged_scatter(pool.clone(), new, pos, bt, impl="cuda")
            b = ops.paged_scatter(pool.clone(), new, pos, bt, impl="torch")
            torch.cuda.synchronize()
            if not torch.equal(a[1:], b[1:]):
                raise AssertionError(f"paged_scatter mismatch dtype={dtype} S_new={S_new} "
                                     f"pos={pos.tolist()}")
    for name, pools in leaf_sets(torch, g, dev, cfg, mcfg, P_).items():
        for pos, S_new in cases:
            news = [seeded(torch, g, torch.empty((N_SLOTS, S_new, *a.shape[2:]), dtype=a.dtype,
                                                 device=dev)) for a in pools]
            bt = table()
            n0 = build.LAUNCHES["paged_scatter"]
            got = ops.paged_scatter_leaves([a.clone() for a in pools], news, pos, bt, impl="cuda")
            if build.LAUNCHES["paged_scatter"] != n0 + 1:
                raise AssertionError(f"paged_scatter group {name}: "
                                     f"{build.LAUNCHES['paged_scatter'] - n0} launches, want 1")
            want = ops.paged_scatter_leaves([a.clone() for a in pools], news, pos, bt,
                                            impl="torch")
            torch.cuda.synchronize()
            if not all(same_bytes(torch, x[1:], y[1:]) for x, y in zip(got, want)):
                raise AssertionError(f"paged_scatter group mismatch on {name} S_new={S_new} "
                                     f"pos={pos.tolist()}")
    report["paged_scatter"] = {"max_abs_err": 0.0}
    log("paged_scatter: bit-exact on int8 / f32 / bf16 leaves, and one launch a group on the "
        "internlm2 and DeepSeek-V3 leaf sets at kv8 / kv4 / bf16 and h2o-danube-1.8b's (D 80) "
        "at kv8 / kv4 (scratch page excluded), "
        f"S_new {', '.join(map(str, widths))} at per-slot positions "
        f"{' and '.join(str(p.tolist()) for p in positions)}")


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
    """conv2d against its plain version, bit-exact: all 27 cells (those the
    shape's widths can pack) at the paper's Reference Layer, at the ragged
    (5, 7, 12, 68) and (3, 9, 13, 66) (C not a multiple of 16 or even 2, a
    partial Cout tile), at (300, 16, 32, 64) (bands of two rows: the input
    row ring turns over), (2, 300, 32, 64) (two pixel segments a row and
    their halo) and (4, 10, 64, 24) (two k32 steps a tap); the quickstart's
    cell and one cell each of x = 4 and x = 2 at 224 x 224. Every built
    conv2d kernel's SASS holds tensor-core (IMMA) instructions."""
    from repro_torch.core.policy import PERMUTATIONS
    from repro_torch.kernels import build, ops

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    paper = ref_layer()
    shapes = [(shape, PERMUTATIONS) for shape in (paper, (5, 7, 12, 68), (3, 9, 13, 66),
                                                  (300, 16, 32, 64), (2, 300, 32, 64),
                                                  (4, 10, 64, 24))]
    shapes.append(((224, 224, *paper[2:]), ((8, 4, 4), (4, 8, 2), (2, 2, 8))))
    n = 0
    for (H, W, C, Cout), cells in shapes:
        for xb, wb, yb in cells:
            if C % (8 // xb) or (9 * C) % (8 // wb) or Cout % (8 // yb):
                continue
            x_p, w_p, rq = conv_operands(torch, g, dev, H, W, C, Cout, xb, wb, yb)
            bits = dict(x_bits=xb, w_bits=wb, y_bits=yb)
            a = ops.conv2d(x_p, w_p, rq, impl="cuda", **bits)
            b = ops.conv2d(x_p, w_p, rq, impl="torch", **bits)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"conv2d mismatch cell {(xb, wb, yb)} shape {(H, W, C, Cout)}")
            n += 1
    report["conv2d"] = {"max_abs_err": 0.0, "checks": n}
    log(f"conv2d: {n} comparisons bit-exact (27 cells at {paper}, (5, 7, 12, 68), "
        f"(3, 9, 13, 66), (300, 16, 32, 64), (2, 300, 32, 64) and (4, 10, 64, 24) where the "
        f"widths pack; 3 cells at 224 x 224)")
    imma = {fn: c["IMMA"] for fn, c in sass_counts(build.library_path("conv2d"),
                                                    "conv2d_kernel").items()}
    log(f"  sass: {len(imma)} conv2d kernels, {min(imma.values())}-{max(imma.values())} IMMA each")
    if not imma or min(imma.values()) == 0:
        raise AssertionError(f"conv2d kernels without tensor-core (IMMA) instructions: {imma}")


def check_qntpack(torch, dev, report):
    """qntpack against its plain version, bit-exact, at y = 8, 4 and 2: at
    the Tab. 1 shape with accumulators at the int32 edges (acc + bias wraps,
    as JAX's add does), at a ragged shape (111 output bytes: 27 words and a
    3-byte tail), on a flat ``phi[1:]`` view (4 bytes off the 16-byte grid:
    the byte path) and, at y = 4 and 2, with a hand-made vector whose
    thresholds do not ascend (the ladder counts them in any order); the
    same call twice bit-identical."""
    import numpy as np

    from repro_torch.core import quant as Q
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    n = 0
    for yb in (8, 4, 2):
        ry = 8 // yb
        rq = Q.make_requant_params(y_bits=yb, eps_phi=(1 << yb) / 2.0**21, eps_y=1.0,
                                   lam=float(1 << 20))
        shuffled = dataclasses.replace(
            rq, thresholds=np.random.RandomState(yb).permutation(rq.thresholds).astype(np.int32))
        for shape in (TAB1, (37, 3 * ry)):
            phi = torch.randint(-(1 << 20), 1 << 20, shape, generator=g, device=dev,
                                dtype=torch.int32)
            # accumulators at the int32 edges: acc + bias wraps, as JAX's add does
            phi[0] = (1 << 31) - 1 - torch.arange(shape[1], dtype=torch.int32, device=dev)
            phi[1] = -(1 << 31) + torch.arange(shape[1], dtype=torch.int32, device=dev)
            flat = torch.empty(phi.numel() + 1, dtype=torch.int32, device=dev)
            flat[1:].copy_(phi.reshape(-1))
            for x in (phi, flat[1:].view(shape)):
                for r in (rq, shuffled) if yb < 8 else (rq,):
                    a = ops.qntpack(x, r, y_bits=yb, impl="cuda")
                    a2 = ops.qntpack(x, r, y_bits=yb, impl="cuda")
                    b = ops.qntpack(x, r, y_bits=yb, impl="torch")
                    torch.cuda.synchronize()
                    if not (torch.equal(a, b) and torch.equal(a, a2)):
                        raise AssertionError(
                            f"qntpack mismatch y_bits={yb} shape={shape} phi off 16 B by "
                            f"{x.data_ptr() % 16} thresholds ascending {r is rq}")
                    n += 1
    report["qntpack"] = {"max_abs_err": 0.0, "checks": n}
    log(f"qntpack: {n} comparisons bit-exact on y = 8, 4, 2 at (M, N) = {TAB1} and at a ragged "
        f"shape (37, 3 ry), int32-edge accumulators included, phi aligned and 4 bytes off "
        f"the 16-byte grid, ascending and shuffled thresholds (y = 4, 2); each call twice "
        f"bit-identical")


def check_paged_gather(torch, dev, cfg, mcfg, report):
    """paged_gather against its plain version, bit-exact: one leaf at a time
    on every cache leaf and on 15-byte pages, then one launch a group on
    every internlm2 and DeepSeek-V3 leaf set; unallocated entries, ids past
    the pool and negative ids included."""
    from repro_torch.kernels import build, ops

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
    for name, pools in leaf_sets(torch, g, dev, cfg, mcfg, P_).items():
        n0 = build.LAUNCHES["paged_gather"]
        got = ops.paged_gather_leaves(pools, bt, impl="cuda")
        if build.LAUNCHES["paged_gather"] != n0 + 1:
            raise AssertionError(f"paged_gather group {name}: "
                                 f"{build.LAUNCHES['paged_gather'] - n0} launches, want 1")
        want = ops.paged_gather_leaves(pools, bt, impl="torch")
        torch.cuda.synchronize()
        if not all(x.shape == y.shape and same_bytes(torch, x, y) for x, y in zip(got, want)):
            raise AssertionError(f"paged_gather group mismatch on {name}")
    report["paged_gather"] = {"max_abs_err": 0.0}
    log("paged_gather: bit-exact on int8 / packed int4 / bf16 / f32-scale leaves and 15-byte "
        "pages, and one launch a group on the internlm2 and DeepSeek-V3 leaf sets at kv8 / kv4 "
        "/ bf16 and h2o-danube-1.8b's (D 80) at kv8 / kv4; ids past the pool and negative ids "
        "included")


def clone_sets(torch, g, dev, cfg, mcfg, P_):
    """The leaf sets a COW clone moves as one group, as the prefix cache
    passes them (every leaf of every layer, (P_, PAGE_SIZE, ...) pools
    filled with seeded values): internlm2 at full depth and DeepSeek-V3 cut
    to its MLA_LAYERS dense layers, at kv8, kv4 and on the bf16 cell;
    h2o-danube-1.8b at full depth (head dim 80) at kv8 and kv4."""
    from repro_torch import configs
    from repro_torch.models import attention as A

    dcfg = configs.get_arch(D80_ARCH)
    out = {}
    for bits in (8, 4, None):
        tag = "bf16" if bits is None else f"kv{bits}"
        for name, c in (("internlm2", cfg), (D80_ARCH, dcfg)):
            if bits is None and c is dcfg:
                continue
            out[f"{name} {tag}"] = [
                a for _ in range(c.n_layers)
                for a in A.cache_init(P_, PAGE_SIZE, c.kv_heads, c.head_dim, bits, dev).values()]
        out[f"DeepSeek-V3 {tag}"] = [
            a for _ in range(MLA_LAYERS)
            for a in A.mla_cache_init(P_, PAGE_SIZE, mcfg.mla_cfg, bits, dev).values()]
    return {k: [seeded(torch, g, a) for a in v] for k, v in out.items()}


def check_paged_copy(torch, dev, cfg, mcfg, report):
    """paged_copy's group against its plain version, bit-exact: one call on
    every leaf of an internlm2 (24 layers) and a DeepSeek-V3 (3 layers)
    clone at kv8, kv4 and on the bf16 cell, and on a set with 15-byte pages
    of another page count (the byte path); disjoint host ids (one launch,
    gated), negative ids, ids past the pool (a source clamps, a destination
    is dropped), an overlap (a dst page read later as a src reads the
    original bits) and a self-copy (two launches through the staging
    buffer), and device ids (two launches); the same call twice
    bit-identical."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.paged_gather import copy_launches

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    P_ = 33
    sets = clone_sets(torch, g, dev, cfg, mcfg, P_)
    odd = torch.randn((9, 3, 5), generator=g, device=dev).mul(40).clamp(-100, 100)
    sets["15-byte pages"] = [odd.to(torch.int8), sets["internlm2 kv8"][2]]
    cases = (([1], [2]), ([3, 17], [30, 31]), ([5, -1], [7, 20]), ([40, 2], [6, 41]),
             ([1, 2], [2, 3]), ([5], [5]))
    n = 0
    for name, pools in sets.items():
        for src, dst in cases:
            s_, d_ = (torch.tensor(x, dtype=torch.int32) for x in (src, dst))
            want = ops.paged_copy_leaves([a.clone() for a in pools], s_, d_, impl="torch")
            host = copy_launches([a.shape[0] for a in pools], src, dst)
            for ids, launches in (((s_, d_), host), ((s_, d_), host),
                                  ((s_.to(dev), d_.to(dev)), 2)):
                n0 = build.LAUNCHES["paged_copy"]
                got = ops.paged_copy_leaves([a.clone() for a in pools], *ids, impl="cuda")
                if build.LAUNCHES["paged_copy"] - n0 != launches:
                    raise AssertionError(f"paged_copy group {name} src={src} dst={dst}: "
                                         f"{build.LAUNCHES['paged_copy'] - n0} launches, want "
                                         f"{launches}")
                torch.cuda.synchronize()
                if not all(same_bytes(torch, x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"paged_copy group mismatch on {name} src={src} "
                                         f"dst={dst} ids on {ids[0].device}")
                n += 1
    report["paged_copy"] = {"max_abs_err": 0.0, "checks": n}
    log(f"paged_copy: {n} group calls bit-exact ({', '.join(sets)}; disjoint host ids in one "
        f"launch, negative ids, ids past the pool, an overlap and a self-copy in two, device "
        f"ids in two; each host-id call run twice)")


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
    the count of tensor-core (HMMA: bf16 / f16, IMMA: int8) and f32 FMA
    (FFMA) instructions in its SASS (``cuobjdump -sass``)."""
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
                counts[fn] = {"HMMA": 0, "IMMA": 0, "FFMA": 0}
        elif fn:
            for op in ("HMMA", "IMMA", "FFMA"):
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
    bit-identical to the 16-byte path on the same values); then
    h2o-danube-1.8b's heads (D 80) in bf16 and f32, strided, on the 4-byte
    path and at its window of 4096 over one sequence of WINDOW_KEYS; then
    granite-moe-1b-a400m's (D 64) in bf16 (also at the model's sizes) and
    f32, strided and windowed, on the 4-byte path. Both
    refuse a window that leaves a row with no key (Sq 300, Sk 100, window 50). The
    bf16 kernel's SASS must hold tensor-core (HMMA) instructions, the f32
    kernel's none."""
    from repro_torch import configs
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
    # h2o-danube-1.8b's heads (32 / 8 of 80): a prefill_step's shape, f32,
    # ragged and strided operands, the 4-byte staging path, and its published
    # window over one sequence of WINDOW_KEYS
    dcfg = configs.get_arch(D80_ARCH)
    dq, dkv, dd, dw = dcfg.n_heads, dcfg.kv_heads, dcfg.head_dim, dcfg.window
    cases += [((N_SLOTS, 512, 512, dq, dkv, dd, bf16, "bshd"), True, dw, {}),
              ((N_SLOTS, 512, 512, dq, dkv, dd, bf16, "bshd"), True, None, model),
              ((2, 100, 100, dq, dkv, dd, f32, "bshd"), True, None, {}),
              ((2, 100, 300, dq, dkv, dd, bf16, "bhsd"), True, 70, {}),
              ((2, 150, 150, dq, dkv, dd, bf16, "bshd"), True, 70, dict(offset=4)),
              ((1, WINDOW_KEYS, WINDOW_KEYS, dq, dkv, dd, bf16, "bshd"), True, dw, {})]
    # granite-moe-1b-a400m's heads (16 / 8 of 64): its prefill_step's shape,
    # at the model's sizes, f32 ragged, strided and windowed, the 4-byte path
    gcfg = configs.get_arch(MOE_ARCH)
    gq, gkv, gd = gcfg.n_heads, gcfg.kv_heads, gcfg.head_dim
    cases += [((N_SLOTS, 512, 512, gq, gkv, gd, bf16, "bshd"), True, None, {}),
              ((N_SLOTS, 512, 512, gq, gkv, gd, bf16, "bshd"), True, None, model),
              ((2, 100, 100, gq, gkv, gd, f32, "bshd"), True, None, {}),
              ((2, 100, 300, gq, gkv, gd, bf16, "bhsd"), True, 70, {}),
              ((2, 150, 150, gq, gkv, gd, bf16, "bshd"), True, 70, dict(offset=4))]
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
    and 1023, and 900: inside the last run of keys); one run of keys (S 100
    and S = KEYS_PER_SPLIT, kv8 and kv4); h2o-danube-1.8b's heads (32 / 8 of
    80: 80-byte rows at kv8, 40 at kv4) and granite-moe-1b-a400m's (16 / 8
    of 64: 8 code bytes a lane at kv8) at internlm2's positions."""
    from repro_torch import configs
    from repro_torch.kernels import qkv_decode as QD

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    Hq, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    cases = [(2, 32, 2 * gqa, 2, 16, bits, pos, bs)
             for bits, gqa, pos, bs in ((8, 1, 30, 8), (8, 2, 12, 8), (4, 1, 31, 8), (8, 2, -1, 8),
                                        (4, 2, 0, 32), (8, 1, 7, 8), (4, 2, 8, 8))]
    cases += [(N_SLOTS, S_MAX, Hq, Hkv, D, bits, pos, 512) for bits in (8, 4)
              for pos in (0, 511, 900, 1023)]
    kps = QD.KEYS_PER_SPLIT
    cases += [(3, 100, Hq, Hkv, D, 8, 70, 100), (2, kps, Hq, Hkv, D, 4, kps - 1, kps)]
    dcfg = configs.get_arch(D80_ARCH)  # h2o-danube-1.8b: 32 / 8 heads of 80
    cases += [(N_SLOTS, S_MAX, dcfg.n_heads, dcfg.kv_heads, dcfg.head_dim, bits, pos, 512)
              for bits in (8, 4) for pos in (0, 511, 900, 1023)]
    gcfg = configs.get_arch(MOE_ARCH)  # granite-moe-1b-a400m: 16 / 8 heads of 64
    cases += [(N_SLOTS, S_MAX, gcfg.n_heads, gcfg.kv_heads, gcfg.head_dim, bits, pos, 512)
              for bits in (8, 4) for pos in (0, 511, 900, 1023)]
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


def rowinv_shapes(cfg, mcfg):
    """The unfused read's seven f32 products as the model calls them: (spec,
    letter sizes but the query rows') at internlm2's GQA read (4 slots, its
    heads, S_MAX cache rows) and DeepSeek-V3's absorbed MLA read."""
    B, T = N_SLOTS, S_MAX
    gqa = dict(b=B, h=cfg.n_heads, d=cfg.head_dim, k=T)
    mla = dict(b=B, h=mcfg.n_heads, c=mcfg.kv_lora, t=T)
    return [("bqhd,bkhd->bhqk", gqa), ("bhqk,bkhd->bqhd", gqa),
            ("bshd,hdc->bshc", dict(mla, d=mcfg.d_nope)), ("bshc,btc->bhst", mla),
            ("bshd,btd->bhst", dict(mla, d=mcfg.d_rope)), ("bhst,btc->bshc", mla),
            ("bshc,hdc->bshd", dict(mla, d=mcfg.d_v))]


def rowinv_operands(torch, g, dev, spec, sizes, rows):
    """Unit-normal f32 operands of ``spec`` with ``rows`` query rows."""
    from repro_torch.kernels.rowinv import plan

    p = plan(spec)
    size = dict(sizes, **{p.m: rows})
    return [torch.randn([size[c] for c in letters], generator=g, device=dev)
            for letters in (p.a, p.b)]


def check_rowinv(torch, dev, cfg, mcfg, report):
    """rowinv_bmm (the port's own kernel for the unfused read's f32
    products) at the seven products' serving shapes (``rowinv_shapes``),
    with 1, SPEC_K + 1 (a verify's window), MIXED_BUDGET (a mixed step) and
    64 query rows: the first row's output bit-identical whatever the number
    of rows beside it, each call within TOL * (1 + max |einsum|) of the
    plain version (``torch.einsum``) and of the exact (f64) product, the
    same call twice bit-identical."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rowinv import TOL, plan

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    counts = (1, SPEC_K + 1, MIXED_BUDGET, 64)
    worst = 0.0
    for spec, sizes in rowinv_shapes(cfg, mcfg):
        p = plan(spec)
        a, b = rowinv_operands(torch, g, dev, spec, sizes, max(counts))
        ax, ox = p.a.index(p.m), p.out.index(p.m)
        first, errs = None, []
        for rows in counts:
            part = a.narrow(ax, 0, rows).contiguous()
            got = ops.rowinv_einsum(spec, part, b, impl="cuda")
            again = ops.rowinv_einsum(spec, part, b, impl="cuda")
            want = ops.rowinv_einsum(spec, part, b, impl="torch")
            exact = torch.einsum(spec, part.double(), b.double())
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            bound = TOL * (1 + float(want.abs().max()))
            name = f"rowinv_bmm {spec} {sizes} at {rows} rows"
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two calls differ")
            if not torch.isfinite(got).all() or err > bound or float(
                    (got.double() - exact).abs().max()) > bound:
                raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} (bound {bound:.3e}) "
                                     f"or off the exact product")
            row = got.narrow(ox, 0, 1)
            first = row if first is None else first
            if not torch.equal(row, first):
                raise AssertionError(f"{name}: the first row's bits differ from its bits alone")
            errs.append(err)
            worst = max(worst, err)
        log(f"rowinv_bmm {spec} {sizes}: the first query row bit-identical alone and among "
            f"{', '.join(map(str, counts[1:]))} rows; max |kernel - plain| "
            f"{', '.join(f'{e:.3e}' for e in errs)} (bound TOL * (1 + max |plain|)); each call "
            f"twice bit-identical")
    report["rowinv_bmm"] = {"max_abs_err": worst, "tol": TOL}


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
    reqs = reqs if reqs is not None else requests(cfg, Request)
    want_len = {r.rid: r.max_new for r in reqs}
    try:
        out = eng.run(reqs, on_token=peak_shared if cache == "prefix" else None)
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
    mode = "" if all(r.params is None or r.params.greedy for r in reqs) else ", sampled"
    log(f"serve[{cfg.name}, {policy.name}, {cache}{'' if fused_attn else ', unfused'}{mode}]: {toks} tokens in {dt:.3f} s ({toks / dt:.2f} tokens/s end to end), "
        f"{m['decode_steps']} decode steps, step EMA {m['step_ema_s'] * 1e3:.2f} ms, "
        f"TTFT p50 {m['slo/ttft_p50_s']:.3f} s, TPOT p50 {m['slo/tpot_p50_s'] * 1e3:.2f} ms, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{pages}")
    for rid, t in out.items():
        if len(t) != want_len[rid] or not all(0 <= x < cfg.vocab_padded for x in t):
            raise AssertionError(f"request {rid}: bad output {t}")
    return out, m


def once_a_layer(name, launched, m, cfg, what) -> None:
    """Gate a page mover's launches on a paged run: one group a layer and
    decode step (chunked prefill writes its pages by plain indexing)."""
    want = cfg.n_layers * m["decode_steps"]
    if launched != want:
        raise AssertionError(f"{what}: {launched} {name} launches, want one a layer and decode "
                             f"step ({cfg.n_layers} x {m['decode_steps']} = {want})")
    log(f"{what}: {name} launched {launched} times, {cfg.n_layers} a decode step "
        f"({m['decode_steps']} steps)")


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
    if launches["paged_copy"] != mw["cache/cow_copies"]:
        raise AssertionError(f"{key}prefix path: {launches['paged_copy']} paged_copy launches "
                             f"for {mw['cache/cow_copies']} COW clones (want one a clone)")
    if not (mw["cache/prefix_hit_rate"] > 0 and mw["cache/cow_copies"] >= 3):
        raise AssertionError(f"{key}prefix path: hit rate {mw['cache/prefix_hit_rate']}, "
                             f"{mw['cache/cow_copies']} COW clones (want > 0 and >= 3)")
    if not mw["prefill_jit_calls"] < mc["prefill_jit_calls"]:
        raise AssertionError(f"{key}prefix path: {mw['prefill_jit_calls']} prefill calls, cold "
                             f"{mc['prefill_jit_calls']}")
    log(f"{key}prefix streams identical to the cold paged streams; paged_copy launched "
        f"{launches['paged_copy']} times for {mw['cache/cow_copies']} COW clones; prefill calls "
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
    pad = torch.zeros(1, device="cuda")
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            # the warm-up step (its events dropped) runs fn and enough
            # kernels that the first device events a window loses are
            # among them, as in ``_htod_events``
            fn()
            for _ in range(64):
                pad.add_(1)
            torch.cuda.synchronize()
            prof.step()
            n0 = build.total_launches()
            fn()
            torch.cuda.synchronize()
            launched = build.total_launches() - n0
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


def _htod_events(torch, dev, fn) -> int:
    from torch.profiler import ProfilerActivity, profile, schedule

    pad = torch.zeros(1, device=dev)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        # the warm-up step (its events dropped) runs fn and enough kernels
        # that the first device events a window loses are among them
        fn()
        for _ in range(64):
            pad.add_(1)
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    return sum(e.count for e in prof.key_averages() if "Memcpy HtoD" in e.key)


def htod_copies(torch, dev, fn) -> int:
    """Host-to-device copies (the profiler's ``Memcpy HtoD`` device events)
    in the second of two calls of ``fn()``. Each call follows one upload of
    its own in the same window, the control, which the count leaves out: a
    window that shows no upload lost its events (seen once in a run of
    ``chip_smoke.py``, with the control in a window of its own). Up to three
    windows are read; then it raises: the count could not be read."""
    def behind_control():
        torch.ones(4).to(dev)
        fn()

    for _ in range(3):
        n = _htod_events(torch, dev, behind_control)
        if n:
            return n - 1
    raise AssertionError("the profiler shows no Memcpy HtoD for an upload in three windows: "
                         "host-to-device copies cannot be counted here")


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
    try:
        torch._int_mm(torch.zeros((B, 64), dtype=torch.int8, device=dev),
                      torch.zeros((8, 64), dtype=torch.int8, device=dev).t())
    except RuntimeError as e:
        log(f"  mpmm decode library yardstick: torch._int_mm refuses M = {B} ({e}); none")
    rows.append(dict(name="mpmm", at=f"decode step, M = {B}", route="cuda",
                     source="src/repro_torch/csrc/mpmm.cu",
                     replaces="src/repro/kernels/mpmm.py:122", ms=t, plain_ms=tp,
                     bytes=nbytes, work=[(nops, INT8_OPS_PER_S)], library_ms=None))

    # paged_attn: one call per layer at kv8, each layer on its own page pool
    cases = [attn_case(torch, dev, cfg, 8, g) for _ in range(L)]
    kw = dict(bits=8)

    def attn_step(impl):
        return lambda: [ops.paged_attn(q, k, ks, v, vs, pos, block_table=bt, impl=impl, **kw)
                        for q, k, ks, v, vs, pos, bt in cases]

    t, tw, how = device_ms(attn_step("cuda"))
    tp, tpw, _ = device_ms(attn_step("torch"), reps=1, warmup=0)  # ~2 s a step
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

    # the launch floor: one empty kernel's device time, printed beside the
    # launch-bound rows (the bound's formula does not change)
    from repro_torch.kernels.paged_gather import launch_floor_cuda

    floor, _, howf = device_ms(lambda: [launch_floor_cuda(dev) for _ in range(CALLS)],
                               names=("empty_kernel",))
    floor /= CALLS
    log(f"  launch floor: one empty kernel {floor * 1e3:.2f} us device ({CALLS} back to back, "
        f"{howf})")

    # paged_scatter: one group a layer, as the model calls it (its pool's 4
    # leaves, one new row per slot); the single-leaf route (a launch a leaf)
    # and the library yardstick (an index_put_ a leaf) beside it
    groups = [([c[1], c[2], c[3], c[4]], c[5], c[6]) for c in cases]
    news = [[torch.ones((B, 1, *a.shape[2:]), dtype=a.dtype, device=dev) for a in leaves]
            for leaves, _, _ in groups]

    def scatter_step(impl):
        return lambda: [ops.paged_scatter_leaves(lv, n, p, b, impl=impl)
                        for (lv, p, b), n in zip(groups, news)]

    def scatter_leaf_by_leaf():
        return [ops.paged_scatter(a, n_, p, b, impl="cuda")
                for (lv, p, b), n in zip(groups, news) for a, n_ in zip(lv, n)]

    idx = []
    for lv, p, b in groups:
        page = b.long().gather(1, (p.long() // PAGE_SIZE)[:, None])[:, 0]
        idx += [(page, p.long() % PAGE_SIZE)] * len(lv)
    flat = [(a, n_) for (lv, _, _), n in zip(groups, news) for a, n_ in zip(lv, n)]
    lib_step = lambda: [a.index_put_(ix, n_[:, 0])  # noqa: E731
                        for (a, n_), ix in zip(flat, idx)]
    t, tw, how = device_ms(scatter_step("cuda"))
    t1, t1w, _ = device_ms(scatter_leaf_by_leaf)
    tp, tpw, _ = device_ms(scatter_step("torch"))
    tl, tlw, _ = device_ms(lib_step)
    nbytes = sum(2 * n_.numel() * n_.element_size() + B * 8 for _, n_ in flat)
    log(f"  paged_scatter, one decode step ({len(groups)} group calls of {len(flat)} leaves): "
        f"{t:.4f} ms device ({how}), {t / len(groups) * 1e3:.2f} us a launch against the "
        f"{floor * 1e3:.2f} us floor, {tw:.3f} ms wall; leaf by leaf ({len(flat)} launches) "
        f"{t1:.4f} ms device, {t1w:.3f} ms wall; plain {tp:.4f} ms device, {tpw:.3f} ms wall; "
        f"index_put_ ({len(flat)} calls) {tl:.4f} ms device, {tlw:.3f} ms wall")
    rows.append(dict(name="paged_scatter", route="cuda",
                     source="src/repro_torch/csrc/paged_scatter.cu",
                     replaces="src/repro/kernels/paged_gather.py:91", ms=t, plain_ms=tp,
                     bytes=nbytes, work=[], library_ms=tl))

    # paged_gather: the unfused step reads every layer's 4 leaves through
    # the block table (B = 4, 64 pages each), one group a layer; the
    # single-leaf route and the library yardstick (an index_select a leaf)
    # beside it
    def gather_step(impl):
        return lambda: [ops.paged_gather_leaves(lv, b, impl=impl) for lv, _, b in groups]

    def gather_leaf_by_leaf():
        return [ops.paged_gather(a, b, impl="cuda") for lv, _, b in groups for a in lv]

    lib_gather = lambda: [a.index_select(0, b.flatten())  # noqa: E731
                          for lv, _, b in groups for a in lv]
    t, tw, how = device_ms(gather_step("cuda"))
    t1, t1w, _ = device_ms(gather_leaf_by_leaf)
    tp, tpw, _ = device_ms(gather_step("torch"))
    tl, tlw, _ = device_ms(lib_gather)
    nbytes = sum(2 * b.numel() * a[0].numel() * a.element_size() + b.numel() * 4
                 for lv, _, b in groups for a in lv)
    kv = sum(2 * b.numel() * lv[0][0].numel() * lv[0].element_size() * 2 for lv, _, b in groups)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  paged_gather, one unfused decode step ({len(groups)} group calls of "
        f"{sum(len(lv) for lv, _, _ in groups)} leaves, {nbytes / 1e6:.1f} MB moved, "
        f"{kv / 1e6:.1f} of it K/V codes): {t:.4f} ms device ({how}), "
        f"{nbytes / t / 1e6:.0f} GB/s, {bound / t:.2f} of the bound, "
        f"{t / len(groups) * 1e3:.2f} us a launch against the {floor * 1e3:.2f} us floor, "
        f"{tw:.3f} ms wall; leaf by leaf ({sum(len(lv) for lv, _, _ in groups)} launches) "
        f"{t1:.4f} ms device, {t1w:.3f} ms wall; plain {tp:.4f} ms device, {tpw:.3f} ms wall; "
        f"index_select {tl:.4f} ms device, {tlw:.3f} ms wall")
    rows.append(dict(name="paged_gather", route="cuda",
                     source="src/repro_torch/csrc/paged_gather.cu",
                     replaces="src/repro/kernels/paged_gather.py:52", ms=t, plain_ms=tp,
                     bytes=nbytes, work=[], library_ms=tl))

    # paged_copy: one COW clone as the prefix cache makes it, page 1 into
    # page 2 on every leaf of every layer (4 x 24 = 96 leaves) with host ids,
    # one launch; beside it the same leaves one launch each (the first
    # design's call pattern), the plain version and the library pair (an
    # index_select and an index_copy_ a leaf, ids on the card). After the
    # set's first clone a clone must copy nothing to the card (gated)
    src, dst = torch.tensor([1], dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    cow = [a for lv, _, _ in groups for a in lv]
    clone = lambda: ops.paged_copy_leaves(cow, src, dst, impl="cuda")  # noqa: E731
    t, tw, how = device_ms(clone, names=("paged_copy_kernel",))
    t1, t1w, _ = device_ms(lambda: [ops.paged_copy(a, src, dst, impl="cuda") for a in cow],
                           names=("paged_copy_kernel",))
    tp, tpw, _ = device_ms(lambda: ops.paged_copy_leaves(cow, src, dst, impl="torch"))
    s_dev, d_dev = src.to(dev).long(), dst.to(dev).long()
    tl, tlw, _ = device_ms(lambda: [a.index_copy_(0, d_dev, a.index_select(0, s_dev))
                                    for a in cow])
    htod = htod_copies(torch, dev, clone)
    if htod:
        raise AssertionError(f"a COW clone after the set's first copied {htod} times to the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        clone()
    torch.cuda.synchronize()
    host_wall = (time.perf_counter() - t0) * 1e3 / 20
    nbytes = sum(2 * a[0].numel() * a.element_size() for a in cow) + 8
    log(f"  paged_copy, one COW clone ({len(cow)} leaves, {nbytes / 1e6:.3f} MB moved): "
        f"{t * 1e3:.2f} us device in one launch ({how}), {tw:.3f} ms wall, {host_wall:.4f} ms "
        f"on the host's clock (20 clones, then one synchronize), {htod} Memcpy HtoD a clone; "
        f"leaf by leaf ({len(cow)} launches) {t1 * 1e3:.2f} us device, {t1w:.3f} ms wall; plain "
        f"{tp:.4f} ms device, {tpw:.3f} ms wall; index_select + index_copy_ (ids on the card) "
        f"{tl:.4f} ms device, {tlw:.3f} ms wall")
    rows.append(dict(name="paged_copy", route="cuda", source="src/repro_torch/csrc/paged_copy.cu",
                     replaces="src/repro/kernels/paged_gather.py:141", ms=t, plain_ms=tp,
                     bytes=nbytes, work=[], library_ms=tl))

    rows.append(rowinv_row(torch, dev, cfg, g))
    rows += reference_layer_rows(torch, dev, g)
    return [kernel_row(r, launches, report) for r in rows]


def rowinv_row(torch, dev, cfg, g) -> dict:
    """rowinv_bmm per unfused decode step (4 slots at 159..543 cached rows,
    the read over all S_MAX logical rows, masked): q . k and p . v of every
    layer, each layer on its own dequantized K / V (f32, kv heads
    repeated, as ``attn_apply`` passes them), so the 50 MB L2 holds none of
    them between uses; beside its bound (the operands read once, the
    outputs written once; the multiply-adds at the f32 rate), its plain
    version (``torch.einsum``, cuBLAS) and ``torch.bmm`` over the same
    operands laid out ahead of time in its (batch, rows, k) x (batch, k, n)
    form."""
    from repro_torch.kernels import ops

    B, L, H, D, T = N_SLOTS, cfg.n_layers, cfg.n_heads, cfg.head_dim, S_MAX
    pos = torch.tensor([n + MAX_NEW - 1 for n in PROMPT_LENS], device=dev)
    valid = torch.arange(T, device=dev)[None] <= pos[:, None]  # (B, T)
    layers = []
    for _ in range(L):
        q = torch.randn((B, 1, H, D), generator=g, device=dev)
        k, v = (torch.randn((B, T, H, D), generator=g, device=dev) for _ in range(2))
        s_ = torch.einsum("bqhd,bkhd->bhqk", q, k) / D**0.5
        p = torch.softmax(s_.masked_fill(~valid[:, None, None], -2.0e9), dim=-1)
        layers.append((q, k, p, v))

    def step(impl):
        return lambda: [(ops.rowinv_einsum("bqhd,bkhd->bhqk", q, k, impl=impl),
                         ops.rowinv_einsum("bhqk,bkhd->bqhd", p, v, impl=impl))
                        for q, k, p, v in layers]

    t, tw, how = device_ms(step("cuda"))
    tp, tpw, _ = device_ms(step("torch"))
    laid = [(q.permute(0, 2, 1, 3).reshape(B * H, 1, D).contiguous(),
             k.permute(0, 2, 3, 1).reshape(B * H, D, T).contiguous(),
             p.reshape(B * H, 1, T).contiguous(),
             v.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()) for q, k, p, v in layers]
    tl, tlw, _ = device_ms(lambda: [(torch.bmm(q, k), torch.bmm(p, v)) for q, k, p, v in laid])
    del laid, layers
    nbytes = L * 4 * (2 * B * H * D + 2 * B * T * H * D + 2 * B * H * T)
    nops = L * 2 * (2 * B * H * T * D)
    log(f"  rowinv_bmm, one unfused decode step ({2 * L} calls: q . k and p . v at B={B}, "
        f"H={H}, D={D}, {T} cache rows; L2-cold): {t:.4f} ms device ({how}), {tw:.3f} ms wall; "
        f"plain (torch.einsum) {tp:.4f} ms device, {tpw:.3f} ms wall; torch.bmm over the "
        f"operands laid out ahead of time {tl:.4f} ms device, {tlw:.3f} ms wall; bound "
        f"{max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS_PER_S) * 1e3:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} G f32 multiply-adds x 2)")
    return dict(name="rowinv_bmm", route="cuda", source="src/repro_torch/csrc/rowinv_bmm.cu",
                replaces="src/repro/models/attention.py:426 (no TPU kernel: the port's own, "
                         "for the reference's jnp.einsum at :426, :439 and :590-603)",
                ms=t, plain_ms=tp, bytes=nbytes, work=[(nops, F32_FLOPS_PER_S)], library_ms=tl)


def reference_layer_rows(torch, dev, g) -> list:
    """qntpack and conv2d per call, timed over CALLS back-to-back launches
    of the kernel's wrapper (one launch alone is below what the profiler
    resolves), beside their bound, their plain version and one PyTorch call
    for the same function: qntpack at y = 4 (the quickstart's width) at
    the Tab. 1 shape and at the 224 x 224 Reference Layer's accumulators
    (REF224_PHI), its requant vector on the host (the kernel takes it by
    value; ``ops.qntpack`` must copy nothing to the card, gated), beside
    ``torch.bucketize`` over its thresholds (the requant ladder alone, no
    pack); conv2d (its vector uploaded once, ahead of the window) in the
    quickstart's cell (8, 4, 4) at the paper's shape and at 224 x 224 with
    the paper's widths (C 32 -> 64), beside ``F.conv2d`` in f32 with TF32
    allowed, channels-last, over the codes unpacked ahead of time (its int32
    sums, not the requant and pack), with whether it equals ``im2col @ w``
    exactly. Returns the raw kernel rows (both qntpack shapes, told apart
    by their "at"; the paper shape's conv2d; the 224 x 224 one is
    printed)."""
    import torch.nn.functional as F

    from repro_torch.core import pack as P
    from repro_torch.core import quant as Q
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.kernels.mpmm import requant_vector
    from repro_torch.kernels.qntpack import qntpack_cuda
    from repro_torch.kernels.ref import conv2d_ref, im2col, qntpack_ref

    def per_call(fn):
        t, tw, how = device_ms(lambda: [fn() for _ in range(CALLS)])
        return t / CALLS, tw / CALLS, how

    rows = []
    rq = Q.make_requant_params(y_bits=4, eps_phi=2.0**-17, eps_y=1.0, lam=float(1 << 20))
    rqv = requant_vector(rq)
    thresholds = torch.from_numpy(rq.thresholds.astype("int32")).to(dev)
    for (M_, N_), at in ((TAB1, "Tab. 1"), (REF224_PHI, "224 x 224 Reference Layer")):
        phi = torch.randint(-(1 << 20), 1 << 20, (M_, N_), generator=g, device=dev,
                            dtype=torch.int32)
        t, tw, how = per_call(lambda: qntpack_cuda(phi, rqv, y_bits=4))
        tp, tpw, _ = per_call(lambda: qntpack_ref(phi, rq, y_bits=4))
        tl, _, _ = per_call(lambda: torch.bucketize(phi, thresholds, right=True))
        ladder = torch.equal(torch.bucketize(phi, thresholds, right=True).to(torch.uint8),
                             P.unpack(qntpack_cuda(phi, rqv, y_bits=4), 4, signed=False))
        nbytes = 4 * M_ * N_ + M_ * N_ // 2 + rqv.numel() * 4
        log(f"  qntpack y=4 at (M, N) = {(M_, N_)} ({at}): {t * 1e3:.3f} us device per call "
            f"({how}), {tw * 1e3:.2f} us wall, {nbytes / HBM_BYTES_PER_S * 1e6 / t / 1e3:.2f} of "
            f"the bytes' bound; plain {tp * 1e3:.2f} us device, {tpw * 1e3:.2f} us wall; "
            f"torch.bucketize over the thresholds (the requant ladder alone, no pack) "
            f"{tl * 1e3:.3f} us device, codes {'equal' if ladder else 'NOT equal'} to the "
            f"kernel's unpacked")
        rows.append(dict(name="qntpack", route="cuda", source="src/repro_torch/csrc/qntpack.cu",
                         replaces="src/repro/kernels/qntpack.py:28", ms=t, plain_ms=tp,
                         bytes=nbytes, work=[(15 * M_ * N_, F32_FLOPS_PER_S)], library_ms=tl,
                         at=f"{at} ({M_}, {N_}), y = 4"))
    htod = htod_copies(torch, dev, lambda: ops.qntpack(phi, rq, y_bits=4))
    log(f"  qntpack: {htod} Memcpy HtoD an ops.qntpack call")
    if htod:
        raise AssertionError(f"ops.qntpack copied {htod} times to the card")

    paper = ref_layer()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for H, W, C, Cout in (paper, (224, 224, *paper[2:])):
            x_p, w_p, rq = conv_operands(torch, g, dev, H, W, C, Cout, 8, 4, 4)
            rqv = requant_vector(rq).to(dev)
            bits = dict(x_bits=8, w_bits=4, y_bits=4)
            t, tw, how = per_call(lambda: conv2d_cuda(x_p, w_p, rqv, **bits))
            tp, tpw, _ = per_call(lambda: conv2d_ref(x_p, w_p, rq, **bits))
            # the library's conv over the codes: x (1, C, H, W) and w (Cout,
            # C, 3, 3) from the (dy, dx, c) order, both channels-last f32
            xf = P.unpack(x_p, 8, signed=False).float().permute(2, 0, 1)[None]
            xf = xf.contiguous(memory_format=torch.channels_last)
            wf = P.unpack(w_p, 4, signed=True).float().reshape(Cout, 3, 3, C).permute(0, 3, 1, 2)
            wf = wf.contiguous(memory_format=torch.channels_last)
            tl, _, _ = per_call(lambda: F.conv2d(xf, wf, padding=1))
            sums = F.conv2d(xf, wf, padding=1)[0].permute(1, 2, 0).reshape(H * W, Cout)
            exact = torch.equal(sums, (im2col(x_p, 8).double()
                                       @ P.unpack(w_p, 4, signed=True).double().T).float())
            nbytes = x_p.numel() + w_p.numel() + H * W * Cout // 2 + rqv.numel() * 4
            nops = 2 * H * W * Cout * 9 * C
            bound = max(nbytes / HBM_BYTES_PER_S, nops / INT8_OPS_PER_S) * 1e3
            log(f"  conv2d (8, 4, 4) at {H}x{W}, {C} -> {Cout}: {t * 1e3:.2f} us device per "
                f"call ({how}), {tw * 1e3:.2f} us wall; plain {tp * 1e3:.1f} us device, "
                f"{tpw * 1e3:.1f} us wall; F.conv2d (f32, TF32 allowed, channels-last, codes "
                f"unpacked ahead of time; int32 sums only) {tl * 1e3:.2f} us device, "
                f"{'exact' if exact else 'NOT exact'}; bound {bound * 1e3:.4f} us")
            if (H, W) == paper[:2]:
                rows.append(dict(name="conv2d", route="cuda",
                                 source="src/repro_torch/csrc/conv2d.cu",
                                 replaces="src/repro/kernels/conv2d.py:71", ms=t, plain_ms=tp,
                                 bytes=nbytes, work=[(nops, INT8_OPS_PER_S)], library_ms=tl))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return rows


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
        **({"at": r["at"]} if "at" in r else {}),
    }


#: device kernels the step breakdown names (everything else is PyTorch's)
KERNEL_NAMES = ("mpmm_kernel", "wdqmm_mma_kernel", "wdqmm_kernel", "paged_mla_split_kernel",
                "paged_attn_kernel", "paged_attn_merge_kernel", "flash_mha_kernel",
                "paged_scatter_kernel", "paged_gather_kernel", "qkv_split_kernel",
                "qkv_merge_kernel", "rowinv_bmm_kernel")


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


def paged_breakdown(torch, dev, cfg, policy, params):
    """Profile one full-width decode step on the paged cache, fused (the
    paged attention kernel) and unfused (every layer's leaves gathered
    first): wall time, device busy time and device time by kernel. Each slot
    holds S_MAX // PAGE_SIZE pages of its own, shuffled over the pool, at
    the positions of ``step_breakdown``."""
    from repro_torch.models import model as M

    nb = S_MAX // PAGE_SIZE
    caches = M.init_paged_cache(cfg, policy, N_SLOTS * nb + 1, PAGE_SIZE, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    bt = (torch.randperm(N_SLOTS * nb, generator=g, device=dev) + 1).reshape(N_SLOTS, nb)
    bt = bt.to(torch.int32).contiguous()
    toks = torch.ones((N_SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([n + MAX_NEW - 1 for n in PROMPT_LENS], dtype=torch.int32, device=dev)
    for fused in (True, False):
        step = lambda fused=fused: M.decode_step(  # noqa: E731
            params, toks, pos, caches, cfg, policy, block_tables=bt, fused_attn=fused)
        profile_breakdown(torch, step, f"decode step breakdown ({cfg.name}, {policy.name}, "
                          f"{cfg.n_layers} layers, paged cache, "
                          f"{'fused' if fused else 'unfused'}, 4 slots at 159..543 cached rows "
                          f"of {nb} pages each)")


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
                                  names=("wdqmm_mma_kernel",))
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
    prefix path (cut to CUT_LAYERS layers); the teacher-forced step, the step breakdown and wdqmm's
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
    ccfg, cwparams = cut(cfg, wparams)
    prefix_launches, _ = prefix_path(torch, dev, ccfg, policy, cwparams,
                                     key=f"weight-only ({CUT_LAYERS} layers) ")
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


def mpmm_prefill_row(torch, dev, cfg, params) -> dict:
    """mpmm per prefill_step of N_SLOTS x PREFILL_LEN tokens: the 169
    projections at M = 2048 (cell (8, 4, 8), signed 8-bit activations, f32
    out) over every layer's own packed weights, beside its bound (the int8
    operations at 1979 TOP/s against the bytes: weights, activations and the
    f32 outputs), its plain version and one ``torch._int_mm`` a projection
    (int8 x int8 -> int32) over the weights unpacked to int8 ahead of time."""
    from repro_torch.core import pack as P
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    M, lin = N_SLOTS * PREFILL_LEN, linears(params)

    def K_of(p):
        return p["w_packed"].shape[1] * 2

    xs = {K: torch.randint(-128, 128, (M, K), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8) for K in {K_of(p) for p in lin}}
    kw = dict(x_bits=8, w_bits=4, y_bits=8, x_signed=True, out_kind="f32")

    def step(impl):
        return lambda: [ops.mpmm(xs[K_of(p)], p["w_packed"], None, out_scale=p["eps_w"],
                                 impl=impl, **kw) for p in lin]

    t, tw, how = device_ms(step("cuda"), reps=3, names=("mpmm_kernel",))
    tp, tpw, _ = device_ms(step("torch"), reps=2, warmup=1)
    ints = [P.unpack(p["w_packed"], 4, signed=True).to(torch.int8).t() for p in lin]
    tl, tlw, _ = device_ms(lambda: [torch._int_mm(xs[w.shape[0]], w) for w in ints], reps=3)
    del ints
    nops = sum(2 * M * p["w_packed"].shape[0] * K_of(p) for p in lin)
    nbytes = sum(p["w_packed"].numel() + M * K_of(p) + 4 * M * p["w_packed"].shape[0] + 4
                 for p in lin)
    log(f"  mpmm, one prefill_step ({len(lin)} calls, M={M}, cell (8, 4, 8), f32 out): "
        f"{t:.3f} ms device ({how}), {tw:.3f} ms wall; plain {tp:.3f} ms device, {tpw:.3f} ms "
        f"wall; torch._int_mm over the weights unpacked to int8 ahead of time {tl:.3f} ms "
        f"device, {tlw:.3f} ms wall; {nops / 1e12:.3f} T int8 operations "
        f"({nops / INT8_OPS_PER_S * 1e3:.4f} ms), {nbytes / 1e9:.3f} GB "
        f"({nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); {nops / (t * 1e-3) / 1e12:.1f} TOP/s")
    return dict(name="mpmm", at=f"prefill_step, M = {M}", route="cuda",
                source="src/repro_torch/csrc/mpmm.cu", replaces="src/repro/kernels/mpmm.py:122",
                ms=t, plain_ms=tp, bytes=nbytes, work=[(nops, INT8_OPS_PER_S)], library_ms=tl)


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
    Returns (the raw kernel rows of flash_mha and of mpmm per prefill_step,
    their launches in prefill_step)."""
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
    step_launches = dict(build.LAUNCHES)  # prefill_step's own launches
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
    if step_launches.get("mpmm", 0) != len(linears(params)):
        raise AssertionError(f"prefill_step launched mpmm {step_launches.get('mpmm', 0)} times, "
                             f"want {len(linears(params))} (one a projection)")
    return ([flash_step_row(torch, dev, cfg), mpmm_prefill_row(torch, dev, cfg, params)],
            {"flash_mha": launches["flash_mha"], "mpmm": step_launches["mpmm"]})


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
        ts, _, _ = device_ms(calls(QD.qkv_decode_cuda), names=("qkv_split_kernel",))
        tm, _, _ = device_ms(calls(QD.qkv_decode_cuda), names=("qkv_merge_kernel",))
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
            f"{n} distinct caches a window, L2-cold): {t / n * 1e3:.2f} us device ({how}; "
            f"split pass {ts / n * 1e3:.2f}, merge {tm / n * 1e3:.2f}), "
            f"{tw / n * 1e3:.2f} us wall; plain {tp / n * 1e3:.1f} us device; "
            f"F.scaled_dot_product_attention (f32, K/V dequantized ahead of time, kv heads "
            f"repeated, boolean mask) {tl / n * 1e3:.2f} us device, max |SDPA - kernel| = "
            f"{worst:.3e}; bound {bound * 1e3:.3f} us ({nbytes / 1e6:.2f} MB)")
        out[bits] = dict(name="qkv_decode", route="cuda", source="src/repro_torch/csrc/qkv_decode.cu",
                         replaces="src/repro/kernels/qkv_decode.py:72", ms=t / n, plain_ms=tp / n,
                         bytes=nbytes, work=[(nops, F32_FLOPS_PER_S)], library_ms=tl / n)
    return out[8]


def sampled_path(torch, dev, cfg, policy, params) -> dict:
    """Phase 13: the serving path with seeded sampling (SAMPLING, request i
    with seed 1000 + i), internlm2 w4a8 kv8 at full width, its serving runs
    cut to CUT_LAYERS layers. Phase 3's four requests greedy on the slot
    cache (``greedy_out``), then sampled on the slot and the paged cache;
    phase 9's five on a cold paged and a prefix engine; the four again with
    request 0 greedy beside
    three sampled; the four at top-k 1. Gates: slot and paged streams
    identical, prefix identical to cold paged; in the mixed batch the
    sampled requests repeat their first run's streams (run to run, and
    whatever their neighbours) and the greedy one equals its stream in
    the all-greedy batch (``greedy_out``); top-k 1 equals the greedy
    streams, or first differs at a token whose two best logits tie
    (top-k 1 keeps ties, greedy takes the first; the tie is read from the
    logits the engine sampled); mpmm, paged_attn and paged_scatter launched.
    Printed: a full-depth sampled decode step's wall and device time beside
    a greedy step's from the same cache (walls: medians of STEP_PAIRS steps of each,
    taken in turns), and the sampler's device time."""
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serve import Request

    ccfg, cparams = cut(cfg, params)
    greedy_out, _ = serve(torch, dev, ccfg, policy, cparams, "slot")
    build.reset_launches()  # the sampled serving path starts here
    out_slot, _ = serve(torch, dev, ccfg, policy, cparams, "slot",
                        reqs=sampled_requests(requests(cfg, Request)))
    out_paged, _ = serve(torch, dev, ccfg, policy, cparams, "paged",
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
    prefix_path(torch, dev, ccfg, policy, cparams, key=f"sampled ({CUT_LAYERS} layers) ",
                sampled=True)

    mixed, _ = serve(torch, dev, ccfg, policy, cparams, "slot",
                     reqs=sampled_requests(requests(cfg, Request), greedy=(0,)))
    if mixed[0] != greedy_out[0]:
        raise AssertionError("a greedy request beside sampled ones left its greedy stream")
    if any(mixed[r] != out_slot[r] for r in (1, 2, 3)):
        raise AssertionError("sampled streams changed from run to run or with their neighbours")
    log("mixed batch (request 0 greedy, 1-3 sampled): the greedy stream equals the greedy "
        "run's, the sampled ones their first run's")
    ties: dict = {}
    top1, _ = serve(torch, dev, ccfg, policy, cparams, "paged", ties=ties,
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


# --------------------------------------------------------------- phase 14


def engines(dev, cfg, policy, params, cache, fused_attn=True):
    """``make(mixed)``: a serialized (False) or continuous (True: budget
    MIXED_BUDGET, INFLIGHT steps in flight) engine, 4 slots, s_max 1024."""
    from repro_torch.serve import ServeEngine

    def make(mixed):
        kw = dict(mixed=True, mixed_budget=MIXED_BUDGET, inflight=INFLIGHT) if mixed else {}
        return ServeEngine(params, cfg, policy, n_slots=N_SLOTS, s_max=S_MAX, cache=cache,
                           page_size=PAGE_SIZE if cache != "slot" else None,
                           fused_attn=fused_attn, device=dev, **kw)

    return make


def bf16_step(row) -> float:
    """The spacing of bf16 values at ``row``'s largest magnitude."""
    import math

    top = float(row.abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def first_parting(a, b):
    """The first index where token lists ``a`` and ``b`` differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def held_equal(what, want, got) -> None:
    """Gate: every stream of ``got`` equals the serialized stream of the
    same request in ``want`` (rid -> tokens), token for token: the
    reference's contract for continuous and speculative engines
    (tests/test_continuous.py). On the card the unfused read's products run
    through the row-invariant rowinv_bmm kernel, so a query row has the
    same bits in a decode step, a mixed step and a verify."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: requests {sorted(got)}, the serialized run {sorted(want)}")
    for rid, a_s in want.items():
        b_s = got[rid]
        if a_s != b_s:
            i = first_parting(a_s, b_s)
            raise AssertionError(
                f"{what}: request {rid} parts from the serialized stream at token "
                f"{min(len(a_s), len(b_s)) if i is None else i} ({len(a_s)} serialized tokens, "
                f"{len(b_s)} here)")


def continuous_serve(torch, dev, cfg, policy, params, cache, reqs, fused_attn=True):
    """Serve ``reqs`` on a continuous engine (``mixed=True``, MIXED_BUDGET
    prompt tokens a mixed step, INFLIGHT steps in flight). Counts the host syncs
    (``serve.boundary.counting_syncs``) of every admission, every dispatch
    (mixed or pure decode) and every retire, the CUDA event waits of the
    retires, and the in-flight depth after every dispatch and at every
    token. Returns (streams, metrics, info)."""
    from repro_torch.models import model as M
    from repro_torch.serve.boundary import counting_syncs

    eng = engines(dev, cfg, policy, params, cache, fused_attn)(True)
    info: dict = {"mixed": [], "decode": [], "admit": [], "retire": [], "waits": 0, "depth": [],
                  "peak": 0}
    dispatch, admit, retire = eng._dispatch, eng._admit, eng._retire_one

    def counted_dispatch():
        before, out = eng._mixed_steps, []
        with counting_syncs() as got:
            out.append(dispatch())
        if out[0]:
            info["mixed" if eng._mixed_steps > before else "decode"].append(got)
        info["peak"] = max(info["peak"], eng.metrics()["inflight"])
        return out[0]

    def counted(name, fn):
        def run():
            with counting_syncs() as got:
                fn()
            info[name].append(got)
        return run

    wait = torch.cuda.Event.synchronize

    def counting_wait(ev):
        info["waits"] += 1
        return wait(ev)

    eng._dispatch = counted_dispatch
    eng._admit, eng._retire_one = counted("admit", admit), counted("retire", retire)
    torch.cuda.Event.synchronize = counting_wait
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = eng.run(reqs, on_token=lambda rid, tok: info["depth"].append(
            eng.metrics()["inflight"]))
    finally:
        torch.cuda.Event.synchronize = wait
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m = eng.metrics()
    mode = "" if all(r.params is None or r.params.greedy for r in reqs) else ", sampled"
    log(f"continuous[{cfg.name}, {policy.name}, {cache}{'' if fused_attn else ', unfused'}{mode}]: "
        f"{m['tokens_generated']} tokens in {dt:.3f} s ({m['tokens_generated'] / dt:.2f} tokens/s "
        f"end to end), {m['decode_steps']} steps ({m['mixed_steps']} mixed), step EMA "
        f"{m['step_ema_s'] * 1e3:.2f} ms, TTFT p50 {m['slo/ttft_p50_s']:.3f} s, TPOT p50 "
        f"{m['slo/tpot_p50_s'] * 1e3:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; in flight at most "
        f"{info['peak']} after a dispatch, {max(info['depth'], default=0)} at a token; host syncs: "
        f"mixed dispatches {sum(map(len, info['mixed']))} over {len(info['mixed'])}, pure-decode "
        f"dispatches {sum(map(len, info['decode']))} over {len(info['decode'])}, admissions "
        f"{sum(map(len, info['admit']))} over {len(info['admit'])}, retires "
        f"{sum(map(len, info['retire']))} over {len(info['retire'])} (and {info['waits']} "
        f"event waits)")
    return out, m, info


def gate_continuous(what, reqs, out, m, info, launched, cfg, cache, fused_attn=True,
                    serial=None):
    """Phase 14's gates on one continuous run: with ``serial``, the streams
    of the serialized engine of the same cache and attention, every stream
    equals its serialized one (``held_equal``); mixed steps ran and
    the pipeline drained; the in-flight depth never passed INFLIGHT; no
    admission or dispatch made a host sync; every step launched mpmm, a
    paged run paged_scatter once a layer a step and paged_gather once a
    layer a mixed step (every step unfused), rowinv_bmm (the unfused read's
    products) ``rowinv_per_layer`` times a layer a mixed step (every step
    unfused), the fused attention kernel once a layer a pure-decode step
    (none unfused). A fused run (``serial``
    None) reads the cache unfused in its mixed steps and fused in its
    pure-decode steps, a mix no serialized run computes: its caller prints
    how its streams compare."""
    held = ""
    if serial is not None:
        held_equal(what, serial, out)
        held = "; every stream equal to its serialized one"
    if not (m["mixed_steps"] > 0 and m["inflight"] == 0):
        raise AssertionError(f"{what}: {m['mixed_steps']} mixed steps, {m['inflight']} in flight "
                             f"after drain()")
    if not info["depth"] or max(info["depth"] + [info["peak"]]) > INFLIGHT:
        raise AssertionError(f"{what}: in-flight depth {max(info['depth'], default=None)} at a "
                             f"token, {info['peak']} after a dispatch; want at most {INFLIGHT}")
    for kind in ("mixed", "decode", "admit"):
        bad = [got for got in info[kind] if got]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} of {len(info[kind])} {kind} calls made "
                                 f"host syncs, first: {bad[0]}")
    if not info["mixed"]:
        raise AssertionError(f"{what}: no mixed dispatch")
    L, steps, mixed = cfg.n_layers, m["decode_steps"], m["mixed_steps"]
    attn = "paged_mla_attn" if cfg.family == "mla_moe" else "paged_attn"
    want_n = {attn: L * (steps - mixed) if fused_attn else 0,
              "rowinv_bmm": rowinv_per_layer(cfg) * L * (mixed if fused_attn else steps)}
    if cache != "slot":
        want_n["paged_scatter"] = L * steps
        want_n["paged_gather"] = L * (mixed if fused_attn else steps)
    if cfg.family == "dense":
        want_n["mpmm"] = 7 * L * steps + steps  # seven projections a layer and the head
    if cache == "prefix":
        want_n["paged_copy"] = m["cache/cow_copies"]
    got_n = {k: launched.get(k, 0) for k in want_n}
    if got_n != want_n or launched.get("mpmm", 0) == 0:
        raise AssertionError(f"{what}: launches {got_n}, want {want_n} ({steps} steps, {mixed} "
                             f"mixed)")
    log(f"{what}: launches {got_n} ({steps} steps, {mixed} mixed){held}")


def rowinv_per_layer(cfg) -> int:
    """rowinv_bmm launches a layer of one unfused read: q . k and p . v
    (GQA), or the five absorbed products (MLA)."""
    return 5 if cfg.family == "mla_moe" else 2


def tokens_equal(want, got) -> str:
    same = sum(a == b for rid in want for a, b in zip(want[rid], got[rid]))
    return f"{same} of {sum(len(t) for t in want.values())} tokens"


def _moved(tree, dev):
    """``tree`` (dicts, lists and tuples of tensors) with every tensor on ``dev``."""
    if isinstance(tree, dict):
        return {k: _moved(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_moved(v, dev) for v in tree)
    return tree.to(dev) if hasattr(tree, "to") and hasattr(tree, "device") else tree


def mixed_witness(torch, dev, cfg, policy, params, cpu: bool) -> None:
    """Phase 14's witness that a query row has the same bits in a decode
    step and in a mixed step. From one serving state at full width (phase
    3's four requests served serialized on the paged cache, unfused, for 6
    steps: every slot decoding), one unfused decode step and one mixed step
    of the same four decode lanes (width MIXED_BUDGET, one real token each)
    run on copies of the cache. They compute the same function, and their
    logits must be bit-equal on the card (gated); with ``cpu``, on the CPU
    too (the plain versions, on copies of the weights and the cache; gated),
    and how far the card's part from the CPU's is printed, in bf16 steps at
    the row's largest |logit|. Then each of the unfused read's f32 products
    (GQA: q . k and p . v; MLA: the five absorbed einsums) for one query row
    alone (S = 1, a decode step) and among MIXED_BUDGET rows (a mixed step):
    through ``ops.rowinv_einsum`` on the card bit-equal (gated); printed
    beside it, what ``torch.einsum`` (cuBLAS, its kernel picked by the
    shape) gives, and an RMS norm of 4 rows and of 64."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.common import rms_norm
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    eng = ServeEngine(params, cfg, policy, n_slots=N_SLOTS, s_max=S_MAX, cache="paged",
                      page_size=PAGE_SIZE, fused_attn=False, device=dev)
    for r in requests(cfg, Request):
        eng.submit(r.prompt, SamplingParams(max_new=r.max_new), rid=r.rid)
    for _ in range(6):  # the four admissions (blocking prefills), then decode steps
        eng.step()
    if any(r is None or not r.out for r in eng.slot_req):
        raise AssertionError(f"witness {cfg.name}: not every slot decodes after 6 steps")
    toks = [r.out[-1] for r in eng.slot_req]
    pos, bt = eng.cache.pos.copy(), eng.cache.block_tables.copy()
    state = [{k: a.clone() for k, a in layer.items()} for layer in eng.cache.caches]
    eng.close()

    def both(d, prm):
        """The four decode lanes' logits (f32, on the host) of one unfused
        decode step and of one mixed step, on device ``d``."""
        t = torch.tensor(toks, dtype=torch.int32, device=d)
        p = torch.tensor(pos, dtype=torch.int32, device=d)
        b = torch.tensor(bt, dtype=torch.int32, device=d)

        def cache():
            return [{k: a.to(d, copy=True) for k, a in layer.items()} for layer in state]
        dec = M.decode_step(prm, t[:, None], p, cache(), cfg, policy, block_tables=b,
                            fused_attn=False)[:, -1]
        wide = torch.zeros(len(toks), MIXED_BUDGET, dtype=torch.int32, device=d)
        wide[:, 0] = t
        mix = M.mixed_step(prm, wide, p, torch.ones_like(p), cache(), cfg, policy,
                           block_tables=b, page_size=PAGE_SIZE)[:, 0]
        return dec.float().cpu(), mix.float().cpu()

    dec, mix = both(dev, params)
    step = bf16_step(dec)

    def apart(x, y):
        return "bit-equal" if torch.equal(x, y) else (
            f"{float((x - y).abs().max()) / step:.2f} bf16 steps apart")

    if not torch.equal(dec, mix):
        raise AssertionError(f"witness {cfg.name}: on the card one unfused decode step and one "
                             f"mixed step of the same lanes part: {apart(dec, mix)}")
    said = "card decode vs card mixed bit-equal (gated)"
    if cpu:
        cdec, cmix = both(torch.device("cpu"), _moved(params, torch.device("cpu")))
        if not torch.equal(cdec, cmix):
            raise AssertionError(f"witness {cfg.name}: on the CPU one decode step and one mixed "
                                 f"step of the same lanes part: {apart(cdec, cmix)}")
        said += (f"; CPU decode vs CPU mixed bit-equal (gated); card decode vs CPU "
                 f"{apart(dec, cdec)}, card mixed vs CPU {apart(mix, cmix)}")
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    B, W = N_SLOTS, MIXED_BUDGET

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def pair(name, spec, x, y, ax_in, ax_out):
        """The model's product ``spec`` of the first query row of ``x``
        alone and among its W rows (rows on axis ``ax_in`` in, ``ax_out``
        out): through the kernel (gated bit-equal) and through
        ``torch.einsum`` (printed)."""
        def first(f, rows):
            return f(spec, rows, y).narrow(ax_out, 0, 1)

        def kernel(sp, a, b):
            return ops.rowinv_einsum(sp, a, b, impl="cuda")

        one = x.narrow(ax_in, 0, 1).contiguous()
        if not torch.equal(first(kernel, one), first(kernel, x)):
            raise AssertionError(f"witness {cfg.name}: rowinv_bmm gives {name} ({spec}) other "
                                 f"bits for one query row alone than among {W}")
        a, b = first(torch.einsum, one), first(torch.einsum, x)
        shape.append(f"{name} bit-equal through rowinv_bmm (gated), through torch.einsum " + (
            "bit-equal" if torch.equal(a, b) else f"parts by {float((a - b).abs().max()):.3g}"))

    shape: list = []
    if cfg.family == "mla_moe":  # the absorbed einsums of mla_apply's unfused read
        H = cfg.n_heads
        qn, qr = rnd(B, W, H, cfg.d_nope), rnd(B, W, H, cfg.d_rope)
        w_uk, w_uv = rnd(H, cfg.d_nope, cfg.kv_lora), rnd(H, cfg.d_v, cfg.kv_lora)
        c, r = rnd(B, S_MAX, cfg.kv_lora), rnd(B, S_MAX, cfg.d_rope)
        lat = torch.einsum("bshd,hdc->bshc", qn, w_uk)
        p = torch.softmax(torch.einsum("bshc,btc->bhst", lat, c) / 16, -1)
        ctx = torch.einsum("bhst,btc->bshc", p, c)
        pair("q_nope . w_uk", "bshd,hdc->bshc", qn, w_uk, 1, 1)
        pair("q_lat . c", "bshc,btc->bhst", lat, c, 1, 2)
        pair("q_rope . r", "bshd,btd->bhst", qr, r, 1, 2)
        pair("p . c", "bhst,btc->bshc", p, c, 2, 1)
        pair("ctx . w_uv", "bshc,hdc->bshd", ctx, w_uv, 1, 1)
    else:  # attn_apply's unfused read
        q, k, v = (rnd(B, n, cfg.n_heads, cfg.head_dim) for n in (W, S_MAX, S_MAX))
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 16, -1)
        pair("q . k", "bqhd,bkhd->bhqk", q, k, 1, 2)
        pair("p . v", "bhqk,bkhd->bqhd", p, v, 2, 1)
    x = (rnd(64, cfg.d_model) * 3).to(torch.bfloat16)
    scale = {"scale": rnd(cfg.d_model)}
    same = torch.equal(rms_norm(scale, x[:4]), rms_norm(scale, x)[:4])
    shape.append(f"RMS norm {'bit-equal' if same else 'parts'}")
    log(f"witness ({cfg.name}, {policy.name}, paged, 4 decode lanes at {[int(p) for p in pos]} "
        f"cached rows; "
        f"{gpu_line()}): {said}. One query row alone (S = 1) against among {W} (f32, "
        f"unit-normal operands at the step's shapes): " + ", ".join(shape))


def window_idle(torch, eng, reqs, skip: int, steps: int) -> tuple[float, float, int]:
    """Submit ``reqs``, take ``skip`` steps, then ``steps`` more under the
    profiler: (device busy ms, wall ms, device kernels) of that window; the
    engine is closed after it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import SamplingParams

    for r in reqs:
        eng.submit(r.prompt, r.params or SamplingParams(max_new=r.max_new), rid=r.rid)
    for _ in range(skip):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    eng.close()
    seen = [e for e in prof.key_averages() if (getattr(e, "self_device_time_total", 0) or 0) > 0]
    return (sum(e.self_device_time_total for e in seen) / 1e3, wall, sum(e.count for e in seen))


def mpmm_step_row(torch, dev, lin, M, what, at, seed) -> dict:
    """mpmm over the projections ``lin`` (every layer's own weights, cell
    (8, 4, 8), f32 out) at M rows each: device ms beside its bound, its
    plain version and one ``torch._int_mm`` a projection over the weights
    unpacked to int8 ahead of time (M > 16: allowed)."""
    from repro_torch.core import pack as P
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(seed)

    def K_of(p):
        return p["w_packed"].shape[1] * 2

    xs = {K: torch.randint(-128, 128, (M, K), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8) for K in {K_of(p) for p in lin}}
    kw = dict(x_bits=8, w_bits=4, y_bits=8, x_signed=True, out_kind="f32")

    def step(impl):
        return lambda: [ops.mpmm(xs[K_of(p)], p["w_packed"], None, out_scale=p["eps_w"],
                                 impl=impl, **kw) for p in lin]

    t, tw, how = device_ms(step("cuda"), names=("mpmm_kernel",))
    tp, tpw, _ = device_ms(step("torch"), reps=3, warmup=1)
    ints = [P.unpack(p["w_packed"], 4, signed=True).to(torch.int8).t() for p in lin]
    tl, tlw, _ = device_ms(lambda: [torch._int_mm(xs[w.shape[0]], w) for w in ints])
    del ints
    nops = sum(2 * M * p["w_packed"].shape[0] * K_of(p) for p in lin)
    nbytes = sum(p["w_packed"].numel() + M * K_of(p) + 4 * M * p["w_packed"].shape[0] + 4
                 for p in lin)
    log(f"  mpmm, {what} ({len(lin)} calls, M={M}, cell (8, 4, 8), f32 out): {t:.4f} ms "
        f"device ({how}), {tw:.3f} ms wall; plain {tp:.3f} ms device, {tpw:.3f} ms wall; "
        f"torch._int_mm over the weights unpacked to int8 ahead of time {tl:.4f} ms device, "
        f"{tlw:.3f} ms wall; bound {max(nbytes / HBM_BYTES_PER_S, nops / INT8_OPS_PER_S) * 1e3:.4f}"
        f" ms ({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} G int8 operations)")
    return dict(name="mpmm", at=at, route="cuda", source="src/repro_torch/csrc/mpmm.cu",
                replaces="src/repro/kernels/mpmm.py:122", ms=t, plain_ms=tp, bytes=nbytes,
                work=[(nops, INT8_OPS_PER_S)], library_ms=tl)


def mpmm_mixed_row(torch, dev, cfg, params) -> dict:
    """mpmm per continuous mixed step: the 168 projections at M = N_SLOTS x
    MIXED_BUDGET = 64 (the head's call runs at M = N_SLOTS, row 1's
    shape)."""
    M, lin = N_SLOTS * MIXED_BUDGET, linears(params)[:-1]
    return mpmm_step_row(torch, dev, lin, M, "one mixed step",
                         f"mixed step, M = {M} ({len(lin)} projections)", SEED + 15)


def continuous_path(torch, dev, cfg, policy, params, serial: dict) -> tuple[dict, dict]:
    """Phase 14 (internlm2 w4a8 kv8, full width and depth, the weights of
    phase 3). The continuous engine reads the cache unfused in every mixed
    step, so each of its streams must equal (``gate_continuous`` with
    ``held_equal``) a serialized run that reads it unfused too: phase 3's
    four greedy requests on slot and paged against phase 5's runs
    (``serial``: cache -> (streams, metrics)), phase 9's five on prefix and
    phase 13's sampled four on paged (both cut to CUT_LAYERS layers)
    against serialized runs made here. One more continuous run, fused (its pure-decode steps
    through paged_attn), on phase 3's requests on paged: its launches and
    syncs are gated, its streams printed against phase 3's fused ones
    (``serial["paged fused"]``: (streams, metrics)). A window around one
    ``.item()`` must count one sync, or the counts are unreadable and the
    phase fails. Printed: ``mixed_witness``; each engine's step EMA, TPOT /
    TTFT p50 and tokens/s; the device-idle share of 8 profiled steps of
    each engine on the paged cache, fused (the serialized engine's decode
    steps after its prefills; the continuous engine's mixed steps and its
    last pure-decode steps). Returns the launches of the three full-depth
    greedy runs, mpmm's per-mixed-step row and the sampled serialized run's
    streams (CUT_LAYERS layers), which phase 16 holds its sampled
    speculative run to."""
    from collections import Counter

    from repro_torch.kernels import build
    from repro_torch.serve import Request
    from repro_torch.serve.boundary import counting_syncs

    t_phase = time.perf_counter()
    x = torch.ones(4, device=dev)
    with counting_syncs() as ctl:
        x.sum().item()
    if len(ctl) != 1:
        raise AssertionError(f"host syncs cannot be counted here: a window around one .item() "
                             f"counted {len(ctl)}")
    log(f"host-sync control: a window around one .item() counts {len(ctl)}")
    mixed_witness(torch, dev, cfg, policy, params, cpu=False)
    ccfg, cparams = cut(cfg, params)
    ser = dict(serial)
    out_p, m_p = serve(torch, dev, ccfg, policy, cparams, "prefix", fused_attn=False,
                       reqs=prefix_requests(cfg, Request))
    ser["prefix"] = (out_p, m_p)
    launches: Counter = Counter()
    cont: dict = {}
    for cache, reqs in (("slot", requests), ("paged", requests), ("prefix", prefix_requests)):
        c_, p_ = (ccfg, cparams) if cache == "prefix" else (cfg, params)
        build.reset_launches()  # this continuous run starts here
        out, m, info = continuous_serve(torch, dev, c_, policy, p_, cache, reqs(cfg, Request),
                                        fused_attn=False)
        launched = dict(build.LAUNCHES)  # this continuous run ends here
        if cache != "prefix":  # the kernels line's rows are full-depth mixed steps
            launches.update(launched)
        gate_continuous(f"continuous {cache}, unfused" + (
                            f" ({CUT_LAYERS} layers)" if cache == "prefix" else ""),
                        reqs(cfg, Request), out, m, info, launched, c_, cache, fused_attn=False,
                        serial=ser[cache][0])
        cont[cache] = m
        del info
    del ser

    build.reset_launches()  # the fused continuous run starts here
    out, m, info = continuous_serve(torch, dev, cfg, policy, params, "paged",
                                    requests(cfg, Request))
    launched = dict(build.LAUNCHES)  # the fused continuous run ends here
    launches.update(launched)
    want_f, m_f = serial["paged fused"]
    log(f"continuous paged, fused: {tokens_equal(want_f, out)} equal phase 3's fused serialized "
        f"streams (not held: its mixed steps read the cache unfused, its pure-decode steps "
        f"fused, a mix no serialized run computes)")
    gate_continuous("continuous paged, fused", requests(cfg, Request), out, m, info, launched,
                    cfg, "paged")
    cont["paged fused"] = m
    one = lambda kind: f"{len(info[kind][-1])}" if info[kind] else "none"  # noqa: E731
    log(f"host syncs at full width (paged, fused): one mixed dispatch {one('mixed')}, one "
        f"pure-decode dispatch {one('decode')}, one retire {one('retire')} and "
        f"{info['waits'] / max(len(info['retire']), 1):.0f} event wait")
    del info

    sreqs = lambda: sampled_requests(requests(cfg, Request))  # noqa: E731
    ser_s, _ = serve(torch, dev, ccfg, policy, cparams, "paged", fused_attn=False, reqs=sreqs())
    build.reset_launches()
    out, ms, info_s = continuous_serve(torch, dev, ccfg, policy, cparams, "paged", sreqs(),
                                       fused_attn=False)
    gate_continuous(f"continuous paged, unfused, sampled ({CUT_LAYERS} layers)", sreqs(), out,
                    ms, info_s, dict(build.LAUNCHES), ccfg, "paged", fused_attn=False,
                    serial=ser_s)
    del info_s

    card = gpu_line()
    for key, label, src in (("slot", "slot, unfused", "phase 5"),
                            ("paged", "paged, unfused", "phase 5"),
                            ("prefix", "prefix, unfused", "this phase"),
                            ("paged fused", "paged, fused", "phase 3")):
        ms_ = m_p if key == "prefix" else (m_f if key == "paged fused" else serial[key][1])
        mc = cont[key]
        log(f"serialized vs continuous ({cfg.name}, {policy.name}, {label}, "
            f"{'phase 9' if key == 'prefix' else 'phase 3'}'s requests, the serialized run "
            f"{src}'s; {card}): step EMA {ms_['step_ema_s'] * 1e3:.2f} vs "
            f"{mc['step_ema_s'] * 1e3:.2f} ms, TPOT p50 {ms_['slo/tpot_p50_s'] * 1e3:.2f} vs "
            f"{mc['slo/tpot_p50_s'] * 1e3:.2f} ms, TTFT p50 {ms_['slo/ttft_p50_s']:.3f} vs "
            f"{mc['slo/ttft_p50_s']:.3f} s, tokens/s {ms_['tokens_per_s']:.2f} vs "
            f"{mc['tokens_per_s']:.2f}, steps {ms_['decode_steps']} "
            f"(+{ms_['prefill_jit_calls']} prefill calls) vs {mc['decode_steps']} "
            f"({mc['mixed_steps']} mixed)")
    make = engines(dev, cfg, policy, params, "paged")
    n_mixed = cont["paged fused"]["mixed_steps"]
    for label, mixed, skip in (("serialized, decode steps 2-9", False, 1),
                               ("continuous, mixed steps 11-18", True, 10),
                               ("continuous, the last 8 pure-decode steps", True,
                                cont["paged fused"]["decode_steps"] - 8)):
        busy, wall, n = window_idle(torch, make(mixed), requests(cfg, Request), skip, 8)
        log(f"device-idle share ({cfg.name}, {policy.name}, paged, fused, {label}; {card}): wall "
            f"{wall:.2f} ms, device busy {busy:.3f} ms ({100 * (1 - busy / wall):.1f}% idle), "
            f"{n} device kernels; {wall / 8:.2f} ms a step")
    log(f"  (the continuous paged run has {n_mixed} mixed steps of "
        f"{cont['paged fused']['decode_steps']})")
    row = mpmm_mixed_row(torch, dev, cfg, params)
    log(f"phase 14 (continuous batching): {time.perf_counter() - t_phase:.1f} s")
    return dict(launches), row, ser_s


def continuous_mla(torch, dev, cfg, policy, params, unfused, fused) -> None:
    """Phase 14's DeepSeek-V3 runs (three MLA-dense layers, full width):
    ``mixed_witness`` with the CPU's plain versions; phase 3's four greedy
    requests on a continuous paged engine, unfused, equal to phase 8's
    unfused paged streams (``unfused``), then fused (its pure-decode steps through
    paged_mla_attn), its launches gated and its streams printed against
    phase 8's fused ones (``fused``)."""
    from repro_torch.kernels import build
    from repro_torch.serve import Request

    mixed_witness(torch, dev, cfg, policy, params, cpu=True)
    build.reset_launches()  # the continuous MLA run starts here
    out, m, info = continuous_serve(torch, dev, cfg, policy, params, "paged",
                                    requests(cfg, Request), fused_attn=False)
    gate_continuous("continuous MLA paged, unfused", requests(cfg, Request), out, m, info,
                    dict(build.LAUNCHES), cfg, "paged", fused_attn=False, serial=unfused)
    build.reset_launches()  # the fused continuous MLA run starts here
    out, m, info = continuous_serve(torch, dev, cfg, policy, params, "paged",
                                    requests(cfg, Request))
    log(f"continuous MLA paged, fused: {tokens_equal(fused, out)} equal phase 8's fused "
        f"serialized streams (not held: a mix of unfused mixed and fused pure-decode steps)")
    gate_continuous("continuous MLA paged, fused", requests(cfg, Request), out, m, info,
                    dict(build.LAUNCHES), cfg, "paged")


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
    out_paged, m_paged = serve(torch, dev, cfg, policy, params, "paged")
    fused_launches = dict(build.LAUNCHES)  # the fused MLA serving path ends here
    log(f"launches on the fused MLA path: {fused_launches}")
    if out_slot != out_paged:
        raise AssertionError("MLA: slot and paged token streams differ")
    for name in ("mpmm", "paged_mla_attn", "paged_scatter"):
        if fused_launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the fused MLA path")
    once_a_layer("paged_scatter", fused_launches["paged_scatter"], m_paged, cfg,
                 "the fused MLA paged path (the slot run launches none)")
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
    unf_paged, m_unf = serve(torch, dev, cfg, policy, params, "paged", fused_attn=False)
    unf_launches = dict(build.LAUNCHES)  # the unfused MLA serving path ends here
    log(f"launches on the unfused MLA path: {unf_launches}")
    if unf_slot != unf_paged:
        raise AssertionError("MLA: unfused slot and unfused paged token streams differ")
    if unf_launches.get("paged_gather", 0) == 0 or unf_launches.get("paged_mla_attn", 0):
        raise AssertionError(f"MLA unfused path: paged_gather must run, paged_mla_attn not: "
                             f"{unf_launches}")
    for name in ("paged_scatter", "paged_gather"):
        once_a_layer(name, unf_launches[name], m_unf, cfg, "the unfused MLA paged path")
    same = sum(a == b for rid in out_paged for a, b in zip(out_paged[rid], unf_paged[rid]))
    log(f"MLA: slot and paged streams identical, fused and unfused; {same} of "
        f"{sum(len(t) for t in out_paged.values())} tokens of the unfused streams equal the "
        f"fused ones (not gated: the two softmax sum in another order)")

    prefix_path(torch, dev, cfg, policy, params, key="MLA ")
    continuous_mla(torch, dev, cfg, policy, params, unf_paged, out_paged)  # phase 14's
    spec_mla(torch, dev, cfg, policy, params, unf_paged)  # phase 16's
    t0 = time.perf_counter()  # phase 15's round trip of the MLA layers and the MTP params
    round_trip(torch, dev, cfg, policy, params, "serve",
               f"{cfg.name} cut to {cfg.n_layers} layers with MTP, w4a8, serve", gpu_line())
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 15 (DeepSeek-V3): {time.perf_counter() - t0:.1f} s")

    teacher_forced(torch, dev, cfg, policy, params, report, key="teacher_forced_mla")
    step_breakdown(torch, dev, cfg, policy, params)
    paged_breakdown(torch, dev, cfg, policy, params)

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
    t_split = per_step(step("cuda"), names=("paged_mla_split_kernel",))[0]
    t_merge = per_step(step("cuda"), names=("paged_attn_merge_kernel",))[0]
    tp, tpw, _ = per_step(step("torch"), reps=3, warmup=1)
    pos = cases[0][5]
    valid = sum(int(p) + 1 for p in pos.tolist())
    row_bytes = C + 4 + 2 * dr  # int8 latent row, its f32 scale, the bf16 rope row
    nbytes = L * (valid * row_bytes + B * H * (C + dr) * 4 + B * H * C * 4
                  + cases[0][6].numel() * 4 + B * 4)
    # multiply-adds of the scores and the context; the kernel takes each as
    # three bf16 tensor-core products (the f32 operand split exactly)
    nops = L * H * valid * (2 * (C + dr) + 2 * C)
    log(f"  paged_mla_attn kv8, one decode step ({L} calls, B={B}, H={H}, {valid} cached rows "
        f"per layer; L2-cold): {t:.4f} ms device ({how}): split pass {t_split:.4f} ms, merge "
        f"{t_merge:.4f} ms; {tw:.3f} ms wall; plain {tp:.3f} ms device, {tpw:.3f} ms wall; "
        f"bound {max(nbytes / HBM_BYTES_PER_S, 3 * nops / BF16_FLOPS_PER_S) * 1e3:.5f} ms (the "
        f"products as three bf16 ones; {nops / F32_FLOPS_PER_S * 1e3:.5f} ms priced as f32 work "
        f"on the CUDA cores, the first design's)")
    warm = [cases[0]] * L  # the same pool three times: L2-warm
    tww, _, _ = device_ms(step("cuda", warm))
    log(f"  paged_mla_attn kv8, the same step L2-warm (one pool, {L} calls): {tww:.4f} ms device")

    # the library yardstick: SDPA in f32 over the dense slot view, the latent
    # dequantized ahead of time with the kernel's rounding, q = [q_lat |
    # q_rope], k = [c | r] (one key row shared by all heads), v = c, the same
    # scale, a boolean mask from pos; at kv8 (the row's) and on the bf16 cell
    from repro_torch.kernels.paged_attn import _dequant

    bcases = [mla_case(torch, dev, cfg, None, g) for _ in range(L * COLD_STEPS)]
    tb = per_step(step("cuda", bcases, None))[0]
    lib_ms = {}
    for bits, cs_ in ((8, cases), (None, bcases)):
        sdpa_in, worst = [], 0.0
        for ql, qr, c, s_, r, p, bt in cs_:
            pages = bt.long().flatten()
            cd = _dequant(c[pages], None if bits is None else s_[pages], bits)
            cd = cd.reshape(B, S_MAX, C)
            rd = r[pages].float().reshape(B, S_MAX, dr)
            q = torch.cat([ql, qr], dim=-1)[:, :, None]  # (B, H, 1, C + dr)
            k = torch.cat([cd, rd], dim=-1)[:, None].expand(B, H, S_MAX, C + dr)
            v = cd[:, None].expand(B, H, S_MAX, C)
            mask = (torch.arange(S_MAX, device=dev)[None] <= p[:, None].long())[:, None, None]
            sdpa_in.append((q, k, v, mask))
        sdpa = lambda: [F.scaled_dot_product_attention(q, k, v, attn_mask=m,  # noqa: E731
                                                       scale=scale) for q, k, v, m in sdpa_in]
        for lib, kern in zip(sdpa(), step("cuda", cs_, bits)()):
            worst = max(worst, float((lib[:, :, 0] - kern).abs().max()))
        tl, tlw, _ = per_step(sdpa)
        lib_ms[bits] = tl
        tag = "kv8" if bits else "bf16 cell"
        log(f"  paged_mla_attn {tag}: F.scaled_dot_product_attention (f32 over the latent "
            f"dequantized ahead of time, dense view, boolean mask), one decode step (L2-cold): "
            f"{tl:.4f} ms device, {tlw:.3f} ms wall; max |SDPA - kernel| = {worst:.3e}")
        del sdpa_in
    log(f"  paged_mla_attn bf16 cell, one decode step (L2-cold): {tb:.4f} ms device")
    del params, cases, bcases
    row = dict(name="paged_mla_attn", route="cuda",
               source="src/repro_torch/csrc/paged_mla_attn.cu",
               replaces="src/repro/kernels/paged_attn.py:299", ms=t, plain_ms=tp,
               bytes=nbytes, work=[(3 * nops, BF16_FLOPS_PER_S)], library_ms=lib_ms[8])
    return row, {"paged_mla_attn": fused_launches["paged_mla_attn"]}


# --------------------------------------------------------------- phase 16


def spec_serve(torch, dev, cfg, policy, params, cache, reqs, spec="self4"):
    """Serve ``reqs`` on a speculative engine (``spec``, SPEC_K drafts a
    round; 4 slots, s_max 1024, pages of 16). Records each
    round's host syncs (``serve.boundary.counting_syncs``), its launches by
    kernel and whether it drafted, and on a paged cache checks the pool
    after every step. Returns (streams, metrics, info)."""
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.boundary import counting_syncs

    eng = ServeEngine(params, cfg, policy, n_slots=N_SLOTS, s_max=S_MAX, cache=cache,
                      page_size=PAGE_SIZE if cache != "slot" else None, spec=spec,
                      spec_k=SPEC_K, device=dev)
    W = SPEC_K + 1
    info: dict = {"rounds": [], "steps": 0}
    spec_round, step = eng._spec_round, eng.step

    def counted_round():
        drafted = any(r is not None and eng.slot_remaining[s_] >= W
                      for s_, r in enumerate(eng.slot_req))
        before = dict(build.LAUNCHES)
        with counting_syncs() as got:
            spec_round()
        info["rounds"].append((got, {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()},
                               drafted))

    def checked_step():
        more = step()
        if eng.cache.paged:
            eng.cache.check_conserved()
        info["steps"] += 1
        return more

    eng._spec_round, eng.step = counted_round, checked_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m = eng.metrics()
    mode = "" if all(r.params is None or r.params.greedy for r in reqs) else ", sampled"
    log(f"spec[{cfg.name}, {policy.name}, {cache}, {m['spec/policy']}, k={SPEC_K}{mode}]: "
        f"{m['tokens_generated']} tokens in {dt:.3f} s ({m['tokens_generated'] / dt:.2f} "
        f"tokens/s end to end), {m['spec/rounds']} rounds, acceptance "
        f"{m['spec/acceptance_rate']:.4f} ({m['spec/accepted']} of {m['spec/proposed']}), mean "
        f"accepted length {spec_mean_len(m):.3f}, {m['cache/truncates']} truncates, step EMA "
        f"{m['step_ema_s'] * 1e3:.2f} ms, TTFT p50 {m['slo/ttft_p50_s']:.3f} s, TPOT p50 "
        f"{m['slo/tpot_p50_s'] * 1e3:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want_len = {r.rid: r.max_new for r in reqs}
    for rid, t in out.items():
        if len(t) != want_len[rid] or not all(0 <= x < cfg.vocab_padded for x in t):
            raise AssertionError(f"spec request {rid}: bad output {t}")
    return out, m, info


def spec_mean_len(m) -> float:
    """Tokens a speculating lane emits a round: each such round observes its
    accepted drafts plus the target's own token."""
    n = m["spec/accepted_len_count"]
    return (m["spec/accepted"] + n) / n if n else 0.0


def gate_spec(what, cfg, cache, m, info, draft_cfg=None) -> None:
    """Phase 16's gates on one speculative run: rounds ran, each made at
    most one host sync, and each launched, for each of its draft steps
    (SPEC_K when a lane speculated) and for its verify: mpmm seven times a
    layer and once for the head (a draft model of its own: its own layers),
    paged_scatter and paged_gather once a layer on a paged cache (a draft
    model's dense cache: none), rowinv_bmm ``rowinv_per_layer`` times a
    layer (the verify's k + 1 rows in one call a product), paged_attn and
    paged_mla_attn never (the drafts and the verify read the cache
    unfused)."""
    rounds = info["rounds"]
    if not rounds or len(rounds) != m["spec/rounds"]:
        raise AssertionError(f"{what}: {len(rounds)} rounds counted, {m['spec/rounds']} in the "
                             f"metrics")
    syncs = [len(got) for got, _, _ in rounds]
    if max(syncs) > 1:
        bad = next(got for got, _, _ in rounds if len(got) > 1)
        raise AssertionError(f"{what}: a round made {len(bad)} host syncs: {bad}")
    L = cfg.n_layers
    Ld = L if draft_cfg is None else draft_cfg.n_layers
    movers = L if cache != "slot" else 0
    draft_movers = movers if draft_cfg is None else 0
    rowinv, draft_rowinv = (rowinv_per_layer(cfg) * L,
                            rowinv_per_layer(draft_cfg or cfg) * Ld)
    for i, (_, got, drafted) in enumerate(rounds):
        k = SPEC_K if drafted else 0
        want = {"mpmm": 7 * L + 1 + k * (7 * Ld + 1), "paged_attn": 0, "paged_mla_attn": 0,
                "paged_scatter": movers + k * draft_movers,
                "paged_gather": movers + k * draft_movers,
                "rowinv_bmm": rowinv + k * draft_rowinv}
        have = {n: got.get(n, 0) for n in want}
        if have != want:
            raise AssertionError(f"{what}: round {i} ({'drafted' if drafted else 'no drafts'}) "
                                 f"launched {have}, want {want}")
    drafted = sum(d for _, _, d in rounds)
    log(f"{what}: {len(rounds)} rounds ({drafted} with {SPEC_K} draft steps), host syncs a round "
        f"{min(syncs)}-{max(syncs)} ({sum(syncs)} in all); launches a draft step: mpmm "
        f"{7 * Ld + 1}, paged_scatter / paged_gather {draft_movers}, rowinv_bmm {draft_rowinv}; "
        f"a verify: mpmm {7 * L + 1}, paged_scatter / paged_gather {movers}, rowinv_bmm "
        f"{rowinv}; paged_attn and paged_mla_attn none")


def spec_line(what, m, beside, card) -> None:
    """A speculative run's walls beside serialized runs' (label -> metrics)."""
    parts = [f"spec {m['step_ema_s'] * 1e3:.2f} ms a round, TPOT p50 "
             f"{m['slo/tpot_p50_s'] * 1e3:.2f} ms, TTFT p50 {m['slo/ttft_p50_s']:.3f} s, "
             f"{m['tokens_per_s']:.2f} tokens/s, {m['decode_steps']} rounds"]
    parts += [f"{label} {ms['step_ema_s'] * 1e3:.2f} ms a step, TPOT p50 "
              f"{ms['slo/tpot_p50_s'] * 1e3:.2f} ms, TTFT p50 {ms['slo/ttft_p50_s']:.3f} s, "
              f"{ms['tokens_per_s']:.2f} tokens/s, {ms['decode_steps']} steps"
              for label, ms in beside.items()]
    log(f"{what} ({card}): " + "; ".join(parts))


def spec_round_ms(torch, dev, cfg, policy, params) -> None:
    """The device time of one round's SPEC_K draft steps and of its verify
    (self4, paged, full depth), from phase 3's four requests admitted (in
    chunks of 128: the state, not the prefill, is what is timed) and one
    round served: each timed alone over that state (its rows rewritten in
    place)."""
    import numpy as np

    from repro_torch import host_copy
    from repro_torch.models import model as M
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    t0 = time.perf_counter()
    eng = ServeEngine(params, cfg, policy, n_slots=N_SLOTS, s_max=S_MAX, cache="paged",
                      page_size=PAGE_SIZE, prefill_chunk=128, spec="self4", spec_k=SPEC_K,
                      device=dev)
    for r in requests(cfg, Request):
        eng.submit(r.prompt, SamplingParams(max_new=r.max_new), rid=r.rid)
    eng.step()
    W = SPEC_K + 1
    for s_ in range(N_SLOTS):
        eng.cache.prepare(s_, W)
    tok0 = host_copy(np.array([[r.out[-1]] for r in eng.slot_req], np.int32), dev)
    pos = eng.cache.pos.copy()
    window = torch.cat([tok0, eng._draft(tok0, pos)], dim=1)
    lanes = (eng._temps, eng._top_ks, eng._top_ps, eng._seeds, eng._counters)
    bt, pos_d = host_copy(eng.cache.block_tables, dev), host_copy(pos, dev)
    n_real = host_copy(np.full(N_SLOTS, W, np.int32), dev)
    # medians of 2 and 3 (the draft, 4 full-depth steps, ~0.7 s a call, was
    # warmed by the window's own draft)
    td, tdw, how_d = device_ms(lambda: eng._draft(tok0, pos), reps=2, warmup=0)
    tv, tvw, how_v = device_ms(lambda: M.spec_verify_step(
        params, window, pos_d, n_real, *lanes, eng.cache.caches, cfg, policy, block_tables=bt,
        page_size=PAGE_SIZE), reps=3, warmup=1)
    eng.close()
    log(f"  one round (self4, paged, {cfg.n_layers} layers, 4 lanes at {pos.min()}..{pos.max()} "
        f"cached rows; {gpu_line()}): {SPEC_K} draft steps {td:.4f} ms device ({how_d}), "
        f"{tdw:.3f} ms wall; the verify of {W} positions {tv:.4f} ms device ({how_v}), "
        f"{tvw:.3f} ms wall; {time.perf_counter() - t0:.1f} s")


def spec_path(torch, dev, cfg, policy, params, serial, sampled_serial):
    """Phase 16 (right after phase 14, on phase 3's internlm2 w4a8 kv8
    weights): speculative decoding, ``ServeEngine(..., spec=..., spec_k=
    SPEC_K)``. Every draft step and every verify reads the cache unfused,
    so each run's streams must equal (``held_equal``) a serialized run that
    reads it unfused: (a) self4 at full depth on slot and paged, phase 3's four
    greedy requests, against phase 5's runs; (b) ``mixed_paper`` (its
    8-bit ``attn_out`` and head requantized to 4 bits: real rejections) at
    CUT_LAYERS, self4 on paged (phase 3's four) and on prefix (phase 9's
    five), against serialized runs made here, with truncates > 0 and the
    page pool conserved after every step; (c) phase 13's sampled four at
    CUT_LAYERS, self4 on paged, equal to phase 14's sampled serialized run
    (``sampled_serial``: its streams); (d) ``DraftModel()`` (its reduced
    draft at the full vocab) on paged at CUT_LAYERS, phase 3's two shortest
    requests, their prompts cut to DRAFT_PROMPTS tokens (the draft enters
    each prompt token by token). ``gate_spec`` on every
    run. Printed: acceptance, mean accepted length, truncates, walls beside
    the serialized fused and unfused runs, one round's device ms. Returns
    the launches of (a) and mpmm's per-verify row."""
    from collections import Counter

    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serve import DraftModel, Request
    from repro_torch.serve.boundary import counting_syncs

    t_phase = time.perf_counter()
    card = gpu_line()
    x = torch.ones(4, device=dev)
    with counting_syncs() as ctl:
        x.sum().item()
    if len(ctl) != 1:
        raise AssertionError(f"host syncs cannot be counted here: a window around one .item() "
                             f"counted {len(ctl)}")
    launches: Counter = Counter()
    for cache in ("slot", "paged"):
        build.reset_launches()  # this speculative run starts here
        out, m, info = spec_serve(torch, dev, cfg, policy, params, cache, requests(cfg, Request))
        launches.update(build.LAUNCHES)  # this speculative run ends here
        want, m_unf = serial[cache]
        what = f"spec {cache}, self4 ({cfg.name}, {policy.name})"
        held_equal(what, want, out)
        gate_spec(what, cfg, cache, m, info)
        log(f"{what}: streams equal phase 5's unfused serialized ones")
        spec_line(what, m, {"serialized fused (phase 3)": serial[f"{cache} fused"][1],
                            "serialized unfused (phase 5)": m_unf}, card)
        del info

    ccfg, cparams = cut(cfg, params)
    mp = get_policy("mixed_paper")
    mparams = M.init_params(torch.Generator(device=dev).manual_seed(SEED + 16), ccfg, mp,
                            device=dev)
    for cache, reqs in (("paged", requests), ("prefix", prefix_requests)):
        want, m_w = serve(torch, dev, ccfg, mp, mparams, cache, fused_attn=False,
                          reqs=reqs(ccfg, Request))
        out, m, info = spec_serve(torch, dev, ccfg, mp, mparams, cache, reqs(ccfg, Request))
        what = f"spec {cache}, self4 ({ccfg.name} cut to {CUT_LAYERS} layers, {mp.name})"
        held_equal(what, want, out)
        gate_spec(what, ccfg, cache, m, info)
        if m["cache/truncates"] == 0:
            raise AssertionError(f"{what}: no truncate (lossy drafts must be rejected)")
        log(f"{what}: streams equal the serialized ones; the pool conserved after each of "
            f"{info['steps']} steps; {m['cache/truncates']} truncates")
        spec_line(what, m, {"serialized unfused": m_w}, card)
        del info
    del mparams

    sreqs = lambda: sampled_requests(requests(ccfg, Request))  # noqa: E731
    out, m, info = spec_serve(torch, dev, ccfg, policy, cparams, "paged", sreqs())
    what = f"spec paged, self4, sampled ({CUT_LAYERS} layers)"
    held_equal(what, sampled_serial, out)
    gate_spec(what, ccfg, "paged", m, info)
    log(f"{what}: streams equal phase 14's sampled serialized ones")
    del info

    # the draft enters each prompt token by token: phase 3's two shortest
    # requests, their prompts cut to DRAFT_PROMPTS tokens
    dreqs = lambda: [Request(rid=r.rid, prompt=r.prompt[:n], max_new=r.max_new)  # noqa: E731
                     for r, n in zip(requests(ccfg, Request), DRAFT_PROMPTS)]
    want, m_w = serve(torch, dev, ccfg, policy, cparams, "paged", fused_attn=False, reqs=dreqs())
    draft = DraftModel()
    out, m, info = spec_serve(torch, dev, ccfg, policy, cparams, "paged", dreqs(), spec=draft)
    what = (f"spec paged, DraftModel ({draft.cfg.name}: {draft.cfg.n_layers} layers, d_model "
            f"{draft.cfg.d_model}, vocab {draft.cfg.vocab}; target {CUT_LAYERS} layers; phase "
            f"3's two shortest requests, prompts cut to {DRAFT_PROMPTS} tokens)")
    held_equal(what, want, out)
    gate_spec(what, ccfg, "paged", m, info, draft_cfg=draft.cfg)
    log(f"{what}: streams equal the serialized ones")
    spec_line(what, m, {"serialized unfused": m_w}, card)
    del info, draft

    spec_round_ms(torch, dev, cfg, policy, params)
    M_ = N_SLOTS * (SPEC_K + 1)
    lin = linears(params)
    row = mpmm_step_row(torch, dev, lin, M_, "one verify",
                        f"verify step, M = {M_} ({len(lin)} projections)", SEED + 16)
    log(f"phase 16 (speculative decoding): {time.perf_counter() - t_phase:.1f} s; {card}")
    return dict(launches), row


def spec_mla(torch, dev, cfg, policy, params, unfused) -> None:
    """Phase 16's DeepSeek-V3 run (three MLA-dense layers, full width, right
    after phase 14's): self4 on paged, phase 3's four greedy requests equal
    to phase 8's unfused paged run (``unfused``), ``gate_spec``."""
    from repro_torch.serve import Request

    t0 = time.perf_counter()
    out, m, info = spec_serve(torch, dev, cfg, policy, params, "paged", requests(cfg, Request))
    what = f"spec MLA paged, self4 ({cfg.name} cut to {cfg.n_layers} layers)"
    held_equal(what, unfused, out)
    gate_spec(what, cfg, "paged", m, info)
    log(f"{what}: streams equal phase 8's unfused ones; phase 16 (DeepSeek-V3): "
        f"{time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------- phase 17


def redraw_norms_and_biases(torch, params, seed: int):
    """Every norm ``scale`` / ``bias`` and linear ``b`` of ``params``
    redrawn in place from ``seed`` (scales around 1, biases around 0): the
    placeholder init leaves them at 1 and 0, where a bias the path dropped
    would not show. Returns how many leaves were redrawn."""
    g = torch.Generator(device=next(iter(_leaves(params))).device).manual_seed(seed)
    n = 0

    def walk(node, key=None):
        nonlocal n
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, key)
        elif key in ("scale", "bias", "b") and node.dtype == torch.float32:
            r = torch.randn(node.shape, generator=g, device=node.device) * 0.2
            node.copy_(r + 1 if key == "scale" else r)
            n += 1

    walk(params)
    return n


def variant_params(torch, dev, cfg, policy, seed):
    """Seeded params of ``cfg`` under ``policy`` on the card, norms and
    biases redrawn."""
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, policy, device=dev)
    n = redraw_norms_and_biases(torch, params, seed)
    torch.cuda.synchronize()
    nbytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    log(f"params: {cfg.name}, {cfg.n_layers} layers ({cfg.n_heads} / {cfg.kv_heads} heads of "
        f"{cfg.head_dim}, d_model {cfg.d_model}, norm {cfg.norm}, qkv bias {cfg.qkv_bias}, "
        f"window {cfg.window}, vocab {cfg.vocab} padded to {cfg.vocab_padded}), {policy.name}, "
        f"{nbytes / 1e9:.2f} GB, {n} norm and bias leaves redrawn, "
        f"{time.perf_counter() - t0:.1f} s to draw on the card")
    return params


def variant_fused(torch, dev, cfg, policy, params, what) -> tuple[dict, dict]:
    """Phase 3's four requests on the slot and the paged cache, fused:
    streams equal; paged_attn once a layer a decode step, paged_scatter once
    a layer a decode step of the paged run, mpmm at least seven times a
    layer a decode step. Returns (the paged streams, the launches)."""
    from repro_torch.kernels import build

    build.reset_launches()  # this variant's fused serving path starts here
    out_slot, m_slot = serve(torch, dev, cfg, policy, params, "slot")
    slot_launches = dict(build.LAUNCHES)
    out_paged, m_paged = serve(torch, dev, cfg, policy, params, "paged")
    launches = dict(build.LAUNCHES)  # this variant's fused serving path ends here
    if out_slot != out_paged:
        raise AssertionError(f"{what}: slot and paged token streams differ")
    L, steps = cfg.n_layers, m_slot["decode_steps"] + m_paged["decode_steps"]
    if launches.get("paged_attn", 0) != L * steps:
        raise AssertionError(f"{what}: {launches.get('paged_attn', 0)} paged_attn launches, want "
                             f"one a layer a decode step ({L * steps})")
    if launches.get("mpmm", 0) < 7 * L * steps:
        raise AssertionError(f"{what}: {launches.get('mpmm', 0)} mpmm launches, want at least "
                             f"seven a layer a decode step ({7 * L * steps})")
    once_a_layer("paged_scatter", launches.get("paged_scatter", 0)
                 - slot_launches.get("paged_scatter", 0), m_paged, cfg, f"{what}, paged")
    log(f"{what}: slot and paged streams identical, fused; launches {launches}")
    return out_paged, launches


def whole_prompt_rows(torch, dev, cfg, policy, params, report, tag, expert_launches=0) -> list:
    """One whole-prompt ``prefill_step`` of phase 11's four prompts into a
    dense kv8 cache (flash_mha once a layer; logits finite; with
    ``expert_launches``, that many batched expert products too) and one
    fused decode step from it, whose paged_attn calls record each layer's
    query and cache; ``qkv_decode`` runs every layer's attention again (once
    a layer), within ``row_tol`` (ATTN_TOL at the row's own sizes, as phase
    12) of its plain version. Then flash_mha's time per prefill_step and
    qkv_decode's per call at ``cfg``'s heads. Returns the kernels line's two
    rows, tagged ``tag``."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import qkv_decode as QD
    from repro_torch.models import model as M

    toks = whole_prompts(torch, dev, cfg)
    caches = M.init_cache(cfg, policy, N_SLOTS, S_MAX, device=dev)
    build.reset_launches()  # this prefill_step starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = M.prefill_step(params, {"tokens": toks}, caches, cfg, policy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre = dict(build.LAUNCHES)  # this prefill_step ends here
    if (pre.get("flash_mha", 0) != cfg.n_layers or pre.get("mpmm_experts", 0) != expert_launches
            or not torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{cfg.name} prefill_step: launches {pre}, want flash_mha once a "
                             f"layer and {expert_launches} batched expert products; logits "
                             f"finite: {bool(torch.isfinite(logits.float()).all())}")
    nxt = M.sample_tokens(logits[:, -1], [0.0] * N_SLOTS)[:, None]
    pos = torch.full((N_SLOTS,), PREFILL_LEN, dtype=torch.int32, device=dev)
    seen, paged_attn = [], ops.paged_attn

    def record(q, k, k_s, v, v_s, p, **kw):
        seen.append((q, k, k_s, v, v_s))
        return paged_attn(q, k, k_s, v, v_s, p, **kw)

    ops.paged_attn = record
    try:
        M.decode_step(params, nxt, pos, caches, cfg, policy, fused_attn=True)
    finally:
        ops.paged_attn = paged_attn
    build.reset_launches()  # this qkv_decode path starts here
    outs = [QD.qkv_decode(q, k, ks, v, vs, PREFILL_LEN, bits=8) for q, k, ks, v, vs in seen]
    torch.cuda.synchronize()
    qkv = dict(build.LAUNCHES)  # this qkv_decode path ends here
    if qkv.get("qkv_decode", 0) != cfg.n_layers:
        raise AssertionError(f"{cfg.name}: qkv_decode launched {qkv}, want once a layer")
    worst = 0.0
    for i, (out, (q, k, ks, v, vs)) in enumerate(zip(outs, seen)):
        tol = row_tol(torch, q, k, ks, v, vs, PREFILL_LEN)
        err = (out - QD.qkv_decode_plain(q, k, ks, v, vs, PREFILL_LEN, bits=8)).abs()
        if not torch.isfinite(out).all() or bool((err > tol).any()):
            raise AssertionError(f"{cfg.name} layer {i}: qkv_decode parts from its plain version "
                                 f"by {float((err / tol).max()):.3f} of row_tol")
        worst = max(worst, float((err / tol).max()))
    log(f"{cfg.name}: prefill_step of {N_SLOTS} x {PREFILL_LEN} tokens {wall:.3f} s wall, "
        f"flash_mha (D {cfg.head_dim}) {pre['flash_mha']} launches, batched expert products "
        f"{pre.get('mpmm_experts', 0)}; qkv_decode (D {cfg.head_dim}, kv8) over that dense "
        f"cache at pos {PREFILL_LEN}: {qkv['qkv_decode']} launches, within row_tol of its plain "
        f"version (largest {worst:.3f} of it)")
    del seen, outs, caches
    gc.collect()
    torch.cuda.empty_cache()
    flash = dict(flash_step_row(torch, dev, cfg), at=f"prefill_step, {cfg.name} ({tag})")
    qrow = dict(qkv_decode_row(torch, dev, cfg), at=f"per call, {cfg.name} ({tag})")
    return [kernel_row(flash, pre, report), kernel_row(qrow, qkv, report)]


def dense_variants_path(torch, dev, policy, report) -> list:
    """Phase 17 (after phases 16 and 15 and the MLA path, on weights of its
    own, norms and biases redrawn): the dense variants at published widths.
    h2o-danube-1.8b at full depth (24 layers, 32 / 8 heads of 80, window
    4096): phase 3's four requests on slot and paged, fused (streams equal;
    ``variant_fused``'s launches), then unfused (streams equal; paged_gather
    once a layer a decode step of the paged run, rowinv_bmm twice a layer a
    decode step or prefill chunk); the fused streams printed against the
    unfused ones, not gated (the two softmax sum in other orders). Then one
    whole-prompt ``prefill_step`` of phase 11's four prompts into a dense
    kv8 cache (flash_mha at D 80, once a layer; logits finite) and one
    fused decode step from it, whose paged_attn calls record each layer's
    query and cache; ``qkv_decode`` at D 80 runs every layer's attention
    again (once a layer), within ``row_tol`` (ATTN_TOL at the row's own
    sizes, as phase 12) of its plain version. Then flash_mha's time per
    prefill_step and qkv_decode's per call at danube's heads (the kernels
    line's D 80 rows). qwen1.5-4b (q / k / v biases, vocab 151936 padded to
    152064 through mpmm's head) and stablelm-3b (LayerNorm, vocab 50304
    padded to 50432) at published widths cut to CUT_LAYERS: phase 3's four
    requests on slot and paged, fused, streams equal. Returns the kernels
    line's D 80 rows."""
    from repro_torch import configs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import qkv_decode as QD
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    card = gpu_line()
    cfg = configs.get_arch(D80_ARCH)
    params = variant_params(torch, dev, cfg, policy, SEED + 20)
    fused, _ = variant_fused(torch, dev, cfg, policy, params, cfg.name)
    build.reset_launches()  # danube's unfused serving path starts here
    unf_slot, m_us = serve(torch, dev, cfg, policy, params, "slot", fused_attn=False)
    unf_paged, m_up = serve(torch, dev, cfg, policy, params, "paged", fused_attn=False)
    unf = dict(build.LAUNCHES)  # danube's unfused serving path ends here
    if unf_slot != unf_paged:
        raise AssertionError(f"{cfg.name}: unfused slot and paged token streams differ")
    once_a_layer("paged_gather", unf.get("paged_gather", 0), m_up, cfg,
                 f"{cfg.name}, unfused paged")
    calls = sum(m["decode_steps"] + m["prefill_jit_calls"] for m in (m_us, m_up))
    if unf.get("rowinv_bmm", 0) != 2 * cfg.n_layers * calls or unf.get("paged_attn", 0):
        raise AssertionError(f"{cfg.name}, unfused: launches {unf}; want rowinv_bmm two a layer "
                             f"a step or prefill chunk ({2 * cfg.n_layers * calls}), paged_attn "
                             f"none")
    log(f"{cfg.name}: unfused slot and paged streams identical; launches {unf}; "
        f"{tokens_equal(fused, unf_paged)} of the unfused streams equal the fused ones (not "
        f"gated: the fused and unfused softmax sum in other orders)")

    rows = whole_prompt_rows(torch, dev, cfg, policy, params, report, "D 80")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    for name in VARIANTS[1:]:
        ccfg = dataclasses.replace(configs.get_arch(name), n_layers=CUT_LAYERS)
        cparams = variant_params(torch, dev, ccfg, policy, SEED + 21)
        variant_fused(torch, dev, ccfg, policy, cparams, f"{ccfg.name} ({CUT_LAYERS} layers)")
        del cparams
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 17 (dense variants): {time.perf_counter() - t_phase:.1f} s; {card}")
    return rows


# --------------------------------------------------------------- phase 18


def experts_row(torch, dev, cfg, policy, params, at) -> dict:
    """mpmm over experts per decode step of N_SLOTS slots: every MoE
    layer's three batched expert products at M = the step's capacity (one
    dispatch group), over each layer's own packed weights (granite's 604 MB
    and DeepSeek-V3's 5.6 GB a layer: the 50 MB L2 holds none of them
    between uses), each expert with its own out-scale; beside its bound (the
    packed weights read once, the activations and the f32 outputs), its
    plain version and one ``torch.bmm`` a projection in bf16 over the
    expert weights dequantized ahead of time (``torch._int_mm`` refuses M
    <= 16)."""
    from repro_torch.core import pack as P
    from repro_torch.kernels import ops
    from repro_torch.models import ffn

    lp, mcfg = policy.of("expert"), cfg.moe_cfg
    E, Mr, rw = mcfg.n_experts, ffn.moe_capacity(N_SLOTS, mcfg), 8 // lp.w_bits
    projs = [layer["moe"][k] for layer in params["layers"] if "moe" in layer
             for k in ("gate", "up", "down")]

    def K_of(p):
        return p["w_packed"].shape[-1] * rw

    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    xs = {K: torch.randint(-128, 128, (E, Mr, K), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8) for K in {K_of(p) for p in projs}}
    kw = dict(x_bits=lp.x_bits, w_bits=lp.w_bits, y_bits=8, x_signed=True, out_kind="f32")

    def step(impl):
        return lambda: [ops.mpmm(xs[K_of(p)], p["w_packed"], None, out_scale=p["eps_w"],
                                 impl=impl, **kw) for p in projs]

    t, tw, how = device_ms(step("cuda"), names=("mpmm_kernel",))
    tp, tpw, _ = device_ms(step("torch"), reps=2, warmup=1)
    wts = []
    for p in projs:  # (E, K, N) bf16, dequantized an expert at a time
        w = torch.empty((E, K_of(p), p["w_packed"].shape[1]), dtype=torch.bfloat16, device=dev)
        for e in range(E):
            w[e] = (P.unpack(p["w_packed"][e], lp.w_bits, signed=True).float()
                    * p["eps_w"][e]).to(torch.bfloat16).t()
        wts.append(w)
    xb = {K: x.to(torch.bfloat16) for K, x in xs.items()}
    tl, tlw, _ = device_ms(lambda: [torch.bmm(xb[w.shape[1]], w) for w in wts])
    del wts, xb
    nops = sum(2 * E * Mr * p["w_packed"].shape[1] * K_of(p) for p in projs)
    wbytes = sum(p["w_packed"].numel() for p in projs)
    nbytes = wbytes + sum(E * Mr * K_of(p) + 4 * E * Mr * p["w_packed"].shape[1] + 4 * E
                          for p in projs)
    log(f"  mpmm over experts, {at} ({len(projs)} batched calls, E={E}, M={Mr}, cell "
        f"({lp.x_bits}, {lp.w_bits}, 8), f32 out): {t:.4f} ms device ({how}), {tw:.3f} ms wall; "
        f"plain {tp:.3f} ms device, {tpw:.3f} ms wall; torch.bmm (bf16, weights dequantized "
        f"ahead of time) {tl:.4f} ms device, {tlw:.3f} ms wall; {wbytes / 1e9:.4f} GB of packed "
        f"weights, {nbytes / 1e9:.4f} GB in all ({nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), "
        f"{nops / 1e9:.2f} G int8 operations ({nops / INT8_OPS_PER_S * 1e3:.5f} ms); "
        f"{nbytes / (t * 1e-3) / 1e12:.2f} TB/s")
    return dict(name="mpmm_experts", at=at, route="cuda", source="src/repro_torch/csrc/mpmm.cu",
                replaces="src/repro/kernels/mpmm.py:122", ms=t, plain_ms=tp, bytes=nbytes,
                work=[(nops, INT8_OPS_PER_S)], library_ms=tl)


def moe_serve(torch, dev, cfg, policy, params, what, fused_attn=True) -> tuple[dict, dict]:
    """Phase 3's four requests on the slot and the paged cache: streams
    equal; three batched expert products a MoE layer for each decode step
    and each prefill chunk. Returns (the paged streams, the launches)."""
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    n_moe = sum(k in M.MOE_KINDS for k in M._layer_kinds(cfg))
    build.reset_launches()  # this MoE serving path starts here
    out_slot, m_slot = serve(torch, dev, cfg, policy, params, "slot", fused_attn=fused_attn)
    out_paged, m_paged = serve(torch, dev, cfg, policy, params, "paged", fused_attn=fused_attn)
    launches = dict(build.LAUNCHES)  # this MoE serving path ends here
    if out_slot != out_paged:
        raise AssertionError(f"{what}: slot and paged token streams differ")
    forwards = sum(m["decode_steps"] + m["prefill_jit_calls"] for m in (m_slot, m_paged))
    if launches.get("mpmm_experts", 0) != 3 * n_moe * forwards:
        raise AssertionError(f"{what}: {launches.get('mpmm_experts', 0)} batched expert "
                             f"products, want three a MoE layer a decode step or prefill chunk "
                             f"(3 x {n_moe} x {forwards})")
    log(f"{what}: slot and paged streams identical; {launches['mpmm_experts']} batched expert "
        f"products (three a MoE layer for each of {forwards} decode steps and prefill chunks); "
        f"launches {launches}")
    return out_paged, launches


def moe_path(torch, dev, policy, report) -> list:
    """Phase 18 (run last, on weights of its own, norms redrawn): the MoE.
    granite-moe-1b-a400m at published widths and full depth (24 layers, 32
    experts top-8 of width 512, 16 / 8 heads of 64), w4a8 with kv8: phase
    3's four requests on slot and paged, fused, then unfused (``moe_serve``
    each: streams equal, three batched expert products a MoE layer a decode
    step or prefill chunk); fused against unfused printed, not gated; the
    decode step's breakdown (wall, device busy, by kernel) and the batched
    products' device time a decode step against its bound. One whole-prompt
    ``prefill_step`` of phase 11's four prompts (flash_mha at D 64 once a
    layer; the MoE's grouped dispatch, 32 groups, the experts at M = 768,
    three batched products a layer) and ``qkv_decode`` at D 64 over that
    cache (``whole_prompt_rows``). granite under mixed_paper (experts w2) at
    CUT_LAYERS: slot and paged, fused, streams equal. DeepSeek-V3 at
    published widths cut to its three dense layers and its first expert
    layer (256 experts top-8, a shared expert), w4a8 with the 8-bit latent
    cache: slot and paged, fused, streams equal, and its expert layer's
    batched products a decode step against their bytes bound. Returns the
    kernels line's rows."""
    from repro_torch import configs
    from repro_torch.core.policy import get_policy

    t_phase = time.perf_counter()
    card = gpu_line()
    cfg = configs.get_arch(MOE_ARCH)
    params = variant_params(torch, dev, cfg, policy, SEED + 30)
    fused, launches = moe_serve(torch, dev, cfg, policy, params, cfg.name)
    unf, _ = moe_serve(torch, dev, cfg, policy, params, f"{cfg.name}, unfused", fused_attn=False)
    log(f"{cfg.name}: {tokens_equal(fused, unf)} of the unfused streams equal the fused ones "
        f"(not gated: the fused and unfused softmax sum in other orders)")
    step_breakdown(torch, dev, cfg, policy, params)
    rows = [kernel_row(experts_row(torch, dev, cfg, policy, params,
                                   f"per decode step, {cfg.name} experts"), launches, report)]
    rows += whole_prompt_rows(torch, dev, cfg, policy, params, report, "D 64",
                              expert_launches=3 * cfg.n_layers)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mixed = get_policy("mixed_paper")
    ccfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    cparams = variant_params(torch, dev, ccfg, mixed, SEED + 31)
    moe_serve(torch, dev, ccfg, mixed, cparams, f"{ccfg.name} ({CUT_LAYERS} layers, mixed_paper)")
    del cparams
    gc.collect()
    torch.cuda.empty_cache()

    dcfg = dataclasses.replace(configs.get_arch(MLA_ARCH), n_layers=MOE_MLA_LAYERS)
    dparams = variant_params(torch, dev, dcfg, policy, SEED + 32)
    _, d_launches = moe_serve(torch, dev, dcfg, policy, dparams,
                              f"{dcfg.name} ({MOE_MLA_LAYERS} layers, the last with experts)")
    rows.append(kernel_row(experts_row(torch, dev, dcfg, policy, dparams,
                                       f"per decode step, {dcfg.name} expert layer"),
                           d_launches, report))
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 18 (MoE): {time.perf_counter() - t_phase:.1f} s; {card}")
    return rows


# --------------------------------------------------------------- phase 15


def disk_bytes(root) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(root).rglob("*") if f.is_file())


def bit_equal(torch, got, want, what) -> int:
    """Gate two port trees leaf by leaf: the same keys, dtypes, shapes and
    bytes. Returns the number of leaves."""
    from repro_torch.checkpoint import store

    a = {store._leaf_key(p): x for p, x in store._flatten(got)}
    b = {store._leaf_key(p): x for p, x in store._flatten(want)}
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: leaf keys differ: {sorted(set(a) ^ set(b))[:8]}")
    for k, w in b.items():
        g = a[k]
        if g.dtype != w.dtype or g.shape != w.shape or g.device != w.device or not same_bytes(
                torch, g, w):
            raise AssertionError(f"{what}: leaf {k} differs ({g.dtype} {tuple(g.shape)} on "
                                 f"{g.device} vs {w.dtype} {tuple(w.shape)} on {w.device})")
    return len(b)


def round_trip(torch, dev, cfg, policy, params, mode, what, card) -> dict:
    """Save ``params`` as ``{"params": <the reference's layout>}`` under a
    fresh temporary directory (deleted after), load it into a meta-device
    template onto the card, and gate every leaf bit-equal to ``params``.
    Prints the bytes on disk and the save and load times. Returns the loaded
    port tree."""
    import shutil
    import tempfile

    from repro_torch import bridge
    from repro_torch.checkpoint import store
    from repro_torch.models import model as M

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = {"params": bridge.params_to_reference(params, cfg)}
        store.save(root, 1, tree)
        t_save = time.perf_counter() - t0
        arrays = len(list(store._flatten(tree)))
        del tree
        nbytes = disk_bytes(root)
        meta = M.init_params(torch.Generator().manual_seed(SEED), cfg, policy, mode=mode,
                             device="meta")
        t0 = time.perf_counter()
        loaded, _ = store.load(root, {"params": bridge.params_to_reference(meta, cfg)},
                               device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    got = bridge.params_from_reference(loaded["params"], device=dev)
    n = bit_equal(torch, got, params, what)
    log(f"checkpoint[{what}]: {arrays} arrays ({n} leaves of the port's per-layer tree), "
        f"{nbytes} bytes on disk ({nbytes / 1e9:.3f} GB); "
        f"save {t_save:.3f} s ({nbytes / t_save / 1e9:.3f} GB/s), load onto the card "
        f"{t_load:.3f} s ({nbytes / t_load / 1e9:.3f} GB/s); every leaf bit-equal to the "
        f"saved params; {card}")
    return got


def packed_pairs(conv, train, parent=""):
    """(layer name, converted linear, train-mode linear) of every linear
    that ``convert_model_to_serving`` packed."""
    if isinstance(conv, dict):
        if "w_packed" in conv:
            yield parent, conv, train
        else:
            for k in conv:
                yield from packed_pairs(conv[k], train[k], k)
    elif isinstance(conv, list):
        for a, b in zip(conv, train, strict=True):
            yield from packed_pairs(a, b, parent)


def checkpoint_path(torch, dev, cfg, policy, params, out_slot, out_paged) -> None:
    """Phase 15 (right after phase 16, on phase 3's internlm2 w4a8 weights):
    the full-depth serve-mode round trip and the streams served from it
    (slot and paged, equal to phase 3's; mpmm, paged_attn and paged_scatter
    launched), then train to serve at full width and 4 layers: a train-mode
    tree saved, loaded and converted, every packed leaf bit-equal to
    ``convert_linear_to_serving`` of the same ``w``, and its greedy streams
    equal to the unconverted tree's (converted on the fly to the same
    codes)."""
    from repro_torch.core.linear import (
        _NAME_TO_CLASS,
        convert_linear_to_serving,
        convert_model_to_serving,
    )
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    card = gpu_line()
    loaded = round_trip(torch, dev, cfg, policy, params, "serve", f"{cfg.name} w4a8, serve",
                        card)
    build.reset_launches()  # the path served from disk starts here
    got_slot, _ = serve(torch, dev, cfg, policy, loaded, "slot")
    slot_launches = dict(build.LAUNCHES)
    got_paged, m_paged = serve(torch, dev, cfg, policy, loaded, "paged")
    launched = dict(build.LAUNCHES)  # the path served from disk ends here
    log(f"launches served from disk: slot {slot_launches}, slot + paged {launched}")
    if got_slot != out_slot or got_paged != out_paged:
        raise AssertionError("streams served from the checkpoint differ from phase 3's")
    for name in ("mpmm", "paged_attn", "paged_scatter"):
        if launched.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the path served from disk")
    once_a_layer("paged_scatter", launched["paged_scatter"] - slot_launches.get("paged_scatter", 0),
                 m_paged, cfg, "the paged path served from disk")
    log("served from disk: slot and paged streams equal phase 3's")
    del loaded
    gc.collect()
    torch.cuda.empty_cache()

    cfg4 = dataclasses.replace(cfg, n_layers=4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    train = M.init_params(gen, cfg4, policy, mode="train", device=dev)
    loaded = round_trip(torch, dev, cfg4, policy, train, "train",
                        f"{cfg4.name} cut to 4 layers, train mode", card)
    del train
    t0 = time.perf_counter()
    conv = convert_model_to_serving(loaded, policy)
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    n = 0
    for name, c, tr in packed_pairs(conv, loaded):
        one = convert_linear_to_serving({"w": tr["w"]}, policy.of(_NAME_TO_CLASS[name]))
        if not (same_bytes(torch, c["w_packed"], one["w_packed"])
                and same_bytes(torch, c["eps_w"], one["eps_w"])):
            raise AssertionError(f"convert_model_to_serving: {name} differs from "
                                 "convert_linear_to_serving of the same w")
        n += 1
    if n != 7 * cfg4.n_layers + 1:
        raise AssertionError(f"{n} linears packed, want 7 a layer and the head")
    log(f"convert_model_to_serving: {n} linears packed in {t_conv:.3f} s, each bit-equal to "
        "convert_linear_to_serving of the same w")
    build.reset_launches()
    want, _ = serve(torch, dev, cfg4, policy, loaded, "slot")
    got, _ = serve(torch, dev, cfg4, policy, conv, "slot")
    if got != want:
        raise AssertionError("streams of the converted tree differ from the unconverted tree's")
    if build.LAUNCHES.get("mpmm", 0) == 0:
        raise AssertionError("kernel mpmm was not launched serving the train-mode trees")
    log("train to serve: the converted tree's greedy streams equal the unconverted tree's "
        f"(converted on the fly); phase 15 (internlm2): {time.perf_counter() - t_phase:.1f} s")
    del loaded, conv
    gc.collect()
    torch.cuda.empty_cache()


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
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.BUILD_SECONDS:.1f} s, in "
        f"parallel; each source: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in sorted(build.SOURCE_SECONDS.items(),
                                                key=lambda kv: -kv[1])) + ")")
    for name, text in build.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"  ptxas[{name}]: {line.strip()}")

    cfg = configs.get_arch("internlm2-1.8b")
    policy = get_policy("w4a8")
    report: dict = {}
    check_mpmm(torch, dev, cfg, report)
    check_mpmm_experts(torch, dev, report)
    check_paged_scatter(torch, dev, cfg, configs.get_arch(MLA_ARCH), report)
    check_paged_attn(torch, dev, cfg, report)
    check_conv2d(torch, dev, report)
    check_qntpack(torch, dev, report)
    check_paged_gather(torch, dev, cfg, configs.get_arch(MLA_ARCH), report)
    check_paged_mla_attn(torch, dev, configs.get_arch(MLA_ARCH), report)
    check_paged_copy(torch, dev, cfg, configs.get_arch(MLA_ARCH), report)
    check_wdqmm(torch, dev, cfg, configs.get_arch(MLA_ARCH), report)
    check_flash_mha(torch, dev, cfg, report)
    check_qkv_decode(torch, dev, cfg, report)
    check_rowinv(torch, dev, cfg, configs.get_arch(MLA_ARCH), report)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.init_params(gen, cfg, policy, device=dev)
    torch.cuda.synchronize()
    log(f"params: internlm2-1.8b w4a8, {time.perf_counter() - t0:.1f} s to draw on the card")

    build.reset_launches()  # the serving path starts here
    out_slot, m_slot = serve(torch, dev, cfg, policy, params, "slot")
    slot_launches = dict(build.LAUNCHES)
    out_paged, m_paged = serve(torch, dev, cfg, policy, params, "paged")
    launches = dict(build.LAUNCHES)  # the serving path ends here
    log(f"launches on the serving path: slot {slot_launches}, slot + paged {launches}")
    if out_slot != out_paged:
        raise AssertionError("slot and paged token streams differ")
    log("slot and paged token streams identical")
    for name in ("mpmm", "paged_attn", "paged_scatter"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    once_a_layer("paged_scatter", launches["paged_scatter"] - slot_launches.get("paged_scatter", 0),
                 m_paged, cfg, "the paged serving path")

    ref_launches = reference_layer_path(torch, dev)

    build.reset_launches()  # the unfused paged read starts here
    unf_slot, m_unf_slot = serve(torch, dev, cfg, policy, params, "slot", fused_attn=False)
    unf_paged, m_unf = serve(torch, dev, cfg, policy, params, "paged", fused_attn=False)
    unf_launches = dict(build.LAUNCHES)  # the unfused paged read ends here
    log(f"launches on the unfused path: {unf_launches}")
    if unf_slot != unf_paged:
        raise AssertionError("unfused slot and unfused paged token streams differ")
    if unf_launches.get("paged_gather", 0) == 0:
        raise AssertionError("kernel paged_gather was not launched on the unfused paged path")
    for name in ("paged_scatter", "paged_gather"):
        once_a_layer(name, unf_launches[name], m_unf, cfg, "the unfused paged serving path")
    # every unfused decode step and every prefill chunk (which reads the
    # cache unfused) runs q . k and p . v through rowinv_bmm once a layer
    calls = sum(m["decode_steps"] + m["prefill_jit_calls"] for m in (m_unf_slot, m_unf))
    if unf_launches.get("rowinv_bmm", 0) != 2 * cfg.n_layers * calls:
        raise AssertionError(f"the unfused path: {unf_launches.get('rowinv_bmm', 0)} rowinv_bmm "
                             f"launches, want two a layer a step or prefill chunk "
                             f"({2 * cfg.n_layers * calls})")
    same = sum(a == b for rid in out_paged for a, b in zip(out_paged[rid], unf_paged[rid]))
    log(f"unfused slot and unfused paged token streams identical; {same} of "
        f"{sum(len(t) for t in out_paged.values())} tokens equal the fused paged streams "
        f"(not gated: the fused and unfused softmax sum in another order)")
    launches.update({k: ref_launches.get(k, 0) for k in ("conv2d", "qntpack")})
    launches["paged_gather"] = unf_launches["paged_gather"]
    launches["rowinv_bmm"] = unf_launches["rowinv_bmm"]

    prefix_launches, _ = prefix_path(torch, dev, cfg, policy, params)
    launches["paged_copy"] = prefix_launches["paged_copy"]

    teacher_forced(torch, dev, cfg, policy, params, report)
    step_breakdown(torch, dev, cfg, policy, params)
    paged_breakdown(torch, dev, cfg, policy, params)
    rows = kernel_table(torch, dev, cfg, params, launches, report)
    wo_row, wo_launches = weight_only_path(torch, dev, cfg, params, report)
    rows.insert(1, kernel_row(wo_row, wo_launches, report))
    (flash_row, mm_row), prefill_launches = whole_prompt_path(torch, dev, cfg, policy, params,
                                                               report)
    rows.insert(1, kernel_row(mm_row, prefill_launches, report))
    rows.insert(4, kernel_row(flash_row, prefill_launches, report))
    qkv_row, qkv_launches = dense_cache_path(torch, dev, cfg, policy, params, report)
    sampled_path(torch, dev, cfg, policy, params)
    serial = {"slot": (unf_slot, m_unf_slot), "paged": (unf_paged, m_unf),
              "slot fused": (out_slot, m_slot), "paged fused": (out_paged, m_paged)}
    cont_launches, mixed_row, sampled_serial = continuous_path(torch, dev, cfg, policy, params,
                                                               serial)
    rows.insert(2, kernel_row(mixed_row, cont_launches, report))
    spec_launches, verify_row = spec_path(torch, dev, cfg, policy, params, serial, sampled_serial)
    rows.insert(3, kernel_row(verify_row, spec_launches, report))
    del sampled_serial
    checkpoint_path(torch, dev, cfg, policy, params, out_slot, out_paged)
    del params, serial
    gc.collect()
    torch.cuda.empty_cache()

    mla_row, mla_launches = mla_path(torch, dev, policy, report)
    rows.append(kernel_row(mla_row, mla_launches, report))
    rows.append(kernel_row(qkv_row, qkv_launches, report))
    gc.collect()
    torch.cuda.empty_cache()
    rows += dense_variants_path(torch, dev, policy, report)
    gc.collect()
    torch.cuda.empty_cache()
    rows += moe_path(torch, dev, policy, report)
    log(gpu_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
