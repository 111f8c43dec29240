"""Architecture assembly for serving (counterpart of ``repro.models.model``):
the dense family, the moe family (GQA attention with a Mixture-of-Experts
feed-forward) and the mla_moe family (MLA layers, dense then MoE).

Params are plain nested dicts of tensors: ``embed``, ``final_norm``,
``head`` and ``layers``, a list with one block dict per layer (the
reference stacks layers on a leading scan axis; the port loops over them),
plus ``mtp_block`` / ``mtp_proj`` / ``mtp_norm`` when ``cfg.mtp`` (the
reference's training-only multi-token-prediction head; serving never reads
them). Each layer's kind (``dense``, ``moe``, ``mla_dense`` or
``mla_moe``) follows from the config (:func:`_layer_kinds`); a MoE layer
holds ``moe`` (``models.ffn.moe_init``) where a dense one holds ``mlp``.
Caches are a list with one dict per layer: ``{"k", "k_s", "v", "v_s"}``
for GQA layers, ``{"c", "c_s", "r"}`` for MLA
layers; dense (n_slots, s_max, ...) stripes, or a shared (n_pages,
page_size, ...) pool addressed by block tables. Caches are written in
place.

Every projection routes through ``core.linear`` under the active
PrecisionPolicy. Ported: ``init_params`` (serve and train mode), ``init_cache``,
``init_paged_cache``, ``forward`` (serve mode, dense family),
``prefill_step``, ``decode_step``, ``prefill_chunk``,
``prefill_into_slot``, ``prefill_into_pages``, ``mixed_step`` (continuous
batching), ``spec_verify_step`` (speculative decoding) and ``sample_tokens``.
Weight-only expert layers are not ported: a policy that quantizes the
``expert`` class weight-only raises at ``init_params(mode="serve")`` and
at engine construction (:func:`check_policy`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import host_copy, resolve_device
from repro_torch.core import prng
from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels import dispatch, ops
from repro_torch.models.attention import (
    AttnCfg,
    MLACfg,
    attn_apply,
    attn_init,
    cache_init,
    mla_apply,
    mla_cache_init,
    mla_init,
    row_window,
)
from repro_torch.models.common import NORMS, embed_apply, embed_init
from repro_torch.models.ffn import MLPCfg, MoECfg, mlp_apply, mlp_init, moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # the port serves "dense", "moe" and "mla_moe"
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model / n_heads
    qkv_bias: bool = False
    window: Optional[int] = None  # SWA
    norm: str = "rms"
    act: str = "silu"
    rope_theta: float = 10_000.0
    # stablelm: 0.25. Carried to mirror the reference's config, where no code
    # reads it (rotary runs over the whole head there): the port applies full
    # rotary too, or it would part from the reference
    rope_pct: float = 1.0
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared: int = 0
    shared_d_ff: int = 0
    dense_layers: int = 0  # deepseek-v3: first 3 layers dense
    # mla (deepseek)
    mla: bool = False
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    mtp: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256, as in the reference."""
        return -(-self.vocab // 256) * 256

    @property
    def attn_cfg(self) -> AttnCfg:
        return AttnCfg(d_model=self.d_model, n_heads=self.n_heads, kv_heads=self.kv_heads,
                       head_dim=self.head_dim, qkv_bias=self.qkv_bias, window=self.window,
                       rope_theta=self.rope_theta)

    @property
    def mla_cfg(self) -> MLACfg:
        return MLACfg(d_model=self.d_model, n_heads=self.n_heads, q_lora=self.q_lora,
                      kv_lora=self.kv_lora, d_nope=self.d_nope, d_rope=self.d_rope,
                      d_v=self.d_v, rope_theta=self.rope_theta)

    @property
    def mlp_cfg(self) -> MLPCfg:
        return MLPCfg(self.d_model, self.d_ff, self.act, gated=self.act != "gelu")

    @property
    def moe_cfg(self) -> MoECfg:
        return MoECfg(d_model=self.d_model, n_experts=self.n_experts, top_k=self.top_k,
                      d_ff_expert=self.moe_d_ff or self.d_ff, n_shared=self.n_shared,
                      d_ff_shared=self.shared_d_ff, act=self.act)


#: Families the port can prefill in chunks and page (the reference also
#: pages vlm, which is not ported yet).
PREFILL_CHUNKABLE_FAMILIES = ("dense", "moe", "mla_moe")
PAGEABLE_FAMILIES = ("dense", "moe", "mla_moe")
#: layer kinds the port builds
PORTED_KINDS = ("dense", "moe", "mla_dense", "mla_moe")
MOE_KINDS = ("moe", "mla_moe")


def _layer_kinds(cfg: ArchConfig) -> list[str]:
    """Per-layer block kind (the reference's ``_layer_kinds``, for the
    families the port knows)."""
    if cfg.family == "dense":
        return ["dense"] * cfg.n_layers
    if cfg.family == "moe":
        return ["moe"] * cfg.n_layers
    if cfg.family == "mla_moe":
        return (["mla_dense"] * cfg.dense_layers
                + ["mla_moe"] * (cfg.n_layers - cfg.dense_layers))
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def _check_family(cfg: ArchConfig) -> list[str]:
    """The layer kinds of ``cfg``; raises if one is not ported."""
    kinds = _layer_kinds(cfg)
    missing = sorted(set(kinds) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: layer kind(s) {missing} are not ported yet; "
            f"the port builds {PORTED_KINDS}")
    return kinds


def check_policy(cfg: ArchConfig, policy: PrecisionPolicy) -> None:
    """Refuse, before any weight is drawn or any step runs, a policy whose
    ``expert`` class is weight-only on a config with MoE layers: the
    reference runs those experts through a vmapped wdqmm, which the port
    does not have."""
    lp = policy.of("expert")
    if lp.quantized and not lp.act_quantized and set(_layer_kinds(cfg)) & set(MOE_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: policy {policy.name!r} quantizes the experts weight-only "
            f"(w{lp.w_bits}, bf16 activations), which the port does not serve; quantize "
            "their activations too (e.g. w4a8) or keep them bf16")


def _mlp_cfg(cfg: ArchConfig, kind: str) -> MLPCfg:
    if kind == "mla_dense":  # deepseek dense layers: d_ff 18432 = 9 * 2048
        return MLPCfg(cfg.d_model, cfg.d_ff * 9, cfg.act)
    return cfg.mlp_cfg


def _scan_groups(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Contiguous (kind, count) runs of ``_layer_kinds``: the reference
    stacks each run's layers on a leading axis (one scan per group), which
    is the layout of its checkpoints."""
    groups: list[tuple[str, int]] = []
    for kd in _layer_kinds(cfg):
        if groups and groups[-1][0] == kd:
            groups[-1] = (kd, groups[-1][1] + 1)
        else:
            groups.append((kd, 1))
    return groups


def _block_init(gen, cfg: ArchConfig, policy, kind: str, mode: str, device, dtype) -> dict:
    ninit, _ = NORMS[cfg.norm]
    kw = dict(mode=mode, device=device, dtype=dtype)
    attn = (mla_init(gen, cfg.mla_cfg, policy, **kw) if kind.startswith("mla")
            else attn_init(gen, cfg.attn_cfg, policy, **kw))
    p = {"norm1": ninit(cfg.d_model, device=device),
         "norm2": ninit(cfg.d_model, device=device),
         "attn": attn}
    if kind in MOE_KINDS:
        p["moe"] = moe_init(gen, cfg.moe_cfg, policy, **kw)
    else:
        p["mlp"] = mlp_init(gen, _mlp_cfg(cfg, kind), policy, **kw)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, policy: PrecisionPolicy, *,
                mode: str = "serve", device=None, dtype=torch.bfloat16) -> dict:
    """Params with placeholder weights drawn from ``gen`` (a
    ``torch.Generator`` on ``device``; None means CUDA). ``serve`` mode (the
    port's default; the reference's is ``train``) packs every quantized
    linear; ``train`` mode gives it a float ``w`` in ``dtype``, the tree QAT
    trains and ``core.linear.convert_model_to_serving`` converts. On
    ``device="meta"`` the tree holds shapes and dtypes only: a template for
    ``checkpoint.load``."""
    kinds = _check_family(cfg)
    device = resolve_device(device)
    if mode == "serve":
        dispatch.ensure_policy_supported(policy)
        check_policy(cfg, policy)
    ninit, _ = NORMS[cfg.norm]
    params: dict = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, device=device, dtype=dtype),
        "final_norm": ninit(cfg.d_model, device=device),
        "head": linear_init(gen, cfg.d_model, cfg.vocab_padded, policy.of("head"),
                            mode=mode, device=device, dtype=dtype),
        "layers": [_block_init(gen, cfg, policy, kind, mode, device, dtype) for kind in kinds],
    }
    if cfg.mtp:
        params["mtp_block"] = _block_init(gen, cfg, policy, "mla_dense", mode, device, dtype)
        params["mtp_proj"] = linear_init(gen, 2 * cfg.d_model, cfg.d_model, policy.of("head"),
                                         mode=mode, device=device, dtype=dtype)
        params["mtp_norm"] = ninit(cfg.d_model, device=device)
    return params


def _run_stack(params, x, pos, cfg: ArchConfig, policy, *, impl, caches=None, cache_pos=None,
               attend_cached=False, block_tables=None, fused_attn=False):
    """The layer stack; ``caches`` None runs it without a cache (the
    whole-sequence forward). Returns (x, the summed MoE aux loss, f32)."""
    _, nfn = NORMS[cfg.norm]
    kw = dict(impl=impl, cache_pos=cache_pos, attend_cached=attend_cached,
              block_table=block_tables, fused=fused_attn)
    if caches is None:
        caches = [None] * len(params["layers"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, cache, kind in zip(params["layers"], caches, _layer_kinds(cfg), strict=True):
        h = nfn(lp["norm1"], x)
        if kind.startswith("mla"):
            a, _ = mla_apply(lp["attn"], h, pos, cfg.mla_cfg, policy, cache=cache, **kw)
        else:
            a, _ = attn_apply(lp["attn"], h, pos, cfg.attn_cfg, policy, cache=cache, **kw)
        x = x + a
        h = nfn(lp["norm2"], x)
        if kind in MOE_KINDS:
            m, a_l = moe_apply(lp["moe"], h, cfg.moe_cfg, policy, impl=impl)
            aux = aux + a_l
        else:
            m = mlp_apply(lp["mlp"], h, _mlp_cfg(cfg, kind), policy, impl=impl)
        x = x + m
    return x, aux


def init_cache(cfg: ArchConfig, policy: PrecisionPolicy, batch: int, s_max: int, *,
               device=None) -> list:
    """Per-layer dense caches (``device`` None means CUDA): K/V leaves for
    GQA layers, latent ``c`` / ``c_s`` / ``r`` leaves for MLA layers."""
    kinds = _check_family(cfg)
    device = resolve_device(device)
    bits = policy.kv_cache_bits
    return [mla_cache_init(batch, s_max, cfg.mla_cfg, bits, device=device)
            if kind.startswith("mla")
            else cache_init(batch, s_max, cfg.kv_heads, cfg.head_dim, bits, device=device)
            for kind in kinds]


def init_paged_cache(cfg: ArchConfig, policy: PrecisionPolicy, n_pages: int,
                     page_size: int, *, device=None) -> list:
    """Paged KV pool: the dense layout with (batch, s_max) replaced by a
    global (n_pages, page_size) pool on every leaf. Page 0 is the scratch
    page the cache manager reserves."""
    if cfg.family not in PAGEABLE_FAMILIES:
        raise NotImplementedError(f"paged KV cache unsupported for family {cfg.family!r}")
    return init_cache(cfg, policy, n_pages, page_size, device=device)


def _positions(pos, B: int, S: int, device) -> torch.Tensor:
    """(B, S) token positions of a chunk written at ``pos`` ((B,) or (1,))."""
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1).expand(B)
    return pos_b[:, None] + torch.arange(S, dtype=torch.int32, device=device)[None]


def _whole_sequence(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                    policy: PrecisionPolicy, *, impl, caches=None) -> torch.Tensor:
    """The body ``forward`` and ``prefill_step`` share: embed ``tokens``
    (B, S) at positions 0..S-1 and run the layer stack, writing ``caches``
    from position 0 when given. Returns (the hidden rows before the final
    norm, the summed MoE aux loss)."""
    x = embed_apply(params["embed"], tokens).to(torch.bfloat16)
    B, S = tokens.shape
    return _run_stack(params, x, _positions(0, B, S, x.device), cfg, policy, impl=impl,
                      caches=caches, cache_pos=None if caches is None else 0)


def forward(params: dict, batch: dict, cfg: ArchConfig, policy: PrecisionPolicy, *,
            mode: str = "serve", impl: ops.Impl = "auto"):
    """Whole-sequence forward in serve mode (scoring, teacher-forced
    evaluation): ``batch["tokens"]`` (B, S) at positions 0..S-1, causal
    attention through the flash_mha kernel, no cache. Returns (logits (B,
    S, V) in the activation dtype, aux) with the reference's
    ``aux["moe_aux"]``, the MoE layers' aux losses summed (0.0 without
    one). The train mode (QAT) is not ported; MLA layers raise in
    ``mla_apply``."""
    if mode != "serve":
        raise NotImplementedError(f"forward(mode={mode!r}): only the serve mode is ported "
                                  "(QAT training is not)")
    _, nfn = NORMS[cfg.norm]
    x, aux = _whole_sequence(params, batch["tokens"], cfg, policy, impl=impl)
    logits = linear_apply(params["head"], nfn(params["final_norm"], x), policy.of("head"),
                          impl=impl)
    return logits, {"moe_aux": aux}


def prefill_step(params: dict, batch: dict, caches: list, cfg: ArchConfig,
                 policy: PrecisionPolicy, *, impl: ops.Impl = "auto"):
    """Whole-prompt prefill: ``batch["tokens"]`` (B, S) run as one forward
    that writes the quantized K/V at positions 0..S-1 of the dense
    ``caches`` (in place) while attention runs over the fresh k/v through
    the flash_mha kernel. Returns (last-token logits (B, 1, V), caches); the
    final norm and the head run on the last row only."""
    _, nfn = NORMS[cfg.norm]
    x, _ = _whole_sequence(params, batch["tokens"], cfg, policy, impl=impl, caches=caches)
    x_last = nfn(params["final_norm"], x[:, -1:])
    return linear_apply(params["head"], x_last, policy.of("head"), impl=impl), caches


def decode_step(params: dict, tokens: torch.Tensor, pos, caches: list, cfg: ArchConfig,
                policy: PrecisionPolicy, *, impl: ops.Impl = "auto",
                block_tables: Optional[torch.Tensor] = None, fused_attn: bool = False):
    """One serving step: tokens (B, 1), pos the (B,) int32 cache write
    positions. Returns logits (B, 1, V) in the activation dtype; the caches
    are updated in place. ``block_tables`` (B, n_blocks) selects the paged
    layout; ``fused_attn`` routes attention through the paged_attn kernel."""
    _, nfn = NORMS[cfg.norm]
    x = embed_apply(params["embed"], tokens).to(torch.bfloat16)
    B, S = tokens.shape
    pos_ids = _positions(pos, B, S, x.device)
    x, _ = _run_stack(params, x, pos_ids, cfg, policy, impl=impl, caches=caches,
                      cache_pos=pos, block_tables=block_tables, fused_attn=fused_attn)
    x = nfn(params["final_norm"], x)
    return linear_apply(params["head"], x, policy.of("head"), impl=impl)


_TORCH_DTYPES = {np.float32: torch.float32, np.int64: torch.int64}


def _lane(x, dtype, fill, n: int, device) -> torch.Tensor:
    """One per-slot vector on ``device``. A tensor already there (a
    ``SnapshotRing`` snapshot) is used as it is, cast to ``dtype`` on the
    device; a host vector crosses through ``host_copy`` (a private copy,
    so the caller may mutate its own while the upload is in flight: the
    port's boundary rule, ``serve.boundary``)."""
    if isinstance(x, torch.Tensor) and x.device == torch.device(device):
        return x.to(_TORCH_DTYPES[dtype]).reshape(n)
    a = np.full(n, fill, dtype) if x is None else np.asarray(x, dtype=dtype)
    return host_copy(a.reshape(n), device)


def sample_tokens(logits: torch.Tensor, temps, top_k=None, top_p=None, seeds=None,
                  counters=None, *, sampled: Optional[bool] = None) -> torch.Tensor:
    """The batched per-slot sampler (counterpart of the reference's
    ``sample_tokens``): every token the engine emits comes through here.

    ``logits`` is (B, V) on the device; the per-slot vectors are (B,)
    host sequences, or tensors already on the logits' device (the
    continuous engine's snapshots): ``temps`` (0 => greedy argmax, first
    maximum, as ``jnp.argmax``), ``top_k`` (0 => off), ``top_p`` (1.0 =>
    off), ``seeds`` (uint32 values) and ``counters`` (tokens already
    emitted for the slot's request). Token ``i`` of a request draws from
    ``fold_in(PRNGKey(seed), i)`` (``core.prng``, JAX's threefry bit for
    bit), so a stream depends on (seed, counter) alone.

    A stochastic lane runs the reference's steps: divide by
    ``max(t, 1e-6)``; one stable descending argsort; keep logits >= the
    k-th largest (ties kept); softmax; the nucleus keep mask
    ``(cumsum(sp) - sp) < p`` in sorted order, scattered back; the
    Gumbel-max draw. Greedy lanes keep their argmax. The reference branches
    on ``any(temps > 0)`` on the device (``lax.cond``); here the host
    decides (``sampled``: whether any lane samples; None reads it from
    ``temps``, which must then be on the host), so an all-greedy step
    launches nothing beyond the argmax. Nothing here waits for the card
    when the lanes are on the device. Returns (B,) int32 on the logits'
    device."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if sampled is None:
        if isinstance(temps, torch.Tensor) and temps.device.type != "cpu":
            raise ValueError("sample_tokens: pass sampled= with temperatures on the device "
                             "(reading them would wait for the card)")
        sampled = bool(np.any(np.asarray(temps, dtype=np.float32) > 0))
    if not sampled:
        return greedy
    B, V = logits.shape
    dev = logits.device
    t = _lane(temps, np.float32, 0.0, B, dev)
    k = _lane(top_k, np.int64, 0, B, dev)
    p = _lane(top_p, np.float32, 1.0, B, dev)
    key = prng.fold_in(prng.prng_key(_lane(seeds, np.int64, 0, B, dev)),
                       _lane(counters, np.int64, 0, B, dev))
    lg = logits / torch.clamp(t, min=1e-6)[:, None]
    # one descending sort serves both truncations: top-k only sends entries
    # below the threshold to -inf, so the order stays a valid descending one
    order = torch.argsort(-lg, dim=-1, stable=True)
    kth = lg.gather(1, order.gather(1, torch.clamp(k - 1, 0, V - 1)[:, None]))
    lg = lg.masked_fill((k[:, None] > 0) & (lg < kth), float("-inf"))
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    sp = (e / e.sum(dim=-1, keepdim=True)).gather(1, order)
    keep = torch.zeros_like(lg, dtype=torch.bool).scatter(
        1, order, (torch.cumsum(sp, dim=-1) - sp) < p[:, None])
    lg = lg.masked_fill(~keep, float("-inf"))
    sampled_toks = prng.categorical(key, lg).to(torch.int32)
    return torch.where(t > 0, sampled_toks, greedy)


def prefill_chunk(params: dict, tokens: torch.Tensor, pos, caches: list, cfg: ArchConfig,
                  policy: PrecisionPolicy, *, last_idx: Optional[int] = None,
                  head: bool = True, impl: ops.Impl = "auto"):
    """Batched prefill of one token chunk through the dense cache
    (``attend_cached``): tokens (B, S_chunk) are written at ``pos``; returns
    the last-token logits (B, 1, V), or None with ``head=False``."""
    if cfg.family not in PREFILL_CHUNKABLE_FAMILIES:
        raise NotImplementedError(f"chunked prefill unsupported for family {cfg.family!r}")
    _, nfn = NORMS[cfg.norm]
    x = embed_apply(params["embed"], tokens).to(torch.bfloat16)
    B, S = tokens.shape
    pos_ids = _positions(pos, B, S, x.device)
    x, _ = _run_stack(params, x, pos_ids, cfg, policy, impl=impl, caches=caches,
                      cache_pos=pos, attend_cached=True)
    if not head:
        return None
    li = S - 1 if last_idx is None else int(last_idx)
    x_last = nfn(params["final_norm"], x[:, li:li + 1])
    return linear_apply(params["head"], x_last, policy.of("head"), impl=impl)


def _scrub_tail(row: list, pos: int, S: int, last_idx: Optional[int]) -> None:
    """Zero the rows a right-padded final chunk wrote past its last real
    token (in place; rows past the cache are ignored), so chunked prefill
    leaves the cache bit-identical to an unpadded prefill."""
    if last_idx is None:
        return
    lo = pos + int(last_idx) + 1
    for leaves in row:
        for a in leaves.values():
            a[:, lo:pos + S] = 0


def prefill_into_slot(params: dict, tokens: torch.Tensor, slot: int, pos: int,
                      caches: list, cfg: ArchConfig, policy: PrecisionPolicy, *,
                      last_idx: Optional[int] = None, head: bool = True,
                      impl: ops.Impl = "auto"):
    """Single-slot prefill against an ``n_slots``-batch dense cache: the
    chunk runs at B=1 on views of row ``slot``, so its writes land in place.
    Returns the logits (1, 1, V) or None."""
    row = [{k: a[slot:slot + 1] for k, a in layer.items()} for layer in caches]
    pos_v = torch.tensor([pos], dtype=torch.int32, device=tokens.device)
    logits = prefill_chunk(params, tokens, pos_v, row, cfg, policy, last_idx=last_idx,
                           head=head, impl=impl)
    _scrub_tail(row, pos, tokens.shape[1], last_idx)
    return logits


def prefill_into_pages(params: dict, tokens: torch.Tensor, block_row: torch.Tensor,
                       pos: int, caches: list, cfg: ArchConfig, policy: PrecisionPolicy,
                       *, page_size: int, last_idx: Optional[int] = None,
                       head: bool = True, impl: ops.Impl = "auto"):
    """Paged twin of :func:`prefill_into_slot`: the request's pages
    (``block_row``, (n_blocks,) int32; unallocated entries point at the
    scratch page 0) are gathered into one contiguous logical row, the chunk
    runs exactly as on the dense layout, and the row is scattered back page
    by page."""
    nb = block_row.shape[0]
    idx = block_row.long()
    row = [{k: a[idx].reshape(1, nb * page_size, *a.shape[2:]) for k, a in layer.items()}
           for layer in caches]
    pos_v = torch.tensor([pos], dtype=torch.int32, device=tokens.device)
    logits = prefill_chunk(params, tokens, pos_v, row, cfg, policy, last_idx=last_idx,
                           head=head, impl=impl)
    _scrub_tail(row, pos, tokens.shape[1], last_idx)
    for layer, rlayer in zip(caches, row):
        for k, a in layer.items():
            a[idx] = rlayer[k].reshape(nb, page_size, *a.shape[2:])
    return logits


def mixed_step(params: dict, tokens: torch.Tensor, pos, n_real, caches: list, cfg: ArchConfig,
               policy: PrecisionPolicy, *, impl: ops.Impl = "auto",
               block_tables: Optional[torch.Tensor] = None,
               page_size: Optional[int] = None) -> torch.Tensor:
    """One continuous-batching step (the reference's ``mixed_step``): each
    lane of the (B, W) token batch is a decode lane (``n_real[b] == 1``),
    a prefill lane (a right-padded chunk of up to W prompt tokens) or idle
    (``n_real[b] == 0``), all in ONE forward through the cache
    (``attend_cached``, the branch chunked prefill takes). ``pos`` and
    ``n_real`` are (B,) int32 (on the device on the hot path: nothing here
    waits for the card). The caches are written in place.

    Returns logits (B, 1, V): lane b's are taken at its last real position
    (``n_real[b] - 1``) before the final norm and the head, so the head runs
    at M = B; idle lanes return values the caller discards. Each lane's
    padded tail (chunk positions >= ``n_real[b]``) is then scrubbed to zero,
    so the cache holds what the serialized engine writes: dense leaves in
    place (rows past s_max dropped), paged leaves through ``block_tables``
    (``page_size`` required), on allocated pages only; rows past a lane's
    table or on the scratch page 0 are left alone (trash by contract).

    No ``fused_attn`` parameter: the fused decode kernel takes S == 1 and a
    mixed step is S == W, so it always reads the cache unfused."""
    x, n_real = _window_stack(params, tokens, pos, n_real, caches, cfg, policy, impl=impl,
                              block_tables=block_tables, page_size=page_size,
                              refusal="mixed prefill+decode steps unsupported for family "
                                      "{family!r} (supported: {supported}); serve serialized")
    B = tokens.shape[0]
    _, nfn = NORMS[cfg.norm]
    last = torch.clamp(n_real.long() - 1, min=0)[:, None, None].expand(B, 1, x.shape[-1])
    x_last = nfn(params["final_norm"], x.gather(1, last))
    return linear_apply(params["head"], x_last, policy.of("head"), impl=impl)


def spec_verify_step(params: dict, tokens: torch.Tensor, pos, n_real, temps, top_ks, top_ps,
                     seeds, counters, caches: list, cfg: ArchConfig, policy: PrecisionPolicy,
                     *, impl: ops.Impl = "auto", block_tables: Optional[torch.Tensor] = None,
                     page_size: Optional[int] = None) -> torch.Tensor:
    """Speculative decoding's verify (the reference's ``spec_verify_step``):
    the target scores a drafted window in one forward. Lane b of ``tokens``
    (B, W = k+1) is ``[last emitted, draft_0, .., draft_{k-1}]`` for a
    speculating lane (``n_real[b] == W``), a right-padded decode lane
    (``n_real[b] == 1``) or idle (0). The forward and the per-lane pad scrub
    are :func:`mixed_step`'s: all W query rows attend in one call, and on
    the card (``ops.rowinv_einsum``) each accepted row has the bits a
    serialized decode step gives it, so the cache rows a round keeps and the
    tokens it emits are the serialized engine's. The head runs over all W
    positions, and every
    offset is sampled in the same call through :func:`sample_tokens`: offset
    j of lane b draws at counter ``counters[b] + j``, the emission index the
    serialized engine would use there, on the flattened (B * W) lanes. The
    sampling lanes (``temps``, ``top_ks``, ``top_ps``, ``seeds``,
    ``counters``) are (B,) host vectors. The caches are written in place.

    Returns the targets (B, W) int32 on the device; offsets past a lane's
    ``n_real`` hold tokens the caller never reads."""
    x, _ = _window_stack(params, tokens, pos, n_real, caches, cfg, policy, impl=impl,
                         block_tables=block_tables, page_size=page_size,
                         refusal="speculative verify unsupported for family {family!r} "
                                 "(supported: {supported}); these families lack the "
                                 "position-indexed cache the multi-token write needs")
    B, W = tokens.shape
    _, nfn = NORMS[cfg.norm]
    logits = linear_apply(params["head"], nfn(params["final_norm"], x), policy.of("head"),
                          impl=impl)  # (B, W, V)

    def per_offset(a, dtype):
        return np.repeat(np.asarray(a, dtype=dtype), W)

    ctr = np.asarray(counters, np.int64)[:, None] + np.arange(W, dtype=np.int64)[None]
    return sample_tokens(logits.reshape(B * W, -1), per_offset(temps, np.float32),
                         per_offset(top_ks, np.int64), per_offset(top_ps, np.float32),
                         per_offset(seeds, np.int64), ctr.reshape(-1)).reshape(B, W)


def _window_stack(params: dict, tokens: torch.Tensor, pos, n_real, caches: list,
                  cfg: ArchConfig, policy: PrecisionPolicy, *, impl, block_tables, page_size,
                  refusal: str):
    """The forward :func:`mixed_step` and :func:`spec_verify_step` share:
    embed the (B, W) window, run the stack through the cache at ``pos``
    (``attend_cached``),
    then scrub each lane's rows past ``n_real`` (the caches are written in
    place). Returns (hidden rows (B, W, d) before the final norm,
    ``n_real`` as a (B,) int32 tensor on the device)."""
    if cfg.family not in PREFILL_CHUNKABLE_FAMILIES:
        raise NotImplementedError(refusal.format(family=cfg.family,
                                                 supported=PREFILL_CHUNKABLE_FAMILIES))
    if block_tables is not None and page_size is None:
        raise ValueError("page_size is required with block_tables")
    x = embed_apply(params["embed"], tokens).to(torch.bfloat16)
    B, W = tokens.shape
    dev = x.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(B)
    n_real = torch.as_tensor(n_real, dtype=torch.int32, device=dev).reshape(B)
    x, _ = _run_stack(params, x, _positions(pos, B, W, dev), cfg, policy, impl=impl,
                      caches=caches, cache_pos=pos, attend_cached=True,
                      block_tables=block_tables)
    _scrub_lanes(caches, pos, n_real, W, block_tables, page_size)
    return x, n_real


def _scrub_lanes(caches: list, pos: torch.Tensor, n_real: torch.Tensor, W: int,
                 block_tables: Optional[torch.Tensor], page_size: Optional[int]) -> None:
    """Zero every row a mixed step wrote past each lane's real tokens, in
    place and without waiting for the card: a row that must keep its bytes
    is written back with its own value (one value per index, so the
    ``index_put_`` is deterministic)."""
    dev = pos.device
    if block_tables is None:
        rows, idx, src = row_window(pos, W, next(iter(caches[0].values())).shape[1])
        pad = src >= n_real.long()[:, None]
        for layer in caches:
            for a in layer.values():
                m = pad.reshape(*pad.shape, *([1] * (a.dim() - 2)))
                old = a[rows, idx]
                a[rows, idx] = old.masked_fill(m, 0)
        return
    nb = block_tables.shape[1]
    row_idx = pos.long()[:, None] + torch.arange(W, device=dev)[None]  # (B, W)
    pad = torch.arange(W, device=dev)[None] >= n_real.long()[:, None]
    blk, off = row_idx // page_size, row_idx % page_size
    page = block_tables.long().gather(1, blk.clamp(max=nb - 1))
    scrub = pad & (blk < nb) & (page != 0)
    # a row that keeps its bytes is sent to the scratch page and written
    # back there with its own value; no scrubbed row touches that page
    page = torch.where(scrub, page, torch.zeros_like(page))
    for layer in caches:
        for a in layer.values():
            m = scrub.reshape(*scrub.shape, *([1] * (a.dim() - 2)))
            a[page, off] = a[page, off].masked_fill(m, 0)
