"""Architecture assembly for serving (counterpart of ``repro.models.model``):
the dense family, and the MLA layers of the mla_moe family.

Params are plain nested dicts of tensors: ``embed``, ``final_norm``,
``head`` and ``layers``, a list with one block dict per layer (the
reference stacks layers on a leading scan axis; the port loops over them),
plus ``mtp_block`` / ``mtp_proj`` / ``mtp_norm`` when ``cfg.mtp`` (the
reference's training-only multi-token-prediction head; serving never reads
them). Each layer's kind (``dense`` or ``mla_dense``) follows from the
config (:func:`_layer_kinds`). Caches are a list with one dict per layer:
``{"k", "k_s", "v", "v_s"}`` for GQA layers, ``{"c", "c_s", "r"}`` for MLA
layers; dense (n_slots, s_max, ...) stripes, or a shared (n_pages,
page_size, ...) pool addressed by block tables. Caches are written in
place.

Every projection routes through ``core.linear`` under the active
PrecisionPolicy. Ported: serve-mode ``init_params``, ``init_cache``,
``init_paged_cache``, ``decode_step``, ``prefill_chunk``,
``prefill_into_slot``, ``prefill_into_pages`` and greedy ``sample_tokens``.
Mixture-of-Experts layers (``mla_moe``, the moe family) are not ported:
a config that has one raises at ``init_params`` / ``init_cache``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
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
)
from repro_torch.models.common import NORMS, embed_apply, embed_init
from repro_torch.models.ffn import MLPCfg, mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # the port serves "dense" and the MLA layers of "mla_moe"
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


#: Families the port can prefill in chunks and page (the reference also
#: covers moe and vlm; those families are not ported yet). An mla_moe
#: config is served when all its layers are MLA-dense (see _check_family).
PREFILL_CHUNKABLE_FAMILIES = ("dense", "mla_moe")
PAGEABLE_FAMILIES = ("dense", "mla_moe")
#: layer kinds the port builds
PORTED_KINDS = ("dense", "mla_dense")


def _layer_kinds(cfg: ArchConfig) -> list[str]:
    """Per-layer block kind (the reference's ``_layer_kinds``, for the
    families the port knows)."""
    if cfg.family == "dense":
        return ["dense"] * cfg.n_layers
    if cfg.family == "mla_moe":
        return (["mla_dense"] * cfg.dense_layers
                + ["mla_moe"] * (cfg.n_layers - cfg.dense_layers))
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def _check_family(cfg: ArchConfig) -> list[str]:
    """The layer kinds of ``cfg``; raises if one is not ported (an
    ``mla_moe`` layer needs the MoE feed-forward: never a dense stand-in)."""
    kinds = _layer_kinds(cfg)
    missing = sorted(set(kinds) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: layer kind(s) {missing} are not ported yet (Mixture-of-Experts); "
            f"the port builds {PORTED_KINDS}")
    return kinds


def _mlp_cfg(cfg: ArchConfig, kind: str) -> MLPCfg:
    if kind == "mla_dense":  # deepseek dense layers: d_ff 18432 = 9 * 2048
        return MLPCfg(cfg.d_model, cfg.d_ff * 9, cfg.act)
    return cfg.mlp_cfg


def _block_init(gen, cfg: ArchConfig, policy, kind: str, device, dtype) -> dict:
    ninit, _ = NORMS[cfg.norm]
    kw = dict(device=device, dtype=dtype)
    attn = (mla_init(gen, cfg.mla_cfg, policy, **kw) if kind == "mla_dense"
            else attn_init(gen, cfg.attn_cfg, policy, **kw))
    return {
        "norm1": ninit(cfg.d_model, device=device),
        "norm2": ninit(cfg.d_model, device=device),
        "attn": attn,
        "mlp": mlp_init(gen, _mlp_cfg(cfg, kind), policy, **kw),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig, policy: PrecisionPolicy, *,
                device=None, dtype=torch.bfloat16) -> dict:
    """Serve-mode params with placeholder weights drawn from ``gen`` (a
    ``torch.Generator`` on ``device``; None means CUDA)."""
    kinds = _check_family(cfg)
    device = resolve_device(device)
    dispatch.ensure_policy_supported(policy)
    ninit, _ = NORMS[cfg.norm]
    params: dict = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, device=device, dtype=dtype),
        "final_norm": ninit(cfg.d_model, device=device),
        "head": linear_init(gen, cfg.d_model, cfg.vocab_padded, policy.of("head"),
                            device=device, dtype=dtype),
        "layers": [_block_init(gen, cfg, policy, kind, device, dtype) for kind in kinds],
    }
    if cfg.mtp:
        params["mtp_block"] = _block_init(gen, cfg, policy, "mla_dense", device, dtype)
        params["mtp_proj"] = linear_init(gen, 2 * cfg.d_model, cfg.d_model, policy.of("head"),
                                         device=device, dtype=dtype)
        params["mtp_norm"] = ninit(cfg.d_model, device=device)
    return params


def _run_stack(params, x, pos, cfg: ArchConfig, policy, *, impl, caches, cache_pos,
               attend_cached=False, block_tables=None, fused_attn=False):
    _, nfn = NORMS[cfg.norm]
    kw = dict(impl=impl, cache_pos=cache_pos, attend_cached=attend_cached,
              block_table=block_tables, fused=fused_attn)
    for lp, cache, kind in zip(params["layers"], caches, _layer_kinds(cfg), strict=True):
        h = nfn(lp["norm1"], x)
        if kind == "mla_dense":
            a, _ = mla_apply(lp["attn"], h, pos, cfg.mla_cfg, policy, cache=cache, **kw)
        else:
            a, _ = attn_apply(lp["attn"], h, pos, cfg.attn_cfg, policy, cache=cache, **kw)
        x = x + a
        h = nfn(lp["norm2"], x)
        x = x + mlp_apply(lp["mlp"], h, _mlp_cfg(cfg, kind), policy, impl=impl)
    return x


def init_cache(cfg: ArchConfig, policy: PrecisionPolicy, batch: int, s_max: int, *,
               device=None) -> list:
    """Per-layer dense caches (``device`` None means CUDA): K/V leaves for
    GQA layers, latent ``c`` / ``c_s`` / ``r`` leaves for MLA layers."""
    kinds = _check_family(cfg)
    device = resolve_device(device)
    bits = policy.kv_cache_bits
    return [mla_cache_init(batch, s_max, cfg.mla_cfg, bits, device=device) if kind == "mla_dense"
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
    x = _run_stack(params, x, pos_ids, cfg, policy, impl=impl, caches=caches, cache_pos=pos,
                   block_tables=block_tables, fused_attn=fused_attn)
    x = nfn(params["final_norm"], x)
    return linear_apply(params["head"], x, policy.of("head"), impl=impl)


def sample_tokens(logits: torch.Tensor, temps, top_k=None, top_p=None, seeds=None,
                  counters=None) -> torch.Tensor:
    """The batched per-slot sampler, greedy lanes only: argmax over the
    (padded) vocabulary in f32, first maximum on ties (as ``jnp.argmax``).
    ``temps`` is the host (B,) vector; a lane with temperature > 0 raises."""
    if np.any(np.asarray(temps) > 0):
        raise NotImplementedError(
            "stochastic sampling (temperature > 0) is not ported yet: ROADMAP "
            "Queue 1 item 8, seeded sampling")
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


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
    x = _run_stack(params, x, pos_ids, cfg, policy, impl=impl, caches=caches, cache_pos=pos,
                   attend_cached=True)
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
