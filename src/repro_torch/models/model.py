"""Architecture assembly for serving, dense family (counterpart of
``repro.models.model``).

Params are plain nested dicts of tensors: ``embed``, ``final_norm``,
``head`` and ``layers``, a list with one block dict per layer (the
reference stacks layers on a leading scan axis; the port loops over them).
Caches are a list with one dict per layer, ``{"k", "k_s", "v", "v_s"}``:
dense (n_slots, s_max, Hkv, hd/r) stripes, or a shared (n_pages,
page_size, Hkv, hd/r) pool addressed by block tables. Caches are written in
place.

Every projection routes through ``core.linear`` under the active
PrecisionPolicy. Ported: serve-mode ``init_params``, ``init_cache``,
``init_paged_cache``, ``decode_step``, ``prefill_chunk``,
``prefill_into_slot``, ``prefill_into_pages`` and greedy ``sample_tokens``.
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
from repro_torch.models.attention import AttnCfg, attn_apply, attn_init, cache_init
from repro_torch.models.common import NORMS, embed_apply, embed_init
from repro_torch.models.ffn import MLPCfg, mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # the port serves "dense"
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
    def mlp_cfg(self) -> MLPCfg:
        return MLPCfg(self.d_model, self.d_ff, self.act, gated=self.act != "gelu")


#: Families the port can prefill in chunks and page (the reference also
#: covers moe / mla_moe / vlm; those families are not ported yet).
PREFILL_CHUNKABLE_FAMILIES = ("dense",)
PAGEABLE_FAMILIES = ("dense",)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (dense only)")


def init_params(gen: torch.Generator, cfg: ArchConfig, policy: PrecisionPolicy, *,
                device=None, dtype=torch.bfloat16) -> dict:
    """Serve-mode params with placeholder weights drawn from ``gen`` (a
    ``torch.Generator`` on ``device``; None means CUDA)."""
    _check_family(cfg)
    device = resolve_device(device)
    dispatch.ensure_policy_supported(policy)
    ninit, _ = NORMS[cfg.norm]
    params: dict = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, device=device, dtype=dtype),
        "final_norm": ninit(cfg.d_model, device=device),
        "head": linear_init(gen, cfg.d_model, cfg.vocab_padded, policy.of("head"),
                            device=device, dtype=dtype),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "norm1": ninit(cfg.d_model, device=device),
            "norm2": ninit(cfg.d_model, device=device),
            "attn": attn_init(gen, cfg.attn_cfg, policy, device=device, dtype=dtype),
            "mlp": mlp_init(gen, cfg.mlp_cfg, policy, device=device, dtype=dtype),
        })
    return params


def _run_stack(params, x, pos, cfg: ArchConfig, policy, *, impl, caches, cache_pos,
               attend_cached=False, block_tables=None, fused_attn=False):
    _, nfn = NORMS[cfg.norm]
    for lp, cache in zip(params["layers"], caches):
        h = nfn(lp["norm1"], x)
        a, _ = attn_apply(lp["attn"], h, pos, cfg.attn_cfg, policy, impl=impl, cache=cache,
                          cache_pos=cache_pos, attend_cached=attend_cached,
                          block_table=block_tables, fused=fused_attn)
        x = x + a
        h = nfn(lp["norm2"], x)
        x = x + mlp_apply(lp["mlp"], h, cfg.mlp_cfg, policy, impl=impl)
    return x


def init_cache(cfg: ArchConfig, policy: PrecisionPolicy, batch: int, s_max: int, *,
               device=None) -> list:
    """Per-layer dense caches (``device`` None means CUDA)."""
    _check_family(cfg)
    device = resolve_device(device)
    return [cache_init(batch, s_max, cfg.kv_heads, cfg.head_dim, policy.kv_cache_bits,
                       device=device) for _ in range(cfg.n_layers)]


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
