"""GQA attention with RoPE and a quantized KV cache, serving paths only
(counterpart of ``repro.models.attention``).

Layouts: activations (B, S, D); per-head tensors (B, S, H, hd); dense KV
caches (B, S_max, Hkv, hd/r) int8 with per-(token, head) f32 scales, or a
page pool (n_pages, page_size, Hkv, hd/r) addressed through block tables.

Ported branches of :func:`attn_apply`: fused single-token decode (the
paged_attn kernel, dense or paged cache) and the one-pass softmax through
the dequantized cache (unfused decode, and ``attend_cached`` chunked
prefill); a paged cache is read for it through the paged_gather kernel.
Whole-sequence (flash) attention and MLA are not ported yet.

The port writes caches IN PLACE (the reference returns new arrays): a
cache dict's tensors are updated where they live and the dict is returned.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import pack as P
from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels import ops

BIG_NEG = -2.0e9


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: Optional[int] = None  # SWA
    rope_theta: float = 10_000.0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


# ------------------------------------------------------------------- RoPE


def rope_cos_sin(pos: torch.Tensor, head_dim: int, theta: float):
    """pos (B, S) -> cos/sin (B, S, head_dim/2), f32."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=pos.device) / half))
    ang = pos.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); half-rotation (llama-style), in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ------------------------------------------------------- quantized KV cache


def kv_quantize(x: torch.Tensor, bits: Optional[int]):
    """x (B, S, H, D) -> (storage, scales) with per-(token, head) symmetric
    scales; bits None -> bf16 passthrough; 4 -> packed two-per-byte."""
    if bits is None:
        return x.to(torch.bfloat16), None
    half = 1 << (bits - 1)
    amax = torch.amax(torch.abs(x.to(torch.float32)), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / (half - 1)
    q = torch.clamp(torch.round(x / scale), -half, half - 1).to(torch.int8)
    if bits < 8:
        q = P.pack(q, bits)
    return q, scale.squeeze(-1)  # (B, S, H, D/r), (B, S, H)


def kv_dequantize(q: torch.Tensor, scale: Optional[torch.Tensor], bits: Optional[int]):
    if bits is None:
        return q
    if bits < 8:
        q = P.unpack(q, bits, signed=True)
    return (q.to(torch.float32) * scale[..., None]).to(torch.bfloat16)


def cache_init(batch: int, s_max: int, kv_heads: int, head_dim: int,
               bits: Optional[int], device) -> dict:
    if bits is None:
        z = dict(dtype=torch.bfloat16, device=device)
        return {"k": torch.zeros((batch, s_max, kv_heads, head_dim), **z),
                "v": torch.zeros((batch, s_max, kv_heads, head_dim), **z)}
    r = P.pack_ratio(bits)
    shape_q = (batch, s_max, kv_heads, head_dim // r)
    shape_s = (batch, s_max, kv_heads)
    return {"k": torch.zeros(shape_q, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape_s, dtype=torch.float32, device=device),
            "v": torch.zeros(shape_q, dtype=torch.int8, device=device),
            "v_s": torch.zeros(shape_s, dtype=torch.float32, device=device)}


def seq_insert(buf: torch.Tensor, new: torch.Tensor, pos, *,
               block_table: Optional[torch.Tensor] = None,
               impl: ops.Impl = "auto") -> torch.Tensor:
    """Write ``new`` (B, S_new, ...) into ``buf`` at sequence positions
    ``pos`` ((B,) int32, one offset per row; (1,) broadcasts), in place.

    Dense layout: ``buf`` is (B, S_max, ...); per-row writes past S_max are
    DROPPED, never clamped (the reference's vector-``pos`` path, which every
    serving caller takes). Paged layout (``block_table`` given): ``buf`` is
    a page pool and the write routes through the paged_scatter kernel; rows
    on unallocated blocks land in the scratch page 0."""
    new = new.to(buf.dtype)
    B, S_new = new.shape[:2]
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=buf.device).reshape(-1).expand(B)
    if block_table is not None:
        return ops.paged_scatter(buf, new, pos_b.contiguous(), block_table, impl=impl)
    idx = pos_b.long()[:, None] + torch.arange(S_new, device=buf.device)[None]  # (B, S_new)
    keep = idx < buf.shape[1]
    rows = torch.arange(B, device=buf.device)[:, None].expand(B, S_new)
    buf[rows[keep], idx[keep]] = new[keep]
    return buf


def cache_update(cache: dict, k: torch.Tensor, v: torch.Tensor, pos, bits: Optional[int], *,
                 block_table: Optional[torch.Tensor] = None,
                 impl: ops.Impl = "auto") -> dict:
    """Insert new k/v (B, S_new, H, D) at ``pos`` (in place)."""
    kq, ks = kv_quantize(k, bits)
    vq, vs = kv_quantize(v, bits)
    pg = dict(block_table=block_table, impl=impl)
    seq_insert(cache["k"], kq, pos, **pg)
    seq_insert(cache["v"], vq, pos, **pg)
    if bits is not None:
        seq_insert(cache["k_s"], ks, pos, **pg)
        seq_insert(cache["v_s"], vs, pos, **pg)
    return cache


def cache_read(cache: dict, bits: Optional[int], *,
               block_table: Optional[torch.Tensor] = None, impl: ops.Impl = "auto"):
    """Dequantized K/V, (B, S, Hkv, D) bf16. Dense: the (B, S_max, ...)
    buffers as stored. Paged: each pool leaf is first gathered through the
    block table into contiguous (B, n_blocks * page_size, ...) logical rows
    at stored width (int8 / packed / f32 scales, never bf16), then
    dequantized; gather and dequantize commute elementwise, so the result is
    bit-identical to reading a dense cache holding the same rows."""
    kq, ks = cache["k"], cache.get("k_s")
    vq, vs = cache["v"], cache.get("v_s")
    if block_table is not None:
        kq = ops.paged_gather(kq, block_table, impl=impl)
        vq = ops.paged_gather(vq, block_table, impl=impl)
        if ks is not None:
            ks = ops.paged_gather(ks, block_table, impl=impl)
            vs = ops.paged_gather(vs, block_table, impl=impl)
    return kv_dequantize(kq, ks, bits), kv_dequantize(vq, vs, bits)


# ----------------------------------------------------------------- GQA block


def attn_init(gen: torch.Generator, cfg: AttnCfg, policy: PrecisionPolicy, *,
              device, dtype=torch.float32) -> dict:
    lp_qkv, lp_out = policy.of("attn_qkv"), policy.of("attn_out")
    kw = dict(device=device, dtype=dtype)
    return {
        "wq": linear_init(gen, cfg.d_model, cfg.q_dim, lp_qkv, bias=cfg.qkv_bias, **kw),
        "wk": linear_init(gen, cfg.d_model, cfg.kv_dim, lp_qkv, bias=cfg.qkv_bias, **kw),
        "wv": linear_init(gen, cfg.d_model, cfg.kv_dim, lp_qkv, bias=cfg.qkv_bias, **kw),
        "wo": linear_init(gen, cfg.q_dim, cfg.d_model, lp_out, **kw),
    }


def attn_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d_model)
    pos: torch.Tensor,  # (B, S) int positions
    cfg: AttnCfg,
    policy: PrecisionPolicy,
    *,
    impl: ops.Impl = "auto",
    cache: Optional[dict] = None,
    cache_pos=None,
    attend_cached: bool = False,
    block_table: Optional[torch.Tensor] = None,
    fused: bool = False,
):
    """Returns (y, cache). ``fused`` routes single-token decode through the
    paged_attn kernel (dense or paged cache); otherwise the step attends
    through the dequantized cache in one softmax pass (a paged cache is
    gathered into logical rows first), which is also the ``attend_cached``
    path of chunked prefill."""
    B, S, _ = x.shape
    lp_qkv, lp_out = policy.of("attn_qkv"), policy.of("attn_out")
    q = linear_apply(params["wq"], x, lp_qkv, impl=impl).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = linear_apply(params["wk"], x, lp_qkv, impl=impl).reshape(B, S, cfg.kv_heads, cfg.head_dim)
    v = linear_apply(params["wv"], x, lp_qkv, impl=impl).reshape(B, S, cfg.kv_heads, cfg.head_dim)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        raise NotImplementedError("whole-sequence (flash) attention is not ported yet")
    if S > 1 and not attend_cached:
        raise NotImplementedError("whole-prompt prefill is not ported yet; prefill in chunks")
    fused_decode = fused and S == 1
    bits = policy.kv_cache_bits
    pos_b = torch.as_tensor(cache_pos, dtype=torch.int32, device=x.device).reshape(-1).expand(B)
    cache = cache_update(cache, k, v, pos_b, bits, block_table=block_table, impl=impl)

    if fused_decode:
        y = ops.paged_attn(
            q[:, 0].to(torch.float32), cache["k"], cache.get("k_s"), cache["v"],
            cache.get("v_s"), pos_b.contiguous(), bits=bits, block_table=block_table,
            window=cfg.window, impl=impl,
        )[:, None].to(x.dtype)
    else:
        kd, vd = cache_read(cache, bits, block_table=block_table, impl=impl)
        groups = cfg.n_heads // kd.shape[2]
        kk = torch.repeat_interleave(kd, groups, dim=2) if groups > 1 else kd
        vv = torch.repeat_interleave(vd, groups, dim=2) if groups > 1 else vd
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kk.to(torch.float32))
        s = s / (cfg.head_dim**0.5)
        k_idx = torch.arange(kd.shape[1], device=x.device)
        qpos = pos_b[:, None] + torch.arange(S, device=x.device)[None]  # (B, S)
        valid = k_idx[None, None, :] <= qpos[:, :, None]  # (B, S, Sk)
        if cfg.window is not None:
            valid &= (qpos[:, :, None] - k_idx[None, None, :]) < cfg.window
        s = torch.where(valid[:, None], s,
                        torch.tensor(BIG_NEG, dtype=torch.float32, device=x.device))
        p = torch.softmax(s, dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", p, vv.to(torch.float32)).to(x.dtype)

    y = y.reshape(B, S, cfg.q_dim)
    return linear_apply(params["wo"], y, lp_out, impl=impl), cache
