"""GQA and MLA attention with RoPE and a quantized KV cache, serving paths
only (counterpart of ``repro.models.attention``).

Layouts: activations (B, S, D); per-head tensors (B, S, H, hd); dense KV
caches (B, S_max, Hkv, hd/r) int8 with per-(token, head) f32 scales, or a
page pool (n_pages, page_size, Hkv, hd/r) addressed through block tables.
MLA caches hold the compressed latent ``c`` (B, S_max, 1, kv_lora/r) with
its scales ``c_s`` (B, S_max, 1) and the shared rope key ``r`` (B, S_max,
1, d_rope) bf16, dense or pooled the same way.

Ported branches of :func:`attn_apply`: fused single-token decode (the
paged_attn kernel, dense or paged cache) and the one-pass softmax through
the dequantized cache (unfused decode, and ``attend_cached`` chunked
prefill); a paged cache is read for it through the paged_gather kernel.
:func:`mla_apply` has the same two serve branches: fused absorbed decode
through the paged_mla_attn kernel, and the absorbed softmax over the
dequantized latents. Whole-sequence (flash) attention is not ported yet.

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
from repro_torch.models.common import rms_norm, rms_norm_init

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


# ---------------------------------------------------------------- MLA block


@dataclasses.dataclass(frozen=True)
class MLACfg:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    rope_theta: float = 10_000.0


def mla_init(gen: torch.Generator, cfg: MLACfg, policy: PrecisionPolicy, *,
             device, dtype=torch.float32) -> dict:
    lp, lp_out = policy.of("attn_qkv"), policy.of("attn_out")
    H = cfg.n_heads
    kw = dict(device=device, dtype=dtype)
    return {
        "wq_a": linear_init(gen, cfg.d_model, cfg.q_lora, lp, **kw),
        "q_norm": rms_norm_init(cfg.q_lora, device),
        "wq_b": linear_init(gen, cfg.q_lora, H * (cfg.d_nope + cfg.d_rope), lp, **kw),
        "wkv_a": linear_init(gen, cfg.d_model, cfg.kv_lora + cfg.d_rope, lp, **kw),
        "kv_norm": rms_norm_init(cfg.kv_lora, device),
        "wkv_b": linear_init(gen, cfg.kv_lora, H * (cfg.d_nope + cfg.d_v), lp, **kw),
        "wo": linear_init(gen, H * cfg.d_v, cfg.d_model, lp_out, **kw),
    }


def _mla_wkv_b_dense(params: dict, lp) -> torch.Tensor:
    """W_kv_b (H*(d_nope+d_v), kv_lora) in f32 for the absorbed path
    (weight-only dequant when serving packed)."""
    p = params["wkv_b"]
    if "w_packed" in p:
        return P.unpack(p["w_packed"], lp.w_bits, signed=True).to(torch.float32) * p["eps_w"]
    return p["w"].to(torch.float32)


def mla_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d_model)
    pos: torch.Tensor,  # (B, S) int positions
    cfg: MLACfg,
    policy: PrecisionPolicy,
    *,
    impl: ops.Impl = "auto",
    cache: Optional[dict] = None,
    cache_pos=None,
    attend_cached: bool = False,
    block_table: Optional[torch.Tensor] = None,
    fused: bool = False,
):
    """MLA over the latent cache, serving branches. Returns (y, cache).

    The new token rows' latent ``c`` (quantized like a KV leaf) and rope key
    ``r`` are written first, in place. ``fused`` routes single-token decode
    through the paged_mla_attn kernel: it scores ``q_lat . c + q_rope . r``
    over the compressed pages and returns the context in latent space, to
    which W_uv is applied here. Otherwise (unfused decode, and the
    ``attend_cached`` chunks of prefill) the latents are dequantized (a
    paged cache gathered first through paged_gather) and attended with the
    absorbed einsums of the reference."""
    B, S, _ = x.shape
    H = cfg.n_heads
    lp, lp_out = policy.of("attn_qkv"), policy.of("attn_out")

    q = linear_apply(params["wq_b"], rms_norm(params["q_norm"], linear_apply(
        params["wq_a"], x, lp, impl=impl)), lp, impl=impl)
    q = q.reshape(B, S, H, cfg.d_nope + cfg.d_rope)
    q_nope, q_rope = q[..., :cfg.d_nope], q[..., cfg.d_nope:]
    kv_a = linear_apply(params["wkv_a"], x, lp, impl=impl)
    c_kv = rms_norm(params["kv_norm"], kv_a[..., :cfg.kv_lora])  # (B, S, kv_lora)
    k_rope = kv_a[..., cfg.kv_lora:].reshape(B, S, 1, cfg.d_rope)
    cos, sin = rope_cos_sin(pos, cfg.d_rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)

    if cache is None:
        raise NotImplementedError("whole-sequence (flash) MLA is not ported yet")
    if S > 1 and not attend_cached:
        raise NotImplementedError("whole-prompt prefill is not ported yet; prefill in chunks")
    bits = policy.kv_cache_bits
    pos_b = torch.as_tensor(cache_pos, dtype=torch.int32, device=x.device).reshape(-1).expand(B)
    pg = dict(block_table=block_table, impl=impl)
    ckv_q, ckv_s = kv_quantize(c_kv[:, :, None, :], bits)
    seq_insert(cache["c"], ckv_q, pos_b, **pg)
    if bits is not None:
        seq_insert(cache["c_s"], ckv_s, pos_b, **pg)
    seq_insert(cache["r"], k_rope, pos_b, **pg)

    wkv_b = _mla_wkv_b_dense(params, lp).reshape(H, cfg.d_nope + cfg.d_v, cfg.kv_lora)
    w_uk, w_uv = wkv_b[:, :cfg.d_nope, :], wkv_b[:, cfg.d_nope:, :]
    if fused and S == 1:
        q_lat = torch.einsum("bhd,hdc->bhc", q_nope[:, 0].to(torch.float32), w_uk)
        ctx = ops.paged_mla_attn(
            q_lat.contiguous(), q_rope[:, 0].to(torch.float32).contiguous(), cache["c"],
            cache.get("c_s"), cache["r"], pos_b.contiguous(), bits=bits,
            scale=1.0 / ((cfg.d_nope + cfg.d_rope) ** 0.5),
            block_table=block_table, impl=impl,
        )  # (B, H, kv_lora) latent context
        y = torch.einsum("bhc,hdc->bhd", ctx, w_uv)[:, None].to(x.dtype)
    else:
        c_buf, c_s, r_all = cache["c"], cache.get("c_s"), cache["r"]
        if block_table is not None:
            # gather latent pages at stored (packed) width, dequantize after
            c_buf = ops.paged_gather(c_buf, block_table, impl=impl)
            if c_s is not None:
                c_s = ops.paged_gather(c_s, block_table, impl=impl)
            r_all = ops.paged_gather(r_all, block_table, impl=impl)
        c_all = kv_dequantize(c_buf, c_s, bits)[:, :, 0].to(torch.float32)
        q_lat = torch.einsum("bshd,hdc->bshc", q_nope.to(torch.float32), w_uk)
        s_lat = torch.einsum("bshc,btc->bhst", q_lat, c_all)
        # rope score: every head shares the single rope key
        s_rope = torch.einsum("bshd,btd->bhst", q_rope.to(torch.float32),
                              r_all.to(torch.float32)[:, :, 0])
        s = (s_lat + s_rope) / ((cfg.d_nope + cfg.d_rope) ** 0.5)
        t_idx = torch.arange(c_all.shape[1], device=x.device)
        qpos = pos_b[:, None] + torch.arange(S, device=x.device)[None]  # (B, S)
        valid = t_idx[None, None, :] <= qpos[:, :, None]
        s = torch.where(valid[:, None], s,
                        torch.tensor(BIG_NEG, dtype=torch.float32, device=x.device))
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btc->bshc", p, c_all)
        y = torch.einsum("bshc,hdc->bshd", ctx, w_uv).to(x.dtype)  # (B, S, H, d_v)

    y = y.reshape(B, S, H * cfg.d_v)
    return linear_apply(params["wo"], y, lp_out, impl=impl), cache


def mla_cache_init(batch: int, s_max: int, cfg: MLACfg, bits: Optional[int], device) -> dict:
    r_shape = (batch, s_max, 1, cfg.d_rope)
    if bits is None:
        z = dict(dtype=torch.bfloat16, device=device)
        return {"c": torch.zeros((batch, s_max, 1, cfg.kv_lora), **z),
                "r": torch.zeros(r_shape, **z)}
    r = P.pack_ratio(bits)
    return {"c": torch.zeros((batch, s_max, 1, cfg.kv_lora // r), dtype=torch.int8, device=device),
            "c_s": torch.zeros((batch, s_max, 1), dtype=torch.float32, device=device),
            "r": torch.zeros(r_shape, dtype=torch.bfloat16, device=device)}
