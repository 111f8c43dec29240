"""GQA and MLA attention with RoPE and a quantized KV cache, serving paths
only (counterpart of ``repro.models.attention``).

Layouts: activations (B, S, D); per-head tensors (B, S, H, hd); dense KV
caches (B, S_max, Hkv, hd/r) int8 with per-(token, head) f32 scales, or a
page pool (n_pages, page_size, Hkv, hd/r) addressed through block tables.
MLA caches hold the compressed latent ``c`` (B, S_max, 1, kv_lora/r) with
its scales ``c_s`` (B, S_max, 1) and the shared rope key ``r`` (B, S_max,
1, d_rope) bf16, dense or pooled the same way.

Ported branches of :func:`attn_apply`: whole-sequence attention without a
cache and whole-prompt prefill into a dense cache (both through the
flash_mha kernel, over the fresh k/v), fused single-token decode (the
paged_attn kernel, dense or paged cache) and the one-pass softmax through
the dequantized cache (unfused decode, and ``attend_cached`` chunked
prefill); a paged cache is read for it through the paged_gather kernel.
:func:`mla_apply` has the two decode-side serve branches: fused absorbed
decode through the paged_mla_attn kernel, and the absorbed softmax over the
dequantized latents. Its whole-sequence branch raises: the reference calls
``flash_attention`` there with a value head of d_v = 128 against a
query/key head of d_nope + d_rope = 192, which ``flash_mha_pallas`` (its
``v`` block takes the key's width) cannot compute either.

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


# ------------------------------------------ whole-sequence (flash) attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: ops.Impl = "auto") -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype,
    through the flash_mha kernel (its plain version on CPU tensors). The
    math is f32; the result is cast to q's dtype, as in the reference."""
    return ops.flash_mha(q, k, v, causal=causal, window=window, impl=impl).to(q.dtype)


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


def seq_insert(bufs, news, pos, *, block_table: Optional[torch.Tensor] = None,
               impl: ops.Impl = "auto") -> None:
    """Write each ``news[i]`` (B, S_new, ...) into ``bufs[i]`` at sequence
    positions ``pos`` ((B,) int32, one offset per row; (1,) broadcasts), in
    place. The leaves share ``pos``, so its (B,) vector is built once.

    Dense layout: each buffer is (B, S_max, ...); per-row writes past S_max
    are DROPPED, never clamped (the reference's vector-``pos`` path, which
    every serving caller takes: a mixed step's right-padded tail near
    capacity must not land on the slot's real last row). The write never
    waits for the card (see :func:`row_window`). Paged layout
    (``block_table`` given): each buffer is a page pool and the leaves are
    written by one paged_scatter launch; rows on unallocated blocks land in
    the scratch page 0."""
    B, S_new = news[0].shape[:2]
    dev = bufs[0].device
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    news = [new.to(buf.dtype) for buf, new in zip(bufs, news)]
    if block_table is not None:
        ops.paged_scatter_leaves(bufs, news, pos_b.contiguous(), block_table, impl=impl)
        return
    rows, idx, src = row_window(pos_b, S_new, bufs[0].shape[1])
    fresh = src >= 0
    take = src.clamp(min=0)
    for buf, new in zip(bufs, news):
        m = fresh.reshape(*fresh.shape, *([1] * (new.dim() - 2)))
        buf[rows, idx] = torch.where(m, new[rows, take], buf[rows, idx])


def row_window(pos_b: torch.Tensor, S: int, s_max: int):
    """The dense cache rows a write of ``S`` rows at ``pos_b`` ((B,)) may
    touch, as a window of ``L = min(S, s_max)`` distinct in-range rows per
    slot: ``idx`` (B, L) starts at ``min(pos_b, s_max - L)``, and ``src``
    (B, L) is each row's offset in the write (``idx - pos_b``; negative for
    a row before the write, which keeps its bytes). Rows of the write past
    ``s_max`` are in no window: they are dropped. Each index appears once
    per slot, so an ``index_put_`` over the window is deterministic, and no
    boolean mask (a ``nonzero``, which waits for the card) is needed.
    Returns (rows (B, 1), idx, src), int64."""
    B = pos_b.shape[0]
    dev = pos_b.device
    L = min(S, s_max)
    p = pos_b.long()
    idx = p.clamp(max=s_max - L)[:, None] + torch.arange(L, device=dev)[None]
    return torch.arange(B, device=dev)[:, None], idx, idx - p[:, None]


def cache_update(cache: dict, k: torch.Tensor, v: torch.Tensor, pos, bits: Optional[int], *,
                 block_table: Optional[torch.Tensor] = None,
                 impl: ops.Impl = "auto") -> dict:
    """Insert new k/v (B, S_new, H, D) at ``pos`` (in place)."""
    kq, ks = kv_quantize(k, bits)
    vq, vs = kv_quantize(v, bits)
    names, news = ["k", "v"], [kq, vq]
    if bits is not None:
        names, news = names + ["k_s", "v_s"], news + [ks, vs]
    seq_insert([cache[n] for n in names], news, pos, block_table=block_table, impl=impl)
    return cache


def cache_read(cache: dict, bits: Optional[int], *,
               block_table: Optional[torch.Tensor] = None, impl: ops.Impl = "auto"):
    """Dequantized K/V, (B, S, Hkv, D) bf16. Dense: the (B, S_max, ...)
    buffers as stored. Paged: the pool leaves are first gathered through
    the block table (one paged_gather launch for all of them) into
    contiguous (B, n_blocks * page_size, ...) logical rows at stored width
    (int8 / packed / f32 scales, never bf16), then dequantized; gather and
    dequantize commute elementwise, so the result is bit-identical to
    reading a dense cache holding the same rows."""
    kq, ks = cache["k"], cache.get("k_s")
    vq, vs = cache["v"], cache.get("v_s")
    if block_table is not None:
        if ks is None:
            kq, vq = ops.paged_gather_leaves([kq, vq], block_table, impl=impl)
        else:
            kq, vq, ks, vs = ops.paged_gather_leaves([kq, vq, ks, vs], block_table, impl=impl)
    return kv_dequantize(kq, ks, bits), kv_dequantize(vq, vs, bits)


# ----------------------------------------------------------------- GQA block


def attn_init(gen: torch.Generator, cfg: AttnCfg, policy: PrecisionPolicy, *,
              mode: str = "serve", device, dtype=torch.float32) -> dict:
    lp_qkv, lp_out = policy.of("attn_qkv"), policy.of("attn_out")
    kw = dict(mode=mode, device=device, dtype=dtype)
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
    """Returns (y, cache). Without a cache the whole sequence attends
    causally through the flash_mha kernel. With a dense cache and S > 1
    (not ``attend_cached``) this is whole-prompt prefill: the quantized k/v
    are written at ``cache_pos`` and the attention runs over the fresh bf16
    k/v, not the dequantized cache, as in the reference; a paged cache
    refuses it. ``fused`` routes single-token decode through the paged_attn
    kernel (dense or paged cache); otherwise the step attends through the
    dequantized cache in one softmax pass (a paged cache is gathered into
    logical rows first), which is also the ``attend_cached`` path of chunked
    prefill, of a continuous mixed step and of a speculative verify. Its
    f32 products go through ``ops.rowinv_einsum``: on the card a query row
    gets the same bits whatever number of rows the step computes (a decode
    step's one, a mixed step's or a verify's window), so those engines
    emit the serialized engine's tokens; on the CPU they are the einsums
    themselves."""
    B, S, _ = x.shape
    lp_qkv, lp_out = policy.of("attn_qkv"), policy.of("attn_out")
    q = linear_apply(params["wq"], x, lp_qkv, impl=impl).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = linear_apply(params["wk"], x, lp_qkv, impl=impl).reshape(B, S, cfg.kv_heads, cfg.head_dim)
    v = linear_apply(params["wv"], x, lp_qkv, impl=impl).reshape(B, S, cfg.kv_heads, cfg.head_dim)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    prefill = cache is not None and S > 1 and not attend_cached
    if block_table is not None and prefill:
        raise NotImplementedError(
            "whole-sequence prefill over a paged cache is unsupported: prefill through "
            "model.prefill_into_pages (chunked) or decode token by token")
    fused_decode = fused and cache is not None and S == 1
    bits = policy.kv_cache_bits
    if cache is not None:
        pos_b = torch.as_tensor(cache_pos, dtype=torch.int32,
                                device=x.device).reshape(-1).expand(B)
        cache = cache_update(cache, k, v, pos_b, bits, block_table=block_table, impl=impl)

    if cache is None or prefill:
        y = flash_attention(q, k, v, causal=True, window=cfg.window, impl=impl)
    elif fused_decode:
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
        kk, vv = kk.to(torch.float32), vv.to(torch.float32)
        k_idx = torch.arange(kd.shape[1], device=x.device)
        qpos = pos_b[:, None] + torch.arange(S, device=x.device)[None]  # (B, S)

        s = ops.rowinv_einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kk, impl=impl)
        s = s / (cfg.head_dim**0.5)
        valid = k_idx[None, None, :] <= qpos[:, :, None]  # (B, S, Sk)
        if cfg.window is not None:
            valid &= (qpos[:, :, None] - k_idx[None, None, :]) < cfg.window
        s = s.masked_fill(~valid[:, None], BIG_NEG)
        p = torch.softmax(s, dim=-1)
        y = ops.rowinv_einsum("bhqk,bkhd->bqhd", p, vv, impl=impl).to(x.dtype)

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
             mode: str = "serve", device, dtype=torch.float32) -> dict:
    lp, lp_out = policy.of("attn_qkv"), policy.of("attn_out")
    H = cfg.n_heads
    kw = dict(mode=mode, device=device, dtype=dtype)
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
    absorbed einsums of the reference, through ``ops.rowinv_einsum`` as in
    :func:`attn_apply`."""
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

    if cache is None or (S > 1 and not attend_cached):
        raise NotImplementedError(
            "whole-sequence MLA (forward, prefill_step) is not ported: the reference attends "
            f"there with a value head of d_v = {cfg.d_v} against a query/key head of "
            f"d_nope + d_rope = {cfg.d_nope + cfg.d_rope}, which flash_mha_pallas (its v block "
            "takes the key's width) cannot compute either; prefill in chunks")
    bits = policy.kv_cache_bits
    pos_b = torch.as_tensor(cache_pos, dtype=torch.int32, device=x.device).reshape(-1).expand(B)
    ckv_q, ckv_s = kv_quantize(c_kv[:, :, None, :], bits)
    names, news = ["c", "r"], [ckv_q, k_rope]
    if bits is not None:
        names, news = ["c", "c_s", "r"], [ckv_q, ckv_s, k_rope]
    seq_insert([cache[n] for n in names], news, pos_b, block_table=block_table, impl=impl)

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
            # gather latent pages at stored (packed) width in one launch,
            # dequantize after
            if c_s is None:
                c_buf, r_all = ops.paged_gather_leaves([c_buf, r_all], block_table, impl=impl)
            else:
                c_buf, c_s, r_all = ops.paged_gather_leaves([c_buf, c_s, r_all], block_table,
                                                            impl=impl)
        c_all = kv_dequantize(c_buf, c_s, bits)[:, :, 0].to(torch.float32)
        r_f = r_all.to(torch.float32)[:, :, 0]
        t_idx = torch.arange(c_all.shape[1], device=x.device)
        qpos = pos_b[:, None] + torch.arange(S, device=x.device)[None]  # (B, S)

        q_lat = ops.rowinv_einsum("bshd,hdc->bshc", q_nope.to(torch.float32), w_uk, impl=impl)
        s_lat = ops.rowinv_einsum("bshc,btc->bhst", q_lat, c_all, impl=impl)
        # rope score: every head shares the single rope key
        s_rope = ops.rowinv_einsum("bshd,btd->bhst", q_rope.to(torch.float32), r_f, impl=impl)
        s = (s_lat + s_rope) / ((cfg.d_nope + cfg.d_rope) ** 0.5)
        valid = t_idx[None, None, :] <= qpos[:, :, None]
        s = s.masked_fill(~valid[:, None], BIG_NEG)
        p = torch.softmax(s, dim=-1)
        ctx = ops.rowinv_einsum("bhst,btc->bshc", p, c_all, impl=impl)
        y = ops.rowinv_einsum("bshc,hdc->bshd", ctx, w_uv, impl=impl).to(x.dtype)  # (B,S,H,d_v)

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
