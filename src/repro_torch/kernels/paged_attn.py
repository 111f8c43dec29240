"""Fused paged-attention decode (counterpart of ``repro.kernels.paged_attn``):
the GQA variant and the absorbed MLA variant, each a CUDA kernel's wrapper
and its plain PyTorch version.

One query token per slot attends over K/V pages ``(P, ps, Hkv, D/r)`` plus
per-(token, head) scales, walking the slot's block-table row. Dequantization
rounds through bf16 (``(int * scale) -> bf16 -> f32``) to match
``models.attention.kv_dequantize``; masked probabilities are exactly 0.0.
The plain version mirrors the reference twin's page-blocked running softmax
step for step; the kernel (``csrc/paged_attn.cu``) follows the same steps,
so the two differ only in the order of the float sums inside a dot.

The MLA variant (``paged_mla_attn``, kernel ``csrc/paged_mla_attn.cu``)
scores every head's absorbed query against the compressed latent pages
``c`` (one shared latent row per token) plus the shared rope key ``r``,
``s = (q_lat . c + q_rope . r) * scale``, and accumulates the context in
latent space: ``(B, H, kv_lora)``, to which the caller applies W_uv.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import pack as P
from repro_torch.kernels import build

BIG_NEG = -2.0e9
_BITS_CODE = {None: 16, 8: 8, 4: 4}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_void_p])


def _dequant(qv: torch.Tensor, sc: Optional[torch.Tensor], bits: Optional[int]) -> torch.Tensor:
    if bits is None:
        return qv.to(torch.float32)
    if bits < 8:
        qv = P.unpack(qv, bits, signed=True)
    x = qv.to(torch.float32) * sc[..., None]
    return x.to(torch.bfloat16).to(torch.float32)


def paged_attn_ref(q, k, k_s, v, v_s, pos, block_table, *,
                   bits: Optional[int], window: Optional[int] = None) -> torch.Tensor:
    """The same page-blocked running softmax as the kernel, vectorized over
    (slot, kv head). Returns (B, Hq, D) f32."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k.shape
    G = Hq // Hkv
    NB = block_table.shape[1]
    scale = 1.0 / (D**0.5)
    q4 = q.reshape(B, Hkv, G, D).to(torch.float32)
    pos = pos.to(torch.int32).reshape(B)
    bt = block_table.long()
    m = torch.full((B, Hkv, G), BIG_NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    ar = torch.arange(ps, dtype=torch.int32, device=q.device)
    for j in range(NB):
        pages = bt[:, j]
        kf = _dequant(k[pages], None if bits is None else k_s[pages], bits)
        vf = _dequant(v[pages], None if bits is None else v_s[pages], bits)
        s = torch.matmul(q4, kf.permute(0, 2, 3, 1)) * scale  # (B, Hkv, G, ps)
        kpos = j * ps + ar
        valid = kpos[None] <= pos[:, None]  # (B, ps)
        if window is not None:
            valid &= (pos[:, None] - kpos[None]) < window
        vmask = valid[:, None, None, :]
        s = torch.where(vmask, s, torch.tensor(BIG_NEG, dtype=torch.float32, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(vmask, torch.exp(s - m_new[..., None]),
                        torch.zeros((), dtype=torch.float32, device=q.device))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vf.permute(0, 2, 1, 3))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, D)


def paged_attn_cuda(q, k, k_s, v, v_s, pos, block_table, *,
                    bits: Optional[int], window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel. q (B, Hq, D) f32; k/v (P, ps, Hkv, D/r) int8
    (bf16 when ``bits`` is None); k_s/v_s (P, ps, Hkv) f32; pos (B,) int32;
    block_table (B, NB) int32. Returns (B, Hq, D) f32."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attn_cuda needs CUDA tensors, got {dev}")
    B, Hq, D = q.shape
    P_, ps, Hkv, Dr = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    r = 1 if bits is None else P.pack_ratio(bits)
    if Dr * r != D:
        raise ValueError(f"packed head dim {Dr} does not match D={D} at bits={bits}")
    build.check_tensor(q, "q", torch.float32, dev)
    kv_dtype = torch.bfloat16 if bits is None else torch.int8
    build.check_tensor(k, "k", kv_dtype, dev)
    build.check_tensor(v, "v", kv_dtype, dev, k.shape)
    if bits is not None:
        build.check_tensor(k_s, "k_s", torch.float32, dev, (P_, ps, Hkv))
        build.check_tensor(v_s, "v_s", torch.float32, dev, (P_, ps, Hkv))
    build.check_tensor(pos, "pos", torch.int32, dev, (B,))
    build.check_tensor(block_table, "block_table", torch.int32, dev)
    if block_table.shape[0] != B:
        raise ValueError(f"block_table rows {block_table.shape[0]} != B={B}")
    NB = block_table.shape[1]
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    fn = build.lib("paged_attn").paged_attn_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(),
             k_s.data_ptr() if bits is not None else None, v.data_ptr(),
             v_s.data_ptr() if bits is not None else None, pos.data_ptr(),
             block_table.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, ps, NB,
             _BITS_CODE[bits], 0 if window is None else int(window),
             1.0 / (D**0.5), build.stream_ptr(dev))
    build.check(err, "paged_attn_launch")
    build.LAUNCHES["paged_attn"] += 1
    return out


# ---------------------------------------------------- MLA absorbed decode

_MLA_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float]
                 + [ctypes.c_void_p])


def paged_mla_attn_ref(q_lat, q_rope, c, c_s, r, pos, block_table, *,
                       bits: Optional[int], scale: float) -> torch.Tensor:
    """The reference twin's page-blocked running softmax, step for step,
    vectorized over (slot, head). Returns the latent context (B, H, C) f32."""
    B, H, C = q_lat.shape
    ps = c.shape[1]
    NB = block_table.shape[1]
    ql = q_lat.to(torch.float32)
    qr = q_rope.to(torch.float32)
    pos = pos.to(torch.int32).reshape(B)
    bt = block_table.long()
    m = torch.full((B, H), BIG_NEG, dtype=torch.float32, device=ql.device)
    l = torch.zeros((B, H), dtype=torch.float32, device=ql.device)
    acc = torch.zeros((B, H, C), dtype=torch.float32, device=ql.device)
    ar = torch.arange(ps, dtype=torch.int32, device=ql.device)
    for j in range(NB):
        pages = bt[:, j]
        cf = _dequant(c[pages][:, :, 0], None if bits is None else c_s[pages][:, :, 0], bits)
        rf = r[pages][:, :, 0].to(torch.float32)  # (B, ps, dr)
        s = (torch.matmul(ql, cf.transpose(1, 2)) + torch.matmul(qr, rf.transpose(1, 2))) * scale
        kpos = j * ps + ar
        vmask = (kpos[None] <= pos[:, None])[:, None, :]  # (B, 1, ps)
        s = torch.where(vmask, s, torch.tensor(BIG_NEG, dtype=torch.float32, device=ql.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(vmask, torch.exp(s - m_new[..., None]),
                        torch.zeros((), dtype=torch.float32, device=ql.device))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, cf)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def paged_mla_attn_cuda(q_lat, q_rope, c, c_s, r, pos, block_table, *,
                        bits: Optional[int], scale: float) -> torch.Tensor:
    """Launch the CUDA kernel. q_lat (B, H, C) f32; q_rope (B, H, dr) f32;
    c (P, ps, 1, C/r) int8 (bf16 when ``bits`` is None); c_s (P, ps, 1) f32;
    r (P, ps, 1, dr) bf16; pos (B,) int32; block_table (B, NB) int32.
    Returns (B, H, C) f32."""
    dev = q_lat.device
    if dev.type != "cuda":
        raise ValueError(f"paged_mla_attn_cuda needs CUDA tensors, got {dev}")
    B, H, C = q_lat.shape
    dr = q_rope.shape[-1]
    P_, ps, one, Cr = c.shape
    rr = 1 if bits is None else P.pack_ratio(bits)
    if one != 1 or Cr * rr != C:
        raise ValueError(f"latent pages {tuple(c.shape)} do not hold C={C} at bits={bits}")
    build.check_tensor(q_lat, "q_lat", torch.float32, dev)
    build.check_tensor(q_rope, "q_rope", torch.float32, dev, (B, H, dr))
    build.check_tensor(c, "c", torch.bfloat16 if bits is None else torch.int8, dev)
    if bits is not None:
        build.check_tensor(c_s, "c_s", torch.float32, dev, (P_, ps, 1))
    build.check_tensor(r, "r", torch.bfloat16, dev, (P_, ps, 1, dr))
    build.check_tensor(pos, "pos", torch.int32, dev, (B,))
    build.check_tensor(block_table, "block_table", torch.int32, dev)
    if block_table.shape[0] != B:
        raise ValueError(f"block_table rows {block_table.shape[0]} != B={B}")
    # the kernel stages pages with 16-byte loads: rows of whole 16-byte vectors
    if (C * _BITS_CODE[bits]) % 128 or dr % 8 or c.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError(f"paged_mla_attn_cuda needs 16-byte latent and rope rows and pools "
                         f"(C={C} at bits={bits}, dr={dr})")
    NB = block_table.shape[1]
    out = torch.empty((B, H, C), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    fn = build.lib("paged_mla_attn").paged_mla_attn_launch
    fn.argtypes, fn.restype = _MLA_ARGTYPES, ctypes.c_int
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), c.data_ptr(),
             c_s.data_ptr() if bits is not None else None, r.data_ptr(), pos.data_ptr(),
             block_table.data_ptr(), out.data_ptr(), B, H, C, dr, ps, NB, _BITS_CODE[bits],
             float(scale), build.stream_ptr(dev))
    build.check(err, "paged_mla_attn_launch")
    build.LAUNCHES["paged_mla_attn"] += 1
    return out
