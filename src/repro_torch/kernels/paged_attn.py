"""Fused paged-attention decode (counterpart of ``repro.kernels.paged_attn``):
the GQA variant and the absorbed MLA variant, each a CUDA kernel's wrapper
and its plain PyTorch version.

One query token per slot attends over K/V pages ``(P, ps, Hkv, D/r)`` plus
per-(token, head) scales, walking the slot's block-table row. Dequantization
rounds through bf16 (``(int * scale) -> bf16 -> f32``) to match
``models.attention.kv_dequantize``; masked probabilities are exactly 0.0.
The plain version mirrors the reference twin's page-blocked running softmax
step for step. The kernel (``csrc/paged_attn.cu``) splits the page walk
into runs of ``PAGES_PER_SPLIT`` pages, each with the same page-blocked
softmax from a fresh state, and merges the runs' partials in a fixed
order; ``paged_attn_split_ref`` repeats that order on the CPU (only tests
use it). Kernel and plain version differ by that merge and by the order of
the float sums inside a dot.

The MLA variant (``paged_mla_attn``, kernel ``csrc/paged_mla_attn.cu``)
scores every head's absorbed query against the compressed latent pages
``c`` (one shared latent row per token) plus the shared rope key ``r``,
``s = (q_lat . c + q_rope . r) * scale``, and accumulates the context in
latent space: ``(B, H, kv_lora)``, to which the caller applies W_uv. Its
kernel splits the page walk the same way (runs of ``MLA_PAGES_PER_SPLIT``
pages, ``MLA_HEADS_PER_BLOCK`` heads a block) and runs both products on the
tensor cores at f32 precision; ``paged_mla_attn_split_ref`` repeats that
order and arithmetic on the CPU (only tests use it).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core import pack as P
from repro_torch.kernels import build

BIG_NEG = -2.0e9
_BITS_CODE = {None: 16, 8: 8, 4: 4}
#: pages a block of the kernel walks before its partial goes to the merge:
#: the kernel's compile-time ``PPS`` (``csrc/paged_attn.cu``), mirrored here
#: to size the scratch; fixed, never from B, the SM count or pos, so a
#: slot's output depends on its own rows alone; 4 was fastest of 1, 2, 4, 8
#: and 16 at internlm2's kv8 decode shapes on an H100 (PERF.md, row 2)
PAGES_PER_SPLIT = 4
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.c_void_p])


def _dequant(qv: torch.Tensor, sc: Optional[torch.Tensor], bits: Optional[int]) -> torch.Tensor:
    if bits is None:
        return qv.to(torch.float32)
    if bits < 8:
        qv = P.unpack(qv, bits, signed=True)
    x = qv.to(torch.float32) * sc[..., None]
    return x.to(torch.bfloat16).to(torch.float32)


def _softmax_page(state, q4, k, k_s, v, v_s, pages, kpos, pos, *, bits: Optional[int],
                  window: Optional[int], scale: float):
    """One page of the running softmax over rows ``kpos`` of pool pages
    ``pages`` (one a slot): state (m, l, acc) -> the next."""
    m, l, acc = state
    dev = q4.device
    kf = _dequant(k[pages], None if bits is None else k_s[pages], bits)
    vf = _dequant(v[pages], None if bits is None else v_s[pages], bits)
    s = torch.matmul(q4, kf.permute(0, 2, 3, 1)) * scale  # (B, Hkv, G, ps)
    valid = kpos[None] <= pos[:, None]  # (B, ps)
    if window is not None:
        valid &= (pos[:, None] - kpos[None]) < window
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.tensor(BIG_NEG, dtype=torch.float32, device=dev))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(vmask, torch.exp(s - m_new[..., None]),
                    torch.zeros((), dtype=torch.float32, device=dev))
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p, vf.permute(0, 2, 1, 3))
    return m_new, l, acc


def _fresh_state(B: int, Hkv: int, G: int, D: int, dev):
    return (torch.full((B, Hkv, G), BIG_NEG, dtype=torch.float32, device=dev),
            torch.zeros((B, Hkv, G), dtype=torch.float32, device=dev),
            torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=dev))


def paged_attn_ref(q, k, k_s, v, v_s, pos, block_table, *,
                   bits: Optional[int], window: Optional[int] = None) -> torch.Tensor:
    """The same page-blocked running softmax as the kernel, vectorized over
    (slot, kv head). Returns (B, Hq, D) f32."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k.shape
    G = Hq // Hkv
    q4 = q.reshape(B, Hkv, G, D).to(torch.float32)
    pos = pos.to(torch.int32).reshape(B)
    bt = block_table.long()
    ar = torch.arange(ps, dtype=torch.int32, device=q.device)
    state = _fresh_state(B, Hkv, G, D, q.device)
    for j in range(bt.shape[1]):
        state = _softmax_page(state, q4, k, k_s, v, v_s, bt[:, j], j * ps + ar, pos, bits=bits,
                              window=window, scale=1.0 / (D**0.5))
    _, l, acc = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, D)


def _visible_pages(pos, window, ps: int, NB: int):
    """Per slot, the first and last page holding a visible key (the kernel's
    test): keys 0..pos, with a window only keys past pos - window; empty
    (lo > hi) when pos < 0."""
    hi = torch.where(pos >= 0, torch.clamp(pos, min=0) // ps, -1).clamp(max=NB - 1)
    lo = torch.zeros_like(pos)
    if window is not None:
        lo = torch.clamp(pos - window + 1, min=0) // ps
    return lo, hi


def paged_attn_split_ref(q, k, k_s, v, v_s, pos, block_table, *, bits: Optional[int],
                         window: Optional[int] = None,
                         pages_per_split: int = PAGES_PER_SPLIT,
                         skip_empty: bool = True) -> torch.Tensor:
    """The kernel's order of work: each run of ``pages_per_split`` pages
    takes ``paged_attn_ref``'s page-blocked softmax from a fresh state to a
    partial (m, l, acc); the partials of the runs holding a visible key
    (every run when ``skip_empty`` is False) merge in run order, M = max m,
    l = sum l * exp(m - M), acc = sum acc * exp(m - M), then acc / max(l,
    1e-30). Returns (B, Hq, D) f32."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k.shape
    G = Hq // Hkv
    NB = block_table.shape[1]
    pps = pages_per_split
    dev = q.device
    q4 = q.reshape(B, Hkv, G, D).to(torch.float32)
    pos = pos.to(torch.int32).reshape(B)
    bt = block_table.long()
    ar = torch.arange(ps, dtype=torch.int32, device=dev)
    lo, hi = _visible_pages(pos, window, ps, NB)
    parts = []
    for s in range(-(-NB // pps)):
        state = _fresh_state(B, Hkv, G, D, dev)
        for j in range(s * pps, min(s * pps + pps, NB)):
            state = _softmax_page(state, q4, k, k_s, v, v_s, bt[:, j], j * ps + ar, pos,
                                  bits=bits, window=window, scale=1.0 / (D**0.5))
        take = (torch.maximum(lo, torch.full_like(lo, s * pps))
                <= torch.minimum(hi, torch.full_like(hi, s * pps + pps - 1)))
        if not skip_empty:
            take = torch.ones_like(take)
        parts.append((take[:, None, None], *state))
    M, l, acc = _fresh_state(B, Hkv, G, D, dev)
    for take, m, _, _ in parts:
        M = torch.where(take, torch.maximum(M, m), M)
    for take, m, ls, accs in parts:
        e = torch.exp(m - M)
        l = torch.where(take, l + ls * e, l)
        acc = torch.where(take[..., None], acc + accs * e[..., None], acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, D)


def _copy_width(row_bytes: int, *tensors) -> int:
    """Widest staging copy (16, 8, 4 or 1 bytes) that divides a cache row and
    the alignment of every pool: 16 on the serving path."""
    for vb in (16, 8, 4):
        if row_bytes % vb == 0 and all(t.data_ptr() % vb == 0 for t in tensors):
            return vb
    return 1


def paged_attn_cuda(q, k, k_s, v, v_s, pos, block_table, *, bits: Optional[int],
                    window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel (the split pass and the merge). q (B, Hq, D)
    f32; k/v (P, ps, Hkv, D/r) int8 (bf16 when ``bits`` is None); k_s/v_s
    (P, ps, Hkv) f32; pos (B,) int32; block_table (B, NB) int32. Returns
    (B, Hq, D) f32."""
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
    nsplit = -(-NB // PAGES_PER_SPLIT)
    part = torch.empty(B * Hkv * nsplit * (Hq // Hkv) * (D + 2), dtype=torch.float32,
                       device=dev)
    vb = _copy_width(Dr * k.element_size(), k, v)
    fn = build.entry("paged_attn", "paged_attn_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(),
             k_s.data_ptr() if bits is not None else None, v.data_ptr(),
             v_s.data_ptr() if bits is not None else None, pos.data_ptr(),
             block_table.data_ptr(), out.data_ptr(), part.data_ptr(), B, Hq, Hkv, D, ps, NB,
             _BITS_CODE[bits], 0 if window is None else int(window), vb,
             1.0 / (D**0.5), build.stream_ptr(dev))
    build.check(err, "paged_attn_launch")
    build.LAUNCHES["paged_attn"] += 1
    return out


# ---------------------------------------------------- MLA absorbed decode

#: the MLA kernel's compile-time ``PPS`` and ``HB`` (``csrc/paged_mla_attn.cu``):
#: pages a block walks before its partial goes to the merge, and heads a
#: block takes; mirrored here to size the scratch. Fixed, never from B, the
#: SM count or pos. Chosen by ``scripts/sweep_mla_split.py`` at DeepSeek-V3's
#: kv8 decode shapes on an H100 (PERF.md, row 9)
MLA_PAGES_PER_SPLIT = 4
MLA_HEADS_PER_BLOCK = 32
_MLA_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float]
                 + [ctypes.c_void_p])


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _split3(x: torch.Tensor):
    """f32 -> bf16 hi, mid, lo (as f32 values) with hi + mid + lo == x."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    mid = (x - hi).to(torch.bfloat16).to(torch.float32)
    return hi, mid, (x - hi - mid).to(torch.bfloat16).to(torch.float32)


def _rz32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    r = x.to(torch.float32)
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _mma3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One k16 step of the kernel's tensor-core products: a (..., M, 16) f32
    split into bf16 hi + mid + lo, b (..., 16, N) exact bf16 values; lo, mid
    and hi each multiplied exactly and added to an accumulator that starts
    from zero and is rounded toward zero (the worst the tensor cores do)."""
    hi, mid, lo = _split3(a)
    z = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64, device=a.device)
    for part in (lo, mid, hi):
        z = _rz32(z + part.double() @ b.double()).double()
    return z.to(torch.float32)


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def _mla_scores(ql, qr, cf, rf, scale: float, mma: bool) -> torch.Tensor:
    """(B, H, T) scores of one page, (q_lat . c + q_rope . r) * scale. The
    plain version's two matmuls, or (``mma``) the kernel's: one dot over
    [q_lat | 0 | q_rope | 0] . [c | 0 | r | 0] (each part zero-padded to a
    multiple of 16), each k16 step a :func:`_mma3`, the steps added in k
    order with round-to-nearest."""
    if not mma:
        return (torch.matmul(ql, cf.transpose(1, 2)) + torch.matmul(qr, rf.transpose(1, 2))) * scale
    C, dr = ql.shape[-1], qr.shape[-1]
    q = torch.cat([_pad_last(ql, _round16(C)), _pad_last(qr, _round16(dr))], -1)
    k = torch.cat([_pad_last(cf, _round16(C)), _pad_last(rf, _round16(dr))], -1).transpose(1, 2)
    run = torch.zeros(q.shape[:-1] + k.shape[-1:], dtype=torch.float32, device=q.device)
    for k0 in range(0, q.shape[-1], 16):
        run = run + _mma3(q[..., k0:k0 + 16], k[..., k0:k0 + 16, :])
    return run * scale


def _mla_page(state, ql, qr, c, c_s, r, pages, kpos, pos, *, bits: Optional[int], scale: float,
              mma: bool = False):
    """One page of the running softmax over rows ``kpos`` of pool pages
    ``pages`` (one a slot): state (m, l, acc) -> the next. With ``mma`` the
    scores and p . c take the kernel's tensor-core arithmetic: p . c per 16
    rows of the page (zero-padded) a :func:`_mma3`, the first added to
    acc * alpha, each later one to the sum, with round-to-nearest."""
    m, l, acc = state
    dev = ql.device
    cf = _dequant(c[pages][:, :, 0], None if bits is None else c_s[pages][:, :, 0], bits)
    rf = r[pages][:, :, 0].to(torch.float32)  # (B, ps, dr)
    s = _mla_scores(ql, qr, cf, rf, scale, mma)
    vmask = (kpos[None] <= pos[:, None])[:, None, :]  # (B, 1, ps)
    s = torch.where(vmask, s, torch.tensor(BIG_NEG, dtype=torch.float32, device=dev))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(vmask, torch.exp(s - m_new[..., None]),
                    torch.zeros((), dtype=torch.float32, device=dev))
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    if not mma:
        return m_new, l, acc * alpha[..., None] + torch.matmul(p, cf)
    ps = cf.shape[1]
    pp = _pad_last(p, _round16(ps))
    cp = _pad_last(cf.transpose(1, 2), _round16(ps)).transpose(1, 2)
    acc = acc * alpha[..., None]
    for t0 in range(0, pp.shape[-1], 16):
        acc = acc + _mma3(pp[..., t0:t0 + 16], cp[:, t0:t0 + 16])
    return m_new, l, acc


def _mla_fresh_state(B: int, H: int, C: int, dev):
    m, l, acc = _fresh_state(B, 1, H, C, dev)
    return m[:, 0], l[:, 0], acc[:, 0]


def paged_mla_attn_ref(q_lat, q_rope, c, c_s, r, pos, block_table, *,
                       bits: Optional[int], scale: float) -> torch.Tensor:
    """The reference twin's page-blocked running softmax, step for step,
    vectorized over (slot, head). Returns the latent context (B, H, C) f32."""
    B, H, C = q_lat.shape
    ps = c.shape[1]
    ql = q_lat.to(torch.float32)
    qr = q_rope.to(torch.float32)
    pos = pos.to(torch.int32).reshape(B)
    bt = block_table.long()
    ar = torch.arange(ps, dtype=torch.int32, device=ql.device)
    state = _mla_fresh_state(B, H, C, ql.device)
    for j in range(bt.shape[1]):
        state = _mla_page(state, ql, qr, c, c_s, r, bt[:, j], j * ps + ar, pos, bits=bits,
                          scale=scale)
    _, l, acc = state
    return acc / torch.clamp(l, min=1e-30)[..., None]


def paged_mla_attn_split_ref(q_lat, q_rope, c, c_s, r, pos, block_table, *,
                             bits: Optional[int], scale: float,
                             pages_per_split: int = MLA_PAGES_PER_SPLIT,
                             skip_empty: bool = True, mma: bool = True) -> torch.Tensor:
    """The MLA kernel's order of work: each run of ``pages_per_split`` pages
    takes the page-blocked softmax from a fresh state to a partial (m, l,
    acc), with the kernel's tensor-core arithmetic (``mma``; off, the plain
    version's); the partials of the runs holding a visible key (every run
    when ``skip_empty`` is False) merge in run order as
    :func:`paged_attn_split_ref`'s do. Returns (B, H, C) f32."""
    B, H, C = q_lat.shape
    ps = c.shape[1]
    NB = block_table.shape[1]
    pps = pages_per_split
    dev = q_lat.device
    ql = q_lat.to(torch.float32)
    qr = q_rope.to(torch.float32)
    pos = pos.to(torch.int32).reshape(B)
    bt = block_table.long()
    ar = torch.arange(ps, dtype=torch.int32, device=dev)
    lo, hi = _visible_pages(pos, None, ps, NB)
    parts = []
    for s in range(-(-NB // pps)):
        state = _mla_fresh_state(B, H, C, dev)
        for j in range(s * pps, min(s * pps + pps, NB)):
            state = _mla_page(state, ql, qr, c, c_s, r, bt[:, j], j * ps + ar, pos, bits=bits,
                              scale=scale, mma=mma)
        take = (torch.maximum(lo, torch.full_like(lo, s * pps))
                <= torch.minimum(hi, torch.full_like(hi, s * pps + pps - 1)))
        if not skip_empty:
            take = torch.ones_like(take)
        parts.append((take[:, None], *state))
    M, l, acc = _mla_fresh_state(B, H, C, dev)
    for take, m, _, _ in parts:
        M = torch.where(take, torch.maximum(M, m), M)
    for take, m, ls, accs in parts:
        e = torch.exp(m - M)
        l = torch.where(take, l + ls * e, l)
        acc = torch.where(take[..., None], acc + accs * e[..., None], acc)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def paged_mla_attn_f64(q_lat, q_rope, c, c_s, r, pos, block_table, *,
                       bits: Optional[int], scale: float) -> torch.Tensor:
    """The same attention in f64 over the dequantized rows, one softmax over
    each slot's keys 0..pos: the exact value that the kernel and the plain
    version, whose f32 sums part by up to about 1e-5 at the model's scores,
    are both held to (only tests and ``chip_smoke.py`` use it). Returns
    (B, H, C) f64; a slot with no visible key gives zeros."""
    B, H, C = q_lat.shape
    ps, NB = c.shape[1], block_table.shape[1]
    pages = block_table.long().flatten()
    cf = _dequant(c[pages][:, :, 0], None if bits is None else c_s[pages][:, :, 0], bits)
    cf = cf.reshape(B, NB * ps, C).double()
    rf = r[pages][:, :, 0].double().reshape(B, NB * ps, -1)
    s = (torch.einsum("bhc,btc->bht", q_lat.double(), cf)
         + torch.einsum("bhd,btd->bht", q_rope.double(), rf)) * scale
    kpos = torch.arange(NB * ps, device=q_lat.device)
    vis = (kpos[None] <= pos.long()[:, None])[:, None]  # (B, 1, T)
    p = torch.softmax(torch.where(vis, s, float("-inf")), dim=-1).nan_to_num(0.0)
    return torch.einsum("bht,btc->bhc", p, cf)


def paged_mla_attn_cuda(q_lat, q_rope, c, c_s, r, pos, block_table, *,
                        bits: Optional[int], scale: float) -> torch.Tensor:
    """Launch the CUDA kernel (the split pass and the merge). q_lat (B, H, C)
    f32; q_rope (B, H, dr) f32; c (P, ps, 1, C/r) int8 (bf16 when ``bits``
    is None); c_s (P, ps, 1) f32; r (P, ps, 1, dr) bf16; pos (B,) int32;
    block_table (B, NB) int32. Returns (B, H, C) f32."""
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
    NB = block_table.shape[1]
    out = torch.empty((B, H, C), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    nsplit = -(-NB // MLA_PAGES_PER_SPLIT)
    hb = MLA_HEADS_PER_BLOCK
    part = torch.empty(B * -(-H // hb) * nsplit * hb * (C + 2), dtype=torch.float32, device=dev)
    vb = _copy_width(math.gcd(Cr * c.element_size(), dr * r.element_size()), c, r)
    fn = build.entry("paged_mla_attn", "paged_mla_attn_launch", _MLA_ARGTYPES)
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), c.data_ptr(),
             c_s.data_ptr() if bits is not None else None, r.data_ptr(), pos.data_ptr(),
             block_table.data_ptr(), out.data_ptr(), part.data_ptr(), B, H, C, dr, ps, NB,
             _BITS_CODE[bits], vb, float(scale), build.stream_ptr(dev))
    build.check(err, "paged_mla_attn_launch")
    build.LAUNCHES["paged_mla_attn"] += 1
    return out
