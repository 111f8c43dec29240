"""Public entry points for the port's kernels (counterpart of
``repro.kernels.ops``): ``mpmm``, ``qntpack``, ``conv2d``, ``paged_gather``,
``paged_scatter``, ``paged_attn`` and ``paged_mla_attn``, plus the
quantize-and-pack helpers.

Every call routes through the dispatch registry. ``impl="auto"`` launches
the CUDA kernel for CUDA tensors and uses the plain PyTorch version for CPU
tensors. The CUDA kernels mask their own ragged edges, so nothing is padded
here (the conv's 1-pixel border included). Tile sizes are static: the
dense-view block size of ``paged_attn`` and ``paged_mla_attn`` is 16 (the
reference's static default, ``kernels/tuning.py``); the autotuner is not
ported yet.
"""

from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.core import pack as P
from repro_torch.core import quant as Q
from repro_torch.kernels import dispatch
from repro_torch.kernels.mpmm import requant_vector

Impl = Literal["auto", "cuda", "torch"]

#: dense-view block size of paged_attn (the reference's static default)
PAGED_ATTN_BS = 16


def mpmm(
    x_p: torch.Tensor,  # (M, K/rx) packed ifmaps
    w_p: torch.Tensor,  # (N, K/rw) packed signed weights
    rq: Optional[Q.RequantParams],
    *,
    x_bits: int,
    w_bits: int,
    y_bits: int,
    x_signed: bool = False,
    out_kind: str = "packed",
    out_scale=1.0,
    impl: Impl = "auto",
) -> torch.Tensor:
    """The paper's MatMul + fused QntPack over any of the 27 permutations.
    ``out_scale`` (f32 scalar, a tensor on the operands' device on the hot
    path) scales the f32 output."""
    if rq is None and out_kind == "packed":
        rq = Q.make_requant_params(y_bits=y_bits, eps_phi=2**-8, eps_y=1.0)
    entry = dispatch.lookup("mpmm", device=x_p.device, x_bits=x_bits, w_bits=w_bits,
                            y_bits=y_bits, impl=impl)
    if entry.key.impl == "torch":
        return entry.fn(x_p, w_p, rq, x_signed=x_signed, out_kind=out_kind,
                        out_scale=out_scale)
    dev = x_p.device
    rqv = requant_vector(rq).to(dev) if out_kind == "packed" else None
    scale = (torch.as_tensor(out_scale, dtype=torch.float32, device=dev).reshape(1)
             if out_kind == "f32" else None)
    return entry.fn(x_p, w_p, rqv, scale, x_signed=x_signed, out_kind=out_kind)


def qntpack(
    phi: torch.Tensor,  # (M, N) int32 accumulators
    rq: Q.RequantParams,
    *,
    y_bits: int,
    impl: Impl = "auto",
) -> torch.Tensor:
    """The paper's QntPack on its own: requantize and pack -> (M, N/ry) int8."""
    entry = dispatch.lookup("qntpack", device=phi.device, y_bits=y_bits, impl=impl)
    if entry.key.impl == "torch":
        return entry.fn(phi, rq)
    return entry.fn(phi, requant_vector(rq).to(phi.device))


def conv2d(
    x_p: torch.Tensor,  # (H, W, C/rx) packed HWC ifmap (unpadded)
    w_p: torch.Tensor,  # (Cout, 9C/rw) packed weights, (dy, dx, c) order
    rq: Q.RequantParams,
    *,
    x_bits: int,
    w_bits: int,
    y_bits: int,
    impl: Impl = "auto",
) -> torch.Tensor:
    """3x3/s1/p1 HWC conv (the paper's Reference Layer shape family) ->
    (H, W, Cout/ry) int8. The tile sizes are static (the autotuner's
    ``bh`` has no counterpart: the kernel walks one output row per block)."""
    rx, rw = P.pack_ratio(x_bits), P.pack_ratio(w_bits)
    C = x_p.shape[-1] * rx
    if w_p.shape[-1] * rw != 9 * C:
        raise ValueError(f"weights hold {w_p.shape[-1] * rw} taps, the ifmap needs 9C = {9 * C}")
    if w_p.shape[0] % P.pack_ratio(y_bits):
        raise ValueError(f"Cout={w_p.shape[0]} not divisible by the output pack ratio")
    entry = dispatch.lookup("conv2d", device=x_p.device, x_bits=x_bits, w_bits=w_bits,
                            y_bits=y_bits, impl=impl)
    if entry.key.impl == "torch":
        return entry.fn(x_p, w_p, rq)
    return entry.fn(x_p, w_p, requant_vector(rq).to(x_p.device))


def paged_gather(
    pool: torch.Tensor,  # (n_pages, page_size, ...) KV page pool, any dtype
    block_table: torch.Tensor,  # (B, n_blocks) int32 physical page ids
    *,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Gather a paged pool into contiguous logical rows (B, n_blocks *
    page_size, ...) at stored width: the unfused paged decode read."""
    entry = dispatch.lookup("paged_gather", device=pool.device, impl=impl)
    return entry.fn(pool, block_table)


def paged_scatter(
    pool: torch.Tensor,  # (n_pages, page_size, ...), written in place
    new: torch.Tensor,  # (B, S_new, ...) rows to write
    pos: torch.Tensor,  # (B,) int32 logical write positions
    block_table: torch.Tensor,  # (B, n_blocks) int32
    *,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Scatter new token rows into the page pool through the block table
    (in place; returns the pool). Rows past the table, or on unallocated
    entries (0), land in the scratch page."""
    entry = dispatch.lookup("paged_scatter", device=pool.device, impl=impl)
    return entry.fn(pool, new, pos, block_table)


def _dense_as_pool(bufs, B: int, S: int, bs: int):
    """View dense (B, S, ...) cache stripes as a (B*S/bs, bs, ...) page pool
    plus the identity block table: a free reshape (rows stay contiguous), so
    the slot backend shares the paged kernel."""
    nb = S // bs
    pooled = tuple(None if a is None else a.reshape(B * nb, bs, *a.shape[2:]) for a in bufs)
    dev = bufs[0].device
    bt = torch.arange(B * nb, dtype=torch.int32, device=dev).reshape(B, nb)
    return pooled, bt


def _snap_divisor(bs: int, S: int) -> int:
    return max(d for d in range(1, min(bs, S) + 1) if S % d == 0)


def paged_attn(
    q: torch.Tensor,  # (B, Hq, D) one query token per slot
    k: torch.Tensor,  # pool (P, ps, Hkv, D/r) or dense (B, S, Hkv, D/r)
    k_s: Optional[torch.Tensor],  # matching (..., Hkv) scales; None when bf16
    v: torch.Tensor,
    v_s: Optional[torch.Tensor],
    pos: torch.Tensor,  # (B,) int32 last valid cache row per slot
    *,
    bits: Optional[int],
    block_table: Optional[torch.Tensor] = None,  # (B, NB) int32; None = dense
    window: Optional[int] = None,
    impl: Impl = "auto",
    bs: Optional[int] = None,
) -> torch.Tensor:
    """Fused GQA decode attention over quantized KV pages. Without
    ``block_table`` the dense (B, S, ...) stripes are viewed as a pool with
    an identity table, at block size ``bs`` (default 16, snapped to a
    divisor of S). Returns (B, Hq, D) f32."""
    entry = dispatch.lookup("paged_attn", device=q.device, w_bits=bits, impl=impl)
    if block_table is None:
        B, S = k.shape[0], k.shape[1]
        (k, k_s, v, v_s), block_table = _dense_as_pool(
            (k, k_s, v, v_s), B, S, _snap_divisor(bs or PAGED_ATTN_BS, S))
    return entry.fn(q, k, k_s, v, v_s, pos, block_table, window=window)


def paged_mla_attn(
    q_lat: torch.Tensor,  # (B, H, C) absorbed query (q_nope . W_uk), f32
    q_rope: torch.Tensor,  # (B, H, dr) rotary query, f32
    c: torch.Tensor,  # latent pages, pool (P, ps, 1, C/r) or dense (B, S, 1, C/r)
    c_s: Optional[torch.Tensor],  # matching (..., 1) scales; None when bf16
    r: torch.Tensor,  # shared rope-key rows, same layout as c with a dr tail
    pos: torch.Tensor,  # (B,) int32 last valid cache row per slot
    *,
    bits: Optional[int],
    scale: float,
    block_table: Optional[torch.Tensor] = None,  # (B, NB) int32; None = dense
    impl: Impl = "auto",
) -> torch.Tensor:
    """Fused absorbed-MLA decode attention; the latent pages stay
    compressed. Returns the latent context (B, H, C) f32: the caller applies
    W_uv. The dense layout is viewed as a pool exactly as in
    :func:`paged_attn`, at its block size."""
    entry = dispatch.lookup("paged_mla_attn", device=q_lat.device, w_bits=bits, impl=impl)
    if block_table is None:
        B, S = c.shape[0], c.shape[1]
        (c, c_s, r), block_table = _dense_as_pool(
            (c, c_s, r), B, S, _snap_divisor(PAGED_ATTN_BS, S))
    return entry.fn(q_lat, q_rope, c, c_s, r, pos, block_table, scale=scale)


# ------------------------------------------------------- quantize-and-pack IO


def quantize_pack_act(x: torch.Tensor, beta, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """float -> packed unsigned activations + eps scale."""
    q, eps = Q.quantize_act(x, beta, bits)
    return P.pack(q, bits), eps


def quantize_pack_weight(w: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """float (N, K) -> packed signed weights + eps scale."""
    q, eps = Q.quantize_weight(w, bits)
    return P.pack(q, bits), eps


def make_rq(*, y_bits: int, eps_phi: float, eps_y: float, kappa: float = 1.0,
            lam: float = 0.0) -> Q.RequantParams:
    return Q.make_requant_params(y_bits=y_bits, kappa=kappa, lam=lam, eps_phi=eps_phi,
                                 eps_y=eps_y)
