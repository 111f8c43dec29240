"""Public entry points for the port's kernels (counterpart of
``repro.kernels.ops``): ``mpmm``, ``wdqmm``, ``qntpack``, ``conv2d``,
``paged_gather`` and ``paged_scatter`` (one leaf, or a group of up to four
leaves in one launch: ``paged_gather_leaves``, ``paged_scatter_leaves``),
``paged_copy`` (one leaf, or any number in one launch:
``paged_copy_leaves``), ``paged_attn``,
``paged_mla_attn`` and ``flash_mha``, the port's own ``rowinv_einsum``
(the unfused attention's f32 products, row-invariant on the card), plus
the quantize-and-pack helpers.

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
    x_p: torch.Tensor,  # (M, K/rx) packed ifmaps, or (E, M, K/rx) for E experts
    w_p: torch.Tensor,  # (N, K/rw) packed signed weights, or (E, N, K/rw)
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
    path) scales the f32 output. With a leading expert axis on both
    operands (the reference's ``mpmm`` under ``jax.vmap``) the E products
    are one kernel launch and one dispatch, ``out_scale`` an (E,) vector
    (expert e's output scaled by entry e); returns (E, M, ...)."""
    if rq is None and out_kind == "packed":
        rq = Q.make_requant_params(y_bits=y_bits, eps_phi=2**-8, eps_y=1.0)
    entry = dispatch.lookup("mpmm", device=x_p.device, x_bits=x_bits, w_bits=w_bits,
                            y_bits=y_bits, impl=impl)
    if entry.key.impl == "torch":
        return entry.fn(x_p, w_p, rq, x_signed=x_signed, out_kind=out_kind,
                        out_scale=out_scale)
    dev = x_p.device
    rqv = requant_vector(rq).to(dev) if out_kind == "packed" else None
    E = x_p.shape[0] if x_p.dim() == 3 else 1
    scale = (torch.as_tensor(out_scale, dtype=torch.float32, device=dev).reshape(-1)
             .expand(E).contiguous() if out_kind == "f32" else None)
    return entry.fn(x_p, w_p, rqv, scale, x_signed=x_signed, out_kind=out_kind)


def wdqmm(
    x: torch.Tensor,  # (M, K) bf16/f32 activations
    w_p: torch.Tensor,  # (N, K/rw) packed signed weights
    eps_w,  # f32 scalar (a tensor on the operands' device on the hot path)
    *,
    w_bits: int,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Weight-only dequant matmul (the weight-only layers' path) -> (M, N)
    f32. Nothing is padded: the kernel masks its ragged edges."""
    entry = dispatch.lookup("wdqmm", device=x.device, w_bits=w_bits, impl=impl)
    eps = torch.as_tensor(eps_w, dtype=torch.float32, device=x.device)
    if entry.key.impl == "torch":
        return entry.fn(x, w_p, eps)
    return entry.fn(x.contiguous(), w_p.contiguous(), eps.reshape(1))


def qntpack(
    phi: torch.Tensor,  # (M, N) int32 accumulators
    rq: Q.RequantParams,
    *,
    y_bits: int,
    impl: Impl = "auto",
) -> torch.Tensor:
    """The paper's QntPack on its own: requantize and pack -> (M, N/ry) int8.
    The kernel takes the requant vector by value from the host: a call
    copies nothing to the card."""
    entry = dispatch.lookup("qntpack", device=phi.device, y_bits=y_bits, impl=impl)
    if entry.key.impl == "torch":
        return entry.fn(phi, rq)
    return entry.fn(phi, requant_vector(rq))


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
    page_size, ...) at stored width: a group of one leaf."""
    return paged_gather_leaves([pool], block_table, impl=impl)[0]


def paged_gather_leaves(
    pools,  # up to 4 (n_pages, page_size, ...) pools, any dtype each
    block_table: torch.Tensor,  # (B, n_blocks) int32, shared by the leaves
    *,
    impl: Impl = "auto",
) -> list:
    """Gather each pool into contiguous logical rows at stored width in one
    kernel launch: the unfused paged decode read of a layer's leaves."""
    entry = dispatch.lookup("paged_gather", device=pools[0].device, impl=impl)
    return entry.fn(pools, block_table)


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
    entries (0), land in the scratch page. A group of one leaf."""
    return paged_scatter_leaves([pool], [new], pos, block_table, impl=impl)[0]


def paged_scatter_leaves(
    pools,  # up to 4 (n_pages, page_size, ...) pools, written in place
    news,  # each pool's (B, S_new, ...) rows to write
    pos: torch.Tensor,  # (B,) int32 logical write positions, shared
    block_table: torch.Tensor,  # (B, n_blocks) int32, shared
    *,
    impl: Impl = "auto",
) -> list:
    """Scatter each leaf's new rows into its pool in one kernel launch (in
    place; returns the pools): a layer's cache write."""
    entry = dispatch.lookup("paged_scatter", device=pools[0].device, impl=impl)
    return entry.fn(pools, news, pos, block_table)


def paged_copy(
    pool: torch.Tensor,  # (n_pages, page_size, ...), written in place
    src: torch.Tensor,  # (K,) int32 source page ids (host or pool device)
    dst: torch.Tensor,  # (K,) int32 destination page ids
    *,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Clone whole pages ``src`` -> ``dst`` in place (returns the pool),
    with snapshot semantics: a ``dst`` page that reappears as a later
    ``src`` reads the original bits. A group of one leaf."""
    return paged_copy_leaves([pool], src, dst, impl=impl)[0]


def paged_copy_leaves(
    pools,  # any number of (n_pages, page_size, ...) pools, written in place
    src: torch.Tensor,  # (K,) int32 source page ids (host or the pools' device)
    dst: torch.Tensor,  # (K,) int32 destination page ids
    *,
    impl: Impl = "auto",
) -> list:
    """Clone pages ``src`` -> ``dst`` on every pool in one kernel launch (in
    place; returns the pools), with the snapshot semantics of
    :func:`paged_copy`: the prefix cache's copy-on-write over every cache
    leaf of every layer."""
    entry = dispatch.lookup("paged_copy", device=pools[0].device, impl=impl)
    return entry.fn(pools, src, dst)


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


def flash_mha(
    q: torch.Tensor,  # (B, Sq, Hq, D) bf16 or f32
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Whole-sequence flash attention forward (``flash_mha_pallas``'s
    function in the model's (B, S, H, D) layout): causal and/or windowed,
    GQA by ``h // (Hq / Hkv)``, positions from 0 on both sides. v's head
    dim equals the key's. Returns (B, Sq, Hq, D) f32; nothing is padded or
    transposed here."""
    entry = dispatch.lookup("flash_mha", device=q.device, impl=impl)
    return entry.fn(q, k, v, causal=causal, window=window)


def rowinv_einsum(
    spec: str,  # a two-operand einsum, e.g. "bqhd,bkhd->bhqk"
    a: torch.Tensor,  # f32, the query rows' operand (row letter q or s)
    b: torch.Tensor,  # f32
    *,
    impl: Impl = "auto",
) -> torch.Tensor:
    """``torch.einsum(spec, a, b)`` in f32. On the card through the
    rowinv_bmm kernel: every output one FMA chain over the contraction in
    order, so a query row has the same bits whatever number of rows is
    computed beside it; on CPU tensors the einsum itself."""
    entry = dispatch.lookup("rowinv_bmm", device=a.device, impl=impl)
    return entry.fn(spec, a, b)


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
