"""Paged KV gather, scatter and page copy (counterpart of
``repro.kernels.paged_gather``): the CUDA kernels' wrappers and their plain
PyTorch versions.

  * gather: the pool (P, ps, ...) read through the block table (B, NB) into
    contiguous logical rows (B, NB * ps, ...), at stored width (the unfused
    paged decode read). Page ids follow the reference's jnp twin
    ``pool[block_table]``: a negative id counts from the end, then ids clamp
    to [0, P - 1], so no id reads outside the pool;
  * scatter: writes ``new`` (B, S_new, ...) into the pool at
    ``block_table[b, (pos+s)//ps], (pos+s) % ps``. Rows past the table go to
    the scratch page 0 (never clamped onto the last real page), as do rows on
    an unallocated (0) entry. Both versions write the pool IN PLACE and
    return it: the reference aliases the pool in and out, and the port's
    caches are updated where they live;
  * copy: whole pages ``pool[dst[i]] = pool[src[i]]`` in place (the prefix
    cache's copy-on-write clone), with the reference twin's snapshot
    semantics: a ``dst`` page that reappears as a later ``src`` reads the
    ORIGINAL bits. Ids follow the twin too: negative ids count from the
    end, then a source id clamps into the pool and a destination id outside
    it is dropped. Duplicate ``dst`` entries are outside the contract.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong,
                                                            ctypes.c_int, ctypes.c_void_p]
_COPY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                                                ctypes.c_void_p]
_GATHER_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_void_p]


def _page_ids(block_table: torch.Tensor, n_pages: int) -> torch.Tensor:
    """The jnp twin's index rule: negative ids count from the end, then
    clamp into the pool."""
    bt = block_table.long()
    return torch.where(bt < 0, bt + n_pages, bt).clamp(0, n_pages - 1)


def paged_gather_ref(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Advanced-index gather along the page axis -> (B, NB * ps, ...)."""
    B, NB = block_table.shape
    g = pool[_page_ids(block_table, pool.shape[0])]  # (B, NB, ps, ...)
    return g.reshape(B, NB * pool.shape[1], *pool.shape[2:])


def paged_gather_cuda(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: one block per gathered page."""
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError(f"paged_gather_cuda needs CUDA tensors, got {dev}")
    build.check_tensor(pool, "pool", pool.dtype, dev)
    build.check_tensor(block_table, "block_table", torch.int32, dev)
    if block_table.dim() != 2 or pool.dim() < 2:
        raise ValueError("paged_gather takes a (P, ps, ...) pool and a (B, NB) block table")
    P_, ps = pool.shape[:2]
    B, NB = block_table.shape
    out = torch.empty((B, NB * ps, *pool.shape[2:]), dtype=pool.dtype, device=dev)
    if out.numel() == 0:
        return out
    if P_ == 0:
        raise ValueError("paged_gather from an empty pool")
    page_bytes = pool[0].numel() * pool.element_size()
    vec = int(page_bytes % 16 == 0 and pool.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    fn = build.lib("paged_gather").paged_gather_launch
    fn.argtypes, fn.restype = _GATHER_ARGTYPES, ctypes.c_int
    err = fn(pool.data_ptr(), block_table.data_ptr(), out.data_ptr(), P_, B * NB, page_bytes,
             vec, build.stream_ptr(dev))
    build.check(err, "paged_gather_launch")
    build.LAUNCHES["paged_gather"] += 1
    return out


def paged_scatter_ref(pool: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                      block_table: torch.Tensor) -> torch.Tensor:
    """Advanced-index scatter; out-of-table block indices read as the
    scratch page 0."""
    ps = pool.shape[1]
    B, S_new = new.shape[:2]
    nb = block_table.shape[1]
    idx = pos.long()[:, None] + torch.arange(S_new, device=pool.device)[None]
    blk = idx // ps
    page = torch.where(blk < nb,
                       torch.gather(block_table.long(), 1, blk.clamp(max=nb - 1)),
                       torch.zeros((), dtype=torch.long, device=pool.device))
    pool[page, idx % ps] = new.to(pool.dtype)
    return pool


def paged_scatter_cuda(pool: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                       block_table: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: writes ``pool`` in place and returns it."""
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError(f"paged_scatter_cuda needs CUDA tensors, got {dev}")
    new = new.to(pool.dtype).contiguous()
    P_, ps = pool.shape[:2]
    B, S_new = new.shape[:2]
    build.check_tensor(pool, "pool", pool.dtype, dev)
    build.check_tensor(new, "new", pool.dtype, dev, (B, S_new, *pool.shape[2:]))
    build.check_tensor(pos, "pos", torch.int32, dev, (B,))
    build.check_tensor(block_table, "block_table", torch.int32, dev)
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be (B={B}, NB), got {tuple(block_table.shape)}")
    if B * S_new == 0:
        return pool
    row_bytes = new[0, 0].numel() * new.element_size()
    vec = int(row_bytes % 16 == 0 and pool.data_ptr() % 16 == 0
              and new.data_ptr() % 16 == 0)
    fn = build.lib("paged_scatter").paged_scatter_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(pool.data_ptr(), new.data_ptr(), pos.data_ptr(), block_table.data_ptr(),
             B, S_new, block_table.shape[1], ps, row_bytes, vec, build.stream_ptr(dev))
    build.check(err, "paged_scatter_launch")
    build.LAUNCHES["paged_scatter"] += 1
    return pool


def _wrap_ids(ids: torch.Tensor, n_pages: int) -> torch.Tensor:
    ids = ids.long().reshape(-1)
    return torch.where(ids < 0, ids + n_pages, ids)


def paged_copy_ref(pool: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Advanced-index page copy, the gather materialised before the write
    (snapshot semantics). Returns the pool, written in place."""
    P_ = pool.shape[0]
    s = _wrap_ids(src.to(pool.device), P_).clamp(0, P_ - 1)
    d = _wrap_ids(dst.to(pool.device), P_)
    keep = (d >= 0) & (d < P_)
    pool[d[keep]] = pool[s[keep]]
    return pool


def paged_copy_cuda(pool: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: writes ``pool`` in place and returns it.

    ``src`` and ``dst`` are (K,) int32, both on the host or both on the
    pool's device. Host ids that share no page between the two lists (the
    prefix cache's clone into a freshly drawn page) take one launch, pool to
    pool; otherwise the pages go through a (K, page) staging buffer in two
    launches, so an overlap reads the original bits without a host sync."""
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError(f"paged_copy_cuda needs CUDA tensors, got {dev}")
    build.check_tensor(pool, "pool", pool.dtype, dev)
    if pool.dim() < 2:
        raise ValueError("paged_copy takes a (P, ps, ...) pool")
    (K,) = src.shape
    on_host = src.device.type == "cpu"
    for name, ids in (("src", src), ("dst", dst)):
        build.check_tensor(ids, name, torch.int32, torch.device("cpu") if on_host else dev, (K,))
    P_ = pool.shape[0]
    page_bytes = pool[0].numel() * pool.element_size()
    if K == 0 or page_bytes == 0:
        return pool
    fn = build.lib("paged_copy").paged_copy_launch
    fn.argtypes, fn.restype = _COPY_ARGTYPES, ctypes.c_int
    stream = build.stream_ptr(dev)

    def launch(frm, sidx, to, didx):
        vec = int(page_bytes % 16 == 0 and frm.data_ptr() % 16 == 0 and to.data_ptr() % 16 == 0)
        err = fn(frm.data_ptr(), None if sidx is None else sidx.data_ptr(), to.data_ptr(),
                 None if didx is None else didx.data_ptr(), P_, K, page_bytes, vec, stream)
        build.check(err, "paged_copy_launch")
        build.LAUNCHES["paged_copy"] += 1

    direct = False
    if on_host:
        direct = set(_wrap_ids(src, P_).clamp(0, P_ - 1).tolist()).isdisjoint(
            _wrap_ids(dst, P_).tolist())
        src, dst = torch.stack([src, dst]).to(dev)
    if direct:
        launch(pool, src, pool, dst)
    else:
        buf = torch.empty((K, *pool.shape[1:]), dtype=pool.dtype, device=dev)
        launch(pool, src, buf, None)
        launch(buf, None, pool, dst)
    return pool
