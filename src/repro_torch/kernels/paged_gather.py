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

Gather and scatter take a group of up to four leaves (a layer's k, v, k_s,
v_s, or its c, c_s, r) that share the block table (and ``pos``), each leaf
of its own dtype and width: one kernel launch a group. The copy takes any
number of leaves (every leaf of every layer: one launch a COW clone). The
single-leaf ops are a group of one.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch import host_copy
from repro_torch.kernels import build

#: leaves a group call takes (a layer's k, v, k_s, v_s); MAX_LEAVES in
#: csrc/paged_scatter.cu and csrc/paged_gather.cu
MAX_LEAVES = 4
_PTRS = ctypes.c_void_p * MAX_LEAVES
_SIZES = ctypes.c_longlong * MAX_LEAVES
_INTS = ctypes.c_int * MAX_LEAVES
_SCATTER_ARGTYPES = [ctypes.c_int, _PTRS, _PTRS, _SIZES, _INTS, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_GATHER_ARGTYPES = [ctypes.c_int, _PTRS, _PTRS, _SIZES, _INTS, _INTS, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_void_p]
#: page ids one copy launch takes by value (MAX_IDS in csrc/paged_copy.cu)
MAX_IDS = 16
_IDS = ctypes.c_int * MAX_IDS
#: bytes a block of the copy moves (CHUNK in csrc/paged_copy.cu)
COPY_CHUNK = 4096
_COPY_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _group_size(n: int, what: str) -> None:
    if not 1 <= n <= MAX_LEAVES:
        raise ValueError(f"{what} takes 1 to {MAX_LEAVES} leaves, got {n}")


def _wide(nbytes: int, *tensors) -> int:
    """1 where ``nbytes`` and every pointer allow 16-byte copies."""
    return int(nbytes % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


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


def paged_gather_leaves_ref(pools, block_table: torch.Tensor) -> list:
    """The group's plain version: ``paged_gather_ref`` on each leaf."""
    return [paged_gather_ref(pool, block_table) for pool in pools]


def paged_gather_leaves_cuda(pools, block_table: torch.Tensor) -> list:
    """Launch the CUDA kernel once for up to four leaves that share the
    block table: each pool (P, ps, ...) -> (B, NB * ps, ...)."""
    _group_size(len(pools), "paged_gather")
    dev = pools[0].device
    if dev.type != "cuda":
        raise ValueError(f"paged_gather needs CUDA tensors, got {dev}")
    build.check_tensor(block_table, "block_table", torch.int32, dev)
    if block_table.dim() != 2:
        raise ValueError("paged_gather takes a (B, NB) block table")
    B, NB = block_table.shape
    outs = []
    for i, pool in enumerate(pools):
        build.check_tensor(pool, f"pools[{i}]", pool.dtype, dev)
        if pool.dim() < 2:
            raise ValueError("paged_gather takes (P, ps, ...) pools")
        outs.append(torch.empty((B, NB * pool.shape[1], *pool.shape[2:]), dtype=pool.dtype,
                                device=dev))
    page_bytes = [math.prod(pool.shape[1:]) * pool.element_size() for pool in pools]
    if B * NB == 0 or not any(page_bytes):
        return outs
    if any(pool.shape[0] == 0 for pool in pools):
        raise ValueError("paged_gather from an empty pool")
    err = build.entry("paged_gather", "paged_gather_launch", _GATHER_ARGTYPES)(
        len(pools), _PTRS(*(p.data_ptr() for p in pools)), _PTRS(*(o.data_ptr() for o in outs)),
        _SIZES(*page_bytes), _INTS(*(_wide(n, p, o) for n, p, o in zip(page_bytes, pools, outs))),
        _INTS(*(p.shape[0] for p in pools)), block_table.data_ptr(), B * NB,
        build.stream_ptr(dev))
    build.check(err, "paged_gather_launch")
    build.LAUNCHES["paged_gather"] += 1
    return outs


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


def paged_scatter_leaves_ref(pools, news, pos: torch.Tensor,
                             block_table: torch.Tensor) -> list:
    """The group's plain version: ``paged_scatter_ref`` on each leaf."""
    return [paged_scatter_ref(pool, new, pos, block_table) for pool, new in zip(pools, news)]


def paged_scatter_leaves_cuda(pools, news, pos: torch.Tensor,
                              block_table: torch.Tensor) -> list:
    """Launch the CUDA kernel once for up to four leaves that share ``pos``
    and the block table: writes each pool in place and returns them."""
    _group_size(len(pools), "paged_scatter")
    if len(news) != len(pools):
        raise ValueError(f"paged_scatter: {len(pools)} pools but {len(news)} new row sets")
    dev = pools[0].device
    if dev.type != "cuda":
        raise ValueError(f"paged_scatter needs CUDA tensors, got {dev}")
    news = [new.to(pool.dtype).contiguous() for pool, new in zip(pools, news)]
    ps = pools[0].shape[1]
    B, S_new = news[0].shape[:2]
    for i, (pool, new) in enumerate(zip(pools, news)):
        build.check_tensor(pool, f"pools[{i}]", pool.dtype, dev)
        build.check_tensor(new, f"news[{i}]", pool.dtype, dev, (B, S_new, *pool.shape[2:]))
        if pool.shape[1] != ps:
            raise ValueError(f"paged_scatter: pools of page size {pool.shape[1]} and {ps} "
                             "cannot share a block table")
    build.check_tensor(pos, "pos", torch.int32, dev, (B,))
    build.check_tensor(block_table, "block_table", torch.int32, dev)
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be (B={B}, NB), got {tuple(block_table.shape)}")
    if B * S_new == 0:
        return pools
    row_bytes = [new[0, 0].numel() * new.element_size() for new in news]
    err = build.entry("paged_scatter", "paged_scatter_launch", _SCATTER_ARGTYPES)(
        len(pools), _PTRS(*(p.data_ptr() for p in pools)), _PTRS(*(n.data_ptr() for n in news)),
        _SIZES(*row_bytes), _INTS(*(_wide(r, p, n) for r, p, n in zip(row_bytes, pools, news))),
        pos.data_ptr(), block_table.data_ptr(), B, S_new, block_table.shape[1], ps,
        build.stream_ptr(dev))
    build.check(err, "paged_scatter_launch")
    build.LAUNCHES["paged_scatter"] += 1
    return pools


def launch_floor_cuda(device) -> None:
    """Launch one empty kernel on ``device``'s current stream: the launch
    floor against which a launch-bound kernel's device time is read. Counts
    no launch (it is no kernel of the port)."""
    err = build.entry("paged_scatter", "empty_launch", [ctypes.c_void_p])(
        build.stream_ptr(device))
    build.check(err, "empty_launch")


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


def paged_copy_leaves_ref(pools, src: torch.Tensor, dst: torch.Tensor) -> list:
    """The group's plain version: ``paged_copy_ref`` on each leaf."""
    return [paged_copy_ref(pool, src, dst) for pool in pools]


def copy_table(leaves) -> tuple[list, int, int]:
    """The copy kernel's leaf table for leaves given as (address, pages,
    page bytes): one row of five int64 words a leaf (``LeafRec`` in
    csrc/paged_copy.cu): the address, the page bytes, the leaf's offset in
    a staging row (rounded up to 16 bytes), ``chunk_begin | chunk_end <<
    32`` (the running sum of the leaves' COPY_CHUNK-byte chunks) and
    ``pages | vec << 32`` (vec: 16-byte copies, where the page size and the
    address allow them). Returns (rows, the set's chunks, the staging row's
    bytes)."""
    rows, chunk, off = [], 0, 0
    for addr, pages, nbytes in leaves:
        end = chunk + -(-nbytes // COPY_CHUNK)
        vec = int(nbytes % 16 == 0 and addr % 16 == 0)
        rows.append([addr, nbytes, off, chunk | end << 32, pages | vec << 32])
        chunk, off = end, off + -(-nbytes // 16) * 16
    if chunk >= 1 << 31:
        raise ValueError(f"paged_copy: {chunk} chunks of {COPY_CHUNK} bytes, want < 2^31")
    return rows, chunk, off


def copy_launches(page_counts, src, dst) -> int:
    """Launches one copy takes: 1 (pool to pool) for host ids (lists), at
    most MAX_IDS of them, whose sources (wrapped, clamped) share no page
    with their destinations (wrapped) under any of the leaves' page counts;
    else 2, through the staging buffer (``src`` None: ids on the card)."""
    if src is None or len(src) > MAX_IDS:
        return 2
    for n in set(page_counts):
        s = {min(max(x + n if x < 0 else x, 0), n - 1) for x in src}
        if not s.isdisjoint(x + n if x < 0 else x for x in dst):
            return 2
    return 1


#: leaf tables on the card, keyed by each leaf's (address, pages, page
#: bytes) on one device: a table is a pure function of its key, so an entry
#: is never stale; the dict is emptied when it reaches TABLES_KEPT entries
_TABLES: dict = {}
TABLES_KEPT = 256


def _leaf_table(dev, pools, page_bytes) -> tuple:
    key = (dev.index, *((p.data_ptr(), p.shape[0], n) for p, n in zip(pools, page_bytes)))
    hit = _TABLES.get(key)
    if hit is None:
        rows, chunks, row_bytes = copy_table(key[1:])
        if len(_TABLES) >= TABLES_KEPT:
            _TABLES.clear()
        # the first clone of a set waits for nothing either
        table = host_copy(np.asarray(rows, dtype=np.int64), dev)
        hit = _TABLES[key] = (table, chunks, row_bytes)
    return hit


def paged_copy_leaves_cuda(pools, src: torch.Tensor, dst: torch.Tensor) -> list:
    """Clone pages ``src`` -> ``dst`` on every pool of the set (any number
    of leaves, each of its own dtype, width and page count) in place, and
    return the pools.

    ``src`` and ``dst`` are (K,) int32, both on the host or both on the
    pools' device. Host ids (at most MAX_IDS) that share no page between the
    two lists (the prefix cache's clone into a freshly drawn page) take one
    launch, pool to pool, the ids by value; otherwise the pages go through
    one staging buffer for the set in two launches, so an overlap reads the
    original bits without a host sync. The set's leaf table is uploaded at
    its first copy only."""
    if not pools:
        raise ValueError("paged_copy takes at least one leaf")
    dev = pools[0].device
    if dev.type != "cuda":
        raise ValueError(f"paged_copy needs CUDA tensors, got {dev}")
    for i, pool in enumerate(pools):
        build.check_tensor(pool, f"pools[{i}]", pool.dtype, dev)
        if pool.dim() < 2:
            raise ValueError("paged_copy takes (P, ps, ...) pools")
    (K,) = src.shape
    on_host = src.device.type == "cpu"
    for name, ids in (("src", src), ("dst", dst)):
        build.check_tensor(ids, name, torch.int32, torch.device("cpu") if on_host else dev, (K,))
    page_bytes = [math.prod(pool.shape[1:]) * pool.element_size() for pool in pools]
    if K == 0 or not any(page_bytes):
        return pools
    if any(pool.shape[0] == 0 for pool, n in zip(pools, page_bytes) if n):
        raise ValueError("paged_copy in an empty pool")
    table, chunks, row_bytes = _leaf_table(dev, pools, page_bytes)
    s_ids, d_ids = (src.tolist(), dst.tolist()) if on_host else (None, None)
    n_launches = copy_launches([p.shape[0] for p in pools], s_ids, d_ids)
    if on_host and K > MAX_IDS:  # too many to pass by value
        src, dst, on_host = src.to(dev), dst.to(dev), False
    ids = ((None, None, _IDS(*s_ids), _IDS(*d_ids)) if on_host
           else (src.data_ptr(), dst.data_ptr(), None, None))
    fn = build.entry("paged_copy", "paged_copy_launch", _COPY_ARGTYPES)
    stream = build.stream_ptr(dev)

    def launch(mode, buf):
        err = fn(table.data_ptr(), len(pools), chunks, *ids, K,
                 None if buf is None else buf.data_ptr(), row_bytes, mode, stream)
        build.check(err, "paged_copy_launch")
        build.LAUNCHES["paged_copy"] += 1

    if n_launches == 1:
        launch(0, None)
    else:
        buf = torch.empty(K * row_bytes, dtype=torch.uint8, device=dev)
        launch(1, buf)
        launch(2, buf)
    return pools
