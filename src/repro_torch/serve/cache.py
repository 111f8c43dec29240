"""KV cache managers: the dense slot backend and the paged page-pool backend
(counterpart of ``repro.serve.cache``).

Both own the model caches, the per-slot write positions the decode step
consumes, slot acquisition/recycling, and capacity checks.

:class:`SlotCache` is the dense layout: every slot reserves a contiguous
``s_max`` stripe. :class:`PagedKVCache` is one global pool of fixed-size
token pages plus a per-slot block table; capacity is a PAGE budget.
Admission RESERVES the request's worst-case page count and :meth:`prepare`
draws pages on demand, so an admitted request can always finish. Pages are
REF-COUNTED and recycled (zeroed, returned to the free list) when their last
reader leaves. Page 0 is a reserved scratch page: unallocated block-table
entries point at it. Cache tensors are zeroed in place.

Not ported yet: the prefix-sharing backend and the speculative ``truncate``
verb (the ``truncates`` counter stays 0).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import model as M
from repro_torch.models.model import ArchConfig

#: the static page size (the reference's ``kvpage`` static default; the
#: autotuner that may pick another is not ported yet)
DEFAULT_PAGE_SIZE = 16


class CapacityError(ValueError):
    """A request can never fit: prompt + max_new exceeds ``s_max`` (either
    backend) or the whole page pool (paged backend)."""


def _tree_bytes(caches) -> int:
    return sum(a.numel() * a.element_size() for layer in caches for a in layer.values())


def _check_s_max(need: int, s_max: int) -> None:
    if need > s_max:
        raise CapacityError(
            f"request needs {need} cache rows (prompt + max_new) but s_max={s_max}")


class SlotCache:
    """Static-slot KV cache with per-slot write positions and occupancy."""

    paged = False
    page_size: Optional[int] = None

    def __init__(self, cfg: ArchConfig, policy: PrecisionPolicy, n_slots: int, s_max: int,
                 *, device=None):
        self.cfg, self.policy = cfg, policy
        self.n_slots, self.s_max = n_slots, s_max
        self.device = resolve_device(device)
        self.caches = M.init_cache(cfg, policy, n_slots, s_max, device=self.device)
        self.pos = np.zeros(n_slots, np.int32)  # next write position per slot
        self.resets = 0
        self.truncates = 0
        self._busy = [False] * n_slots

    def active_slots(self) -> int:
        return sum(self._busy)

    def check_admissible(self, need: int) -> None:
        _check_s_max(need, self.s_max)

    def can_admit(self, need: int, prompt=None) -> bool:
        return need <= self.s_max and not all(self._busy)

    def admission_cost(self, need: int, prompt=None) -> int:
        return need

    def acquire(self, need: int, prompt=None) -> Optional[int]:
        """Claim the lowest free slot, recycling it first when the previous
        occupant left a nonzero position (request isolation)."""
        self.check_admissible(need)
        for s in range(self.n_slots):
            if self._busy[s]:
                continue
            if self.pos[s] != 0:
                self.reset_slot(s)
            self._busy[s] = True
            return s
        return None

    def release(self, slot: int) -> None:
        """Return a slot to the free pool; rows are recycled lazily by the
        next :meth:`acquire`."""
        self._busy[slot] = False

    def prepare(self, slot: int, n: int) -> None:
        """A no-op here: the dense stripe pre-reserves every row."""

    def advance(self, slot: int, n: int) -> None:
        self.pos[slot] += n

    def commit(self, slot: int, prompt) -> None:
        """Prefix-index publication hook; a no-op on this backend."""

    def reset_slot(self, slot: int) -> None:
        """Zero the slot's cache rows and rewind its write position."""
        for layer in self.caches:
            for a in layer.values():
                a[slot] = 0
        self.pos[slot] = 0
        self.resets += 1

    def stats(self) -> dict:
        total = _tree_bytes(self.caches)
        return {
            "backend": "slot",
            "truncates": self.truncates,
            "kv_bytes_total": total,
            "kv_bytes_per_token": total / (self.n_slots * self.s_max),
        }


class PagedKVCache:
    """Paged KV cache: global page pool + per-slot block tables (numpy on
    the host; the engine snapshots them into every decode step)."""

    paged = True

    def __init__(self, cfg: ArchConfig, policy: PrecisionPolicy, n_slots: int, s_max: int,
                 *, page_size: Optional[int] = None, n_pages: Optional[int] = None,
                 device=None):
        if cfg.family not in M.PAGEABLE_FAMILIES:
            raise NotImplementedError(
                f"paged KV cache unsupported for family {cfg.family!r} "
                f"(pageable: {M.PAGEABLE_FAMILIES}); use the slot backend")
        if page_size is None:
            page_size = min(DEFAULT_PAGE_SIZE, s_max)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.cfg, self.policy = cfg, policy
        self.n_slots, self.s_max = n_slots, s_max
        self.device = resolve_device(device)
        self.page_size = page_size
        self.n_blocks = -(-s_max // page_size)
        if n_pages is None:
            n_pages = n_slots * self.n_blocks + 1  # byte parity with slot + scratch
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (scratch + 1 usable)")
        self.n_pages = n_pages
        self.caches = M.init_paged_cache(cfg, policy, n_pages, page_size, device=self.device)
        self.block_tables = np.zeros((n_slots, self.n_blocks), np.int32)
        self.pos = np.zeros(n_slots, np.int32)
        self.resets = 0
        self.truncates = 0
        self._busy = [False] * n_slots
        self._alloc = np.zeros(n_slots, np.int32)     # blocks mapped per slot
        self._reserved = np.zeros(n_slots, np.int32)  # NEW pages promised per slot
        self._ref = np.zeros(n_pages, np.int32)       # readers per page
        self.pages_drawn = 0
        # page 0 is the scratch page; low ids are handed out first
        self._free: list[int] = list(range(n_pages - 1, 0, -1))

    # --- page accounting ----------------------------------------------------

    def pages_for(self, need: int) -> int:
        return -(-need // self.page_size)

    def pages_total(self) -> int:
        return self.n_pages - 1

    def pages_free(self) -> int:
        return len(self._free)

    def pages_allocated(self) -> int:
        return int(self._alloc.sum())

    def pages_live(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def pages_available(self) -> int:
        """Free pages not already promised to admitted requests."""
        committed = sum(
            int(self._reserved[s] - self._alloc[s])
            for s in range(self.n_slots) if self._busy[s])
        return len(self._free) - committed

    def _draw_page(self) -> int:
        if not self._free:
            raise RuntimeError(
                "page pool exhausted despite admission reservation — "
                "cache manager accounting bug")
        page = self._free.pop()
        self._ref[page] = 1
        self.pages_drawn += 1
        return page

    def _release_pages(self, pages) -> None:
        """Drop one reference per page; pages whose last reader left are
        zeroed and returned to the free list."""
        dead: list[int] = []
        for p in pages:
            p = int(p)
            if p == 0:
                continue  # scratch is never refcounted
            self._ref[p] -= 1
            if self._ref[p] == 0:
                dead.append(p)
            elif self._ref[p] < 0:
                raise RuntimeError(
                    f"page {p} released below zero references — cache manager accounting bug")
        if dead:
            idx = torch.tensor(dead, dtype=torch.long, device=self.device)
            for layer in self.caches:
                for a in layer.values():
                    a[idx] = 0
        self._free.extend(dead)

    # --- occupancy ---------------------------------------------------------

    def active_slots(self) -> int:
        return sum(self._busy)

    def check_admissible(self, need: int) -> None:
        _check_s_max(need, self.s_max)
        if self.pages_for(need) > self.pages_total():
            raise CapacityError(
                f"request needs {self.pages_for(need)} pages (prompt + max_new at "
                f"page_size={self.page_size}) but the pool holds {self.pages_total()}")

    def can_admit(self, need: int, prompt=None) -> bool:
        return (not all(self._busy)
                and self.admission_cost(need, prompt) <= self.pages_available())

    def admission_cost(self, need: int, prompt=None) -> int:
        return self.pages_for(need)

    def acquire(self, need: int, prompt=None) -> Optional[int]:
        """Claim the lowest free slot and reserve the request's worst-case
        page count. None when no slot is free or the pool cannot promise the
        pages right now."""
        self.check_admissible(need)
        if not self.can_admit(need, prompt):
            return None
        for s in range(self.n_slots):
            if self._busy[s]:
                continue
            if self.pos[s] != 0 or self._alloc[s]:
                self.reset_slot(s)
            self._busy[s] = True
            self._reserved[s] = self.pages_for(need)
            return s
        return None

    def release(self, slot: int) -> None:
        """Release a request's pages back to the pool now."""
        self._busy[slot] = False
        if self.pos[slot] or self._alloc[slot]:
            self.reset_slot(slot)
        else:
            self._reserved[slot] = 0

    # --- positions / pages --------------------------------------------------

    def prepare(self, slot: int, n: int) -> None:
        """Draw pages until the slot's table covers positions [0, pos + n)."""
        upto = int(self.pos[slot]) + n
        if upto > self.s_max:
            raise CapacityError(f"slot {slot}: write frontier {upto} exceeds s_max={self.s_max}")
        while int(self._alloc[slot]) * self.page_size < upto:
            self.block_tables[slot, int(self._alloc[slot])] = self._draw_page()
            self._alloc[slot] += 1

    def advance(self, slot: int, n: int) -> None:
        self.pos[slot] += n

    def commit(self, slot: int, prompt) -> None:
        """Prefix-index publication hook; a no-op on this backend."""

    def reset_slot(self, slot: int) -> None:
        """Drop the slot's reference on every mapped page and clear its row."""
        n_alloc = int(self._alloc[slot])
        if n_alloc:
            self._release_pages(self.block_tables[slot, :n_alloc])
        self.block_tables[slot, :] = 0
        self._alloc[slot] = 0
        self._reserved[slot] = 0
        self.pos[slot] = 0
        self.resets += 1

    # --- observability ------------------------------------------------------

    def stats(self) -> dict:
        total = _tree_bytes(self.caches)
        used_rows = sum(int(self.pos[s]) for s in range(self.n_slots) if self._busy[s])
        resident_rows = self.pages_allocated() * self.page_size
        util = used_rows / resident_rows if resident_rows else 1.0
        return {
            "backend": "paged",
            "page_size": self.page_size,
            "pages_total": self.pages_total(),
            "pages_free": self.pages_free(),
            "pages_allocated": self.pages_allocated(),
            "pages_live": self.pages_live(),
            "pages_available": self.pages_available(),
            "pages_drawn": self.pages_drawn,
            "truncates": self.truncates,
            "page_utilization": util,
            "page_fragmentation": 1.0 - util,
            "kv_bytes_total": total,
            "kv_bytes_per_token": total / (self.n_pages * self.page_size),
        }


CACHE_BACKENDS: dict[str, type] = {"slot": SlotCache, "paged": PagedKVCache}


def make_cache(spec: Union[str, SlotCache, PagedKVCache, None], cfg: ArchConfig,
               policy: PrecisionPolicy, n_slots: int, s_max: int, *,
               page_size: Optional[int] = None, n_pages: Optional[int] = None,
               device=None):
    """Resolve a cache-backend argument: name, instance, or None (-> slot)."""
    if spec is None:
        spec = "slot"
    if not isinstance(spec, str):
        return spec
    if spec == "prefix":
        raise NotImplementedError("the prefix-sharing cache is not ported yet")
    cls = CACHE_BACKENDS.get(spec)
    if cls is None:
        raise KeyError(f"unknown cache backend {spec!r}; available: {sorted(CACHE_BACKENDS)}")
    if cls is SlotCache:
        return cls(cfg, policy, n_slots, s_max, device=device)
    return cls(cfg, policy, n_slots, s_max, page_size=page_size, n_pages=n_pages,
               device=device)
