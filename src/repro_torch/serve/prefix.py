"""Prefix-sharing KV cache: radix-indexed copy-on-write page reuse
(counterpart of ``repro.serve.prefix``).

Serving traffic is prefix-heavy (shared system prompts, few-shot templates,
multi-turn resubmissions), so most admitted tokens re-prefill pages the pool
already holds. This backend (``ServeEngine(..., cache="prefix")``) shares
them:

  * **Radix index.** A trie with one node per FULL page of prompt tokens,
    children keyed by the page's token block (a tuple: equal content is an
    equal key, so collisions are impossible). A node pins one physical pool
    page holding the quantized K/V of exactly those tokens at exactly those
    positions; K/V rows are pure per-token functions of the prefix, so one
    request's pages are bit-valid for every request with the same prefix.
  * **Zero-cost hits.** Admission walks the trie and maps every matched full
    page into the new request's block table (ref++) without prefilling it;
    prefill starts at the match frontier and the pool is charged only the
    unmatched pages.
  * **Copy-on-write.** The first divergent or partial page is cloned into a
    fresh page on every cache leaf through one ``ops.paged_copy_leaves``
    call (one launch of the ``paged_copy`` CUDA kernel on the card, its
    plain version on CPU tensors) before the request writes
    into it; the shared original stays bit-frozen for its other readers. A
    fully matched prompt is capped at S-1 reused tokens, so the last prompt
    token always re-prefills and the engine gets last-token logits to sample
    the first output token from.
  * **Refcounted lifecycle.** Every reader of a page (each block table that
    maps it, and the trie) holds one reference (``_retain_page`` /
    ``_release_pages`` in :mod:`repro_torch.serve.cache`). A page recycles
    (zeroed, freed) when its LAST reader leaves. Under pool pressure
    admission evicts cold index LEAVES in LRU order, never a page a live
    block table reads and never an interior node before its children.

Admission keeps the paged backend's guarantee that decode never runs out of
pages: ``acquire`` reserves the request's unmatched worst case and evicts
until the whole reservation is drawable. Only the admission verbs
(``can_admit`` / ``admission_cost`` / ``acquire``) and ``commit`` are
overridden; ``prepare`` / ``advance`` / ``release`` are the paged backend's,
so a cancelled sharer decrefs its pages like a completed one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels import ops
from repro_torch.models.model import ArchConfig
from repro_torch.serve.cache import CACHE_BACKENDS, PagedKVCache


class _Node:
    """One full page of prompt tokens in the radix index."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key, page: int, parent: Optional["_Node"]):
        self.key = key        # tuple of page_size token ids (None at the root)
        self.page = page      # physical pool page (-1 at the root)
        self.parent = parent
        self.children: dict[tuple, "_Node"] = {}
        self.last_used = 0


class PrefixCache(PagedKVCache):
    """Paged KV cache with cross-request prefix sharing (radix + COW)."""

    def __init__(self, cfg: ArchConfig, policy: PrecisionPolicy, n_slots: int, s_max: int,
                 *, page_size: Optional[int] = None, n_pages: Optional[int] = None,
                 device=None):
        super().__init__(cfg, policy, n_slots, s_max, page_size=page_size, n_pages=n_pages,
                         device=device)
        self._root = _Node(None, -1, None)
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.tokens_matched = 0
        self.tokens_submitted = 0
        self.cow_copies = 0
        self.evictions = 0
        # Trie-walk memos: one admission round probes each waiting prompt from
        # can_admit, again from the scheduler's cost ranking and the winner
        # once more in acquire, and _evictable walks the whole index per
        # probe. Both walks depend only on the index and the refcounts, so
        # results hold until _epoch (bumped on any index or refcount change)
        # moves; past a small size cap the tables are dropped wholesale.
        self._epoch = 0
        self._memo_epoch = 0
        self._probe_memo: dict[bytes, tuple] = {}
        self._evictable_memo: dict[tuple, int] = {}

    # --- radix index --------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # every change the memoised walks can observe bumps _epoch: trie inserts
    # and evictions (structure), page draws, retains and releases (refs)
    def _draw_page(self) -> int:
        self._epoch += 1
        return super()._draw_page()

    def _retain_page(self, page: int) -> None:
        self._epoch += 1
        super()._retain_page(page)

    def _release_pages(self, pages) -> None:
        self._epoch += 1
        super()._release_pages(pages)

    def _sync_memos(self) -> None:
        """Drop stale (or oversized) walk memos before consulting them."""
        if (self._memo_epoch != self._epoch
                or len(self._probe_memo) + len(self._evictable_memo) > 256):
            self._probe_memo.clear()
            self._evictable_memo.clear()
            self._memo_epoch = self._epoch

    def _page_key(self, prompt, d: int) -> tuple:
        ps = self.page_size
        return tuple(int(t) for t in prompt[d * ps:(d + 1) * ps])

    def _probe(self, prompt):
        """Read-only trie walk -> ``(full, partial, m)``: the chain of
        exactly matched full-page nodes, the best partially matching child at
        the divergence point and its usable row count ``m``. Reusable tokens
        are capped at ``len(prompt) - 1``, so prefill always recomputes the
        last prompt token (the logits source)."""
        self._sync_memos()
        key = np.asarray(prompt).tobytes()
        hit = self._probe_memo.get(key)
        if hit is not None:
            return hit
        S = len(prompt)
        ps = self.page_size
        node, full, d = self._root, [], 0
        while (d + 1) * ps <= S - 1:
            child = node.children.get(self._page_key(prompt, d))
            if child is None:
                break
            full.append(child)
            node, d = child, d + 1
        limit = min(ps, S - 1 - d * ps)
        best, best_m = None, 0
        if limit > 0 and node.children:
            seg = [int(t) for t in prompt[d * ps:d * ps + ps]]
            for child in node.children.values():
                m = 0
                for a, b in zip(child.key, seg):
                    if a != b:
                        break
                    m += 1
                m = min(m, limit)
                if m > best_m:
                    best, best_m = child, m
        self._probe_memo[key] = (full, best, best_m)
        return full, best, best_m

    def _evictable(self, exclude) -> int:
        """Pages LRU eviction could free now, leaf first: a node counts iff
        the index is its only reader (ref == 1), the admission in flight does
        not pin it (``exclude``) and its whole subtree counts too."""
        self._sync_memos()
        memo_key = tuple(sorted(id(n) for n in exclude))
        hit = self._evictable_memo.get(memo_key)
        if hit is not None:
            return hit

        def walk(node):
            total, all_ok = 0, True
            for ch in node.children.values():
                n, ok = walk(ch)
                total += n
                all_ok = all_ok and ok
            ok = (all_ok and node is not self._root and node not in exclude
                  and int(self._ref[node.page]) == 1)
            return total + (1 if ok else 0), ok

        count = walk(self._root)[0]
        self._evictable_memo[memo_key] = count
        return count

    def _evict_one(self, exclude) -> bool:
        """Unlink the least recently used evictable LEAF and release its page
        (ref 1 -> 0: zeroed and freed). False when nothing is evictable."""
        best = None

        def walk(node):
            nonlocal best
            for ch in node.children.values():
                walk(ch)
            if (node is not self._root and not node.children and node not in exclude
                    and int(self._ref[node.page]) == 1
                    and (best is None or node.last_used < best.last_used)):
                best = node

        walk(self._root)
        if best is None:
            return False
        del best.parent.children[best.key]
        self._epoch += 1
        self._release_pages([best.page])
        self.evictions += 1
        return True

    def _copy_pages(self, src: int, dst: int) -> None:
        """Clone pool page ``src`` into ``dst`` on every cache leaf of every
        layer in one call (the reference's tree map over the leaves). The
        ids stay on the host, where the wrapper sees them disjoint and
        copies every leaf in one launch."""
        s = torch.tensor([src], dtype=torch.int32)
        d = torch.tensor([dst], dtype=torch.int32)
        ops.paged_copy_leaves([a for layer in self.caches for a in layer.values()], s, d)

    # --- admission ----------------------------------------------------------

    def admission_cost(self, need: int, prompt=None) -> int:
        """NEW pages this request would consume: its worst case minus the
        full pages the index already holds (a COW clone still costs a page)."""
        if prompt is None:
            return self.pages_for(need)
        full, _, _ = self._probe(prompt)
        return self.pages_for(need) - len(full)

    def _match(self, prompt):
        full, part, m = self._probe(prompt) if prompt is not None else ([], None, 0)
        exclude = set(full)
        if part is not None and m > 0:
            exclude.add(part)
        return full, part, m, exclude

    def can_admit(self, need: int, prompt=None) -> bool:
        """A free slot, and the post-match page need is coverable by
        unpromised free pages plus what LRU eviction could reclaim (not
        counting the pages this request would match)."""
        if all(self._busy):
            return False
        full, _, _, exclude = self._match(prompt)
        cost = self.pages_for(need) - len(full)
        return cost <= self.pages_available() + self._evictable(exclude)

    def acquire(self, need: int, prompt=None) -> Optional[int]:
        """Claim a slot, map every matched full page (ref++) without
        prefilling it, COW-clone the first divergent or partial page, and
        reserve the unmatched remainder, evicting cold index leaves until the
        whole reservation is drawable."""
        self.check_admissible(need)
        full, part, m, exclude = self._match(prompt)
        cost = self.pages_for(need) - len(full)
        if all(self._busy) or cost > self.pages_available() + self._evictable(exclude):
            return None
        slot = next(s for s in range(self.n_slots) if not self._busy[s])
        if self.pos[slot] != 0 or self._alloc[slot]:
            self.reset_slot(slot)
        self._busy[slot] = True
        for d, node in enumerate(full):
            self.block_tables[slot, d] = node.page
            self._retain_page(node.page)
            node.last_used = self._tick()
        self._alloc[slot] = len(full)
        self._shared[slot] = len(full)
        self._reserved[slot] = cost
        while self.pages_available() < 0:
            if not self._evict_one(exclude):
                raise RuntimeError("LRU eviction shortfall despite the admission check — "
                                   "prefix cache accounting bug")
        matched = len(full) * self.page_size
        if part is not None and m > 0:
            dst = self._draw_page()
            self.block_tables[slot, len(full)] = dst
            self._alloc[slot] += 1
            self._copy_pages(part.page, dst)
            part.last_used = self._tick()
            self.cow_copies += 1
            matched += m
        self.pos[slot] = matched
        if prompt is not None:
            self.tokens_submitted += len(prompt)
            self.tokens_matched += matched
            if matched:
                self.hits += 1
            else:
                self.misses += 1
        return slot

    def commit(self, slot: int, prompt) -> None:
        """Publish the slot's freshly prefilled FULL prompt pages to the
        index (a partial tail page stays private: decode keeps writing into
        it). Each new node retains its page for the index, which keeps the
        prefix resident after the request completes; matched nodes refresh
        their LRU stamp."""
        node = self._root
        for d in range(len(prompt) // self.page_size):
            key = self._page_key(prompt, d)
            child = node.children.get(key)
            if child is None:
                page = int(self.block_tables[slot, d])
                if page == 0:
                    break  # an unallocated block: never expected
                child = _Node(key, page, node)
                node.children[key] = child
                self._retain_page(page)
                self._epoch += 1
            child.last_used = self._tick()
            node = child

    # --- observability ------------------------------------------------------

    def pages_shared(self) -> int:
        """Distinct physical pages mapped by two or more live block tables."""
        mapped = [self.block_tables[s, :int(self._alloc[s])]
                  for s in range(self.n_slots) if self._busy[s]]
        if not mapped:
            return 0
        pages = np.concatenate(mapped)
        pages = pages[pages != 0]
        _, counts = np.unique(pages, return_counts=True)
        return int((counts >= 2).sum())

    def live_pages(self) -> set:
        """The block tables' pages and the pages the radix index pins."""
        live = super().live_pages()
        todo = [self._root]
        while todo:
            for ch in todo.pop().children.values():
                live.add(ch.page)
                todo.append(ch)
        return live

    def index_pages(self) -> int:
        """Pages pinned by the radix index (one per trie node)."""
        def walk(node):
            return sum(walk(ch) for ch in node.children.values()) + (
                0 if node is self._root else 1)
        return walk(self._root)

    def stats(self) -> dict:
        sub = self.tokens_submitted
        return {
            **super().stats(),
            "backend": "prefix",
            "prefix_hit_rate": self.tokens_matched / sub if sub else 0.0,
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "tokens_matched": self.tokens_matched,
            "pages_shared": self.pages_shared(),
            "index_pages": self.index_pages(),
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
        }


CACHE_BACKENDS["prefix"] = PrefixCache
