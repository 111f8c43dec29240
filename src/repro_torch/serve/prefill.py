"""Chunked prefill: how a request's prompt gets written into its cache
(counterpart of ``repro.serve.prefill``, ``ChunkedPrefill`` only).

The prompt is split into fixed-size chunks; each chunk embeds, attends
through the cache (later chunks see earlier ones) and writes its quantized
K/V: ``model.prefill_into_slot`` on the dense backend,
``model.prefill_into_pages`` on the paged one. The final chunk is
right-padded to the chunk size and ``last_idx`` selects the real last-token
logits, exactly as in the reference. Tokens the cache already holds
(``cache.pos[slot]``) are skipped.

:class:`PrefillCursor` is the continuous-batching form: the engine keeps one
per admitted request whose prompt is still entering the cache, and each
mixed step carries the chunk the scheduler allots it.

Not ported yet: the token-by-token ``StepwisePrefill`` (recurrent families).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import model as M
from repro_torch.models.model import ArchConfig
from repro_torch.serve.boundary import host_copy


class PrefillCursor:
    """One request's in-progress prompt, chunked into mixed steps.

    The continuous-batching engine does not run ``ChunkedPrefill.prefill``'s
    blocking loop: it keeps a cursor per admitted request and each step asks
    the scheduler to split the mixed step's token budget across the live
    cursors (``Scheduler.allot``). ``take(n)`` hands out the next ``n``
    prompt tokens; once ``done``, the slot is a decode lane, and the
    request's first token was sampled from the final chunk's last-token
    logits, as the serialized prefill returns them.

    ``off`` starts at the slot's resident position (a matched shared prefix
    on the prefix backend is skipped, as in ``ChunkedPrefill``); ``order``
    is the admission sequence number FCFS allotment sorts by."""

    __slots__ = ("req", "prompt", "slot", "order", "off", "chunks")

    def __init__(self, req, prompt: np.ndarray, *, slot: int, order: int, off: int = 0):
        self.req = req
        self.prompt = np.asarray(prompt, np.int32)
        self.slot = slot
        self.order = order
        self.off = int(off)
        self.chunks = 0  # chunks taken so far

    @property
    def remaining(self) -> int:
        return len(self.prompt) - self.off

    @property
    def done(self) -> bool:
        return self.off >= len(self.prompt)

    def take(self, n: int) -> np.ndarray:
        """Consume and return the next ``min(n, remaining)`` prompt tokens."""
        n = min(int(n), self.remaining)
        chunk = self.prompt[self.off:self.off + n]
        self.off += n
        self.chunks += 1
        return chunk


class ChunkedPrefill:
    """Single-request chunked prefill (slot or paged backend)."""

    name = "chunked"

    def __init__(self, params, cfg: ArchConfig, policy: PrecisionPolicy, *,
                 impl="auto", chunk: int = 16, page_size: Optional[int] = None,
                 device=None):
        if not self.supports(cfg):
            raise NotImplementedError(
                f"chunked prefill unsupported for family {cfg.family!r} "
                f"(supported: {M.PREFILL_CHUNKABLE_FAMILIES})")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.params, self.cfg, self.policy = params, cfg, policy
        self.impl = impl
        self.chunk = chunk
        self.page_size = page_size
        self.device = resolve_device(device)
        self.jit_calls = 0  # prefill calls (one per chunk), the reference's counter name

    @staticmethod
    def supports(cfg: ArchConfig) -> bool:
        return cfg.family in M.PREFILL_CHUNKABLE_FAMILIES

    def prefill(self, cache, slot: int, prompt: np.ndarray, *, rid: Optional[int] = None):
        """Write ``prompt`` into ``slot`` from its current position. Returns
        the last real prompt token's logits (1, 1, V)."""
        prompt = prompt[int(cache.pos[slot]):]
        S = len(prompt)
        logits = None
        off = 0
        while off < S:
            n = min(self.chunk, S - off)
            toks = np.zeros((1, self.chunk), np.int32)
            toks[0, :n] = prompt[off:off + n]
            cache.prepare(slot, n)  # paged backend draws pages on demand
            last = off + n >= S
            kw = dict(last_idx=n - 1 if last else None, head=last, impl=self.impl)
            args = (self.params, host_copy(toks, self.device))
            pos = int(cache.pos[slot])
            if cache.paged:
                # a snapshot: prepare() for the next chunk mutates the live table
                ref = host_copy(cache.block_tables[slot], self.device)
                out = M.prefill_into_pages(*args, ref, pos, cache.caches, self.cfg,
                                           self.policy, page_size=self.page_size, **kw)
            else:
                out = M.prefill_into_slot(*args, slot, pos, cache.caches, self.cfg,
                                          self.policy, **kw)
            if last:
                logits = out
            cache.advance(slot, n)
            self.jit_calls += 1
            off += n
        return logits


def make_prefiller(mode: str, params, cfg: ArchConfig, policy: PrecisionPolicy, *,
                   impl, chunk: int, page_size: Optional[int] = None, device=None):
    """Resolve the prefill strategy: ``auto`` and ``chunked`` give
    :class:`ChunkedPrefill`; the stepwise strategy is not ported yet."""
    if mode in ("auto", "chunked"):
        return ChunkedPrefill(params, cfg, policy, impl=impl, chunk=chunk,
                              page_size=page_size, device=device)
    if mode == "stepwise":
        raise NotImplementedError("stepwise prefill is not ported yet")
    raise ValueError(f"unknown prefill mode {mode!r} (expected auto | chunked | stepwise)")
