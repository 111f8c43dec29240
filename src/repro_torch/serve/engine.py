"""Serving facade (counterpart of ``repro.serve.engine``).

The engine composes the cache manager (:mod:`repro_torch.serve.cache`),
the admission scheduler (:mod:`repro_torch.serve.scheduler`) and the
chunked prefill (:mod:`repro_torch.serve.prefill`), and owns the decode
loop and the request lifecycle: ``submit()`` returns a handle, the caller
drives ``step()`` / ``drain()`` (``run()`` is the batch wrapper), every
request exit goes through ``_release``, and ``metrics()`` snapshots the
same keys as the reference.

Serialized mode (the default): each step admits waiting requests (blocking
chunked prefill; the first token comes from the prefill's last-token
logits) and then runs ONE decode step for every active slot:
``models.model.decode_step`` over ``n_slots`` static slots with per-slot
positions, followed by the batched sampler (``models.model.sample_tokens``):
per-slot temperature / top-k / top-p / seed lanes, token ``i`` of a request
drawn from ``fold_in(PRNGKey(seed), i)``, greedy lanes (temperature 0) an
argmax.

``mixed=True`` (chunkable families) is CONTINUOUS batching:

  * **Mixed steps** (``models.model.mixed_step``): prefill chunks ride the
    decode batch under a per-step token budget (``mixed_budget``), so a long
    prompt no longer holds the card between decode steps; a step with no
    prompt token is a plain decode step (fused attention eligible).
  * **Ahead-of-time dispatch**: up to ``inflight`` steps are issued before
    the first result is read. Each step's decode input is the previous
    step's sampled tokens on the device (``_chain``), host bookkeeping
    crosses through a :class:`~repro_torch.serve.boundary.SnapshotRing`
    (uploads that do not wait), and each step's tokens are copied into
    pinned host memory behind a CUDA event: retiring the oldest ticket waits
    on that event alone, the only host sync of the loop. Nothing in
    ``_admit`` or ``_dispatch`` waits for the card. Sampling counters and
    budgets advance speculatively at dispatch; a release (stop hit, cancel)
    drops the slot's tickets still in flight, by request identity.

Mixed-step lanes are row-independent and pad-scrubbed, and the
counter-based sampler makes each stream a function of (params, prompt,
sampling params): on the CPU the streams are the serialized engine's on
every cache. On the card a mixed step reduces its norms and attention over
other shapes than the serialized steps, so a stream may part from the
serialized one where two logits tie.

``spec=`` (``"self4"``, ``"draft"`` or a :class:`~repro_torch.serve.spec.
DraftPolicy`; serialized mode only) is SPECULATIVE decoding: each step is a
round (``_spec_round``) of ``spec_k`` chained draft steps (``decode_step``
unfused, each sampled at the lane's counter + j) and one
``models.model.spec_verify_step`` of the target over the k+1 window; the
longest agreeing prefix and the target's token at the first mismatch are
emitted, and the rejected rows roll back through the cache's ``truncate``.
The drafts stay on the device: drafts and targets come back to the host
together, in one copy a round, the round's one host sync. The streams are
those of the serialized engine that reads the cache unfused, on the card
too: the verify runs its softmax one query row at a time, as a decode step
does.

The cache is ``"slot"``, ``"paged"`` or ``"prefix"`` (prefix sharing: the
admission verbs get the prompt, prefill skips the matched rows and
``commit`` publishes the prompt's pages). The engine runs on CUDA unless
the caller passes ``device="cpu"``; ``device=None`` means CUDA and raises
where CUDA is absent. Not ported yet: tracing (``trace``).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels import dispatch
from repro_torch.models import model as M
from repro_torch.models.model import ArchConfig
from repro_torch.serve.api import (
    ACTIVE,
    CANCELLED,
    DONE,
    QUEUED,
    STOPPED,
    Request,
    RequestHandle,
    SamplingParams,
    as_params,
    check_stop,
)
from repro_torch.serve.boundary import SnapshotRing, host_copy
from repro_torch.serve.cache import PagedKVCache, SlotCache, make_cache
from repro_torch.serve.prefill import ChunkedPrefill, PrefillCursor, make_prefiller
from repro_torch.serve.scheduler import Scheduler, make_scheduler
from repro_torch.serve.spec import OUT_OF_RANGE, DraftPolicy, make_spec
from repro_torch.serve.stats import LatencyHistogram


class StepMonitor:
    """EMA step-time watchdog: flags straggler steps (> factor x EMA)."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.1):
        self.factor, self.alpha = factor, alpha
        self.ema: Optional[float] = None
        self.stragglers = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        if slow:
            self.stragglers += 1
        return slow


class KernelStatsAccumulator:
    """Per-engine view of the process-wide dispatch counters, harvested as
    deltas so a process-wide reset loses at most one window."""

    def __init__(self):
        self._counts: collections.Counter = collections.Counter()
        self._last = dict(dispatch.DISPATCH_COUNTS)

    def harvest(self) -> None:
        cur = dict(dispatch.DISPATCH_COUNTS)
        for k, v in cur.items():
            prev = self._last.get(k, 0)
            d = v - prev if v >= prev else v
            if d > 0:
                self._counts[k] += d
        self._last = cur

    def op_stats(self) -> dict:
        """``kernels/<op>_calls`` per op, and ``kernels/<op>_s`` (always 0.0:
        per-op timing comes with the tracer, not ported yet). The ops are the
        reference's: the port's own kernels (``dispatch.PORT_OWN_OPS``, the
        unfused attention's products, which the reference leaves to XLA)
        have no key here; ``kernels.build.LAUNCHES`` counts them."""
        self.harvest()
        calls: collections.Counter = collections.Counter()
        for k, v in self._counts.items():
            if k.op not in dispatch.PORT_OWN_OPS:
                calls[k.op] += v
        out: dict = {}
        for op in sorted(calls):
            out[f"kernels/{op}_calls"] = calls[op]
            out[f"kernels/{op}_s"] = 0.0
        return out


class ServeEngine:
    """Serialized or continuous batching over ``n_slots`` static cache slots."""

    def __init__(self, params, cfg: ArchConfig, policy: PrecisionPolicy, *,
                 n_slots: int = 4, s_max: int = 64, impl="auto",
                 scheduler: Union[str, Scheduler, None] = "fcfs",
                 prefill: str = "auto", prefill_chunk: int = 16,
                 cache: Union[str, SlotCache, PagedKVCache, None] = "slot",
                 page_size: Optional[int] = None, n_pages: Optional[int] = None,
                 fused_attn: Optional[bool] = None, mixed: bool = False,
                 mixed_budget: Optional[int] = None, inflight: int = 2,
                 spec: Union[str, DraftPolicy, None] = None, spec_k: int = 4, trace=None,
                 device=None):
        if trace is not None:
            raise NotImplementedError("tracing is not ported yet")
        self.device = resolve_device(device)
        self.params, self.cfg, self.policy = params, cfg, policy
        if fused_attn is None:
            fused_attn = cfg.family in M.PREFILL_CHUNKABLE_FAMILIES
        self.fused_attn = bool(fused_attn)
        dispatch.ensure_policy_supported(policy)
        M.check_policy(cfg, policy)
        self.mixed = bool(mixed)
        if self.mixed and (prefill == "stepwise" or not ChunkedPrefill.supports(cfg)):
            raise ValueError(
                f"mixed=True needs the chunked prefill path; family {cfg.family!r} "
                f"(prefill={prefill!r}) serves serialized only")
        self.n_slots, self.s_max = n_slots, s_max
        self.impl = impl
        self.cache = make_cache(cache, cfg, policy, n_slots, s_max, page_size=page_size,
                                n_pages=n_pages, device=self.device)
        self.scheduler = make_scheduler(scheduler)
        self.monitor = StepMonitor()
        self._kstats = KernelStatsAccumulator()
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_remaining = np.zeros(n_slots, np.int32)
        # per-slot sampling lanes; an idle slot is greedy (temperature 0)
        # and its token is discarded
        self._temps = np.zeros(n_slots, np.float32)
        self._top_ks = np.zeros(n_slots, np.int32)
        self._top_ps = np.ones(n_slots, np.float32)
        self._seeds = np.zeros(n_slots, np.uint32)
        self._counters = np.zeros(n_slots, np.int32)
        self.prefiller = make_prefiller(
            prefill, params, cfg, policy, impl=impl, chunk=prefill_chunk,
            page_size=self.cache.page_size if self.cache.paged else None, device=self.device)
        # --- continuous batching (mixed steps + ahead-of-time dispatch) ----
        self.mixed_budget = int(prefill_chunk if mixed_budget is None else mixed_budget)
        if self.mixed_budget < 1:
            raise ValueError(f"mixed_budget must be >= 1, got {mixed_budget}")
        self.inflight_depth = int(inflight)
        if self.inflight_depth < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        #: slot -> PrefillCursor: admitted requests whose prompts are still
        #: entering the cache, chunk by budget-allotted chunk
        self._prefilling: dict[int, PrefillCursor] = {}
        self._admit_seq = 0  # cursor ordering for Scheduler.allot
        #: dispatched-but-not-retired steps, oldest first: (host tokens,
        #: event or None, [(slot, request, emits), ...]); at most ``inflight``
        self._tickets: collections.deque = collections.deque()
        self._ticket_bufs: list = []  # pinned (n_slots,) int32 buffers, free
        #: the previous dispatch's sampled tokens on the device: the next
        #: step's decode-lane input, chained without a host round trip
        self._chain = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        #: dispatch-owned speculative token budget per slot (the retire-side
        #: twin is slot_remaining, owned by _emit)
        self._spec_remaining = np.zeros(n_slots, np.int32)
        self._ring = SnapshotRing(self.inflight_depth + 2, self.device)
        self._mixed_steps = 0
        self._progress = 0
        self._decode_steps = 0
        self._tokens_out = 0
        self._completed = 0
        self._cancelled = 0
        self._stopped_on_seq = 0
        self._deadline_misses = 0
        self._h_ttft = LatencyHistogram()
        self._h_ttft_queue = LatencyHistogram()
        self._h_ttft_prefill = LatencyHistogram()
        self._h_tpot = LatencyHistogram()
        self._serve_seconds = 0.0
        self._run_t0: Optional[float] = None
        self._next_rid = 0
        self._closed = False
        # --- speculative decoding (serve/spec.py) --------------------------
        self.spec = make_spec(spec)
        self.spec_k = int(spec_k)
        self._spec_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._h_spec_len = LatencyHistogram()
        if self.spec is not None:
            if self.mixed:
                raise ValueError(
                    "spec and mixed are mutually exclusive: acceptance makes the tokens a "
                    "step retires dynamic (1..k+1), which ahead-of-time dispatch cannot "
                    "express — its in-flight steps pre-commit counters and chain inputs")
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            self.spec.build(self)

    # --- request lifecycle: submission --------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               priority: int = 0, deadline: Optional[float] = None,
               rid: Optional[int] = None, on_token: Optional[Callable] = None) -> RequestHandle:
        params = params if params is not None else SamplingParams()
        prompt = np.asarray(prompt, np.int32)
        if rid is None:
            rid = self._next_rid
        req = Request(rid=rid, prompt=prompt, max_new=params.max_new, params=params,
                      priority=priority, deadline=deadline, on_token=on_token)
        return self._submit_request(req)

    def _submit_request(self, req: Request) -> RequestHandle:
        if self._closed:
            raise RuntimeError("engine is closed")
        if req.params is None:
            req.params = SamplingParams(max_new=req.max_new)
        req.max_new = req.params.max_new
        if len(req.prompt) == 0:
            raise ValueError("prompt must hold at least one token")
        self.cache.check_admissible(len(req.prompt) + req.max_new)
        now = time.perf_counter()
        req.t_submit = now
        req.t_deadline = None if req.deadline is None else now + req.deadline
        req.status = QUEUED
        req.out = []
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.scheduler.submit([req])
        return RequestHandle(self, req)

    def cancel(self, req: Request) -> bool:
        if req.finished:
            return False
        if req.status == QUEUED:
            if not self.scheduler.remove(req):
                return False
            req.status = CANCELLED
            req.t_done = time.perf_counter()
            self._cancelled += 1
            return True
        self._release(req.slot, CANCELLED)
        return True

    def close(self) -> None:
        if self._closed:
            return
        while self.scheduler.pending():
            req = self.scheduler.next_request()
            req.status = CANCELLED
            req.t_done = time.perf_counter()
            self._cancelled += 1
        for s, r in enumerate(self.slot_req):
            if r is not None:
                self._release(s, CANCELLED)
        self._tickets.clear()  # in-flight steps: nobody left to emit for
        self._closed = True

    # --- request lifecycle: the loop ----------------------------------------

    def _step(self, toks: np.ndarray):
        """One decode + sample step for every slot. ``pos`` and the block
        tables cross to the device as snapshots (host_copy), the sampling
        lanes as ``sample_tokens``' own copies. Returns (sampled (B,) int32
        on the device, logits (B, 1, V))."""
        t0 = time.perf_counter()
        dev = self.device
        bt = host_copy(self.cache.block_tables, dev) if self.cache.paged else None
        logits = M.decode_step(self.params, host_copy(toks, dev),
                               host_copy(self.cache.pos, dev), self.cache.caches, self.cfg,
                               self.policy, impl=self.impl, block_tables=bt,
                               fused_attn=self.fused_attn)
        nxt = M.sample_tokens(logits[:, -1], self._temps, self._top_ks, self._top_ps,
                              self._seeds, self._counters)
        self.monitor.observe(time.perf_counter() - t0)
        return nxt, logits

    def _release(self, slot: int, status: str = DONE) -> None:
        """THE exit path: completion, stop-sequence hit and cancellation."""
        r = self.slot_req[slot]
        now = time.perf_counter()
        r.status = status
        r.t_done = now
        if r.t_first == 0.0:
            r.t_first = now
        self.slot_req[slot] = None
        self.slot_remaining[slot] = 0
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 1.0
        self._seeds[slot] = 0
        self._counters[slot] = 0
        # continuous mode: drop the slot's prefill cursor and speculative
        # budget; its tickets still in flight retire as no-ops (the retire
        # checks request identity before emitting)
        self._prefilling.pop(slot, None)
        self._spec_remaining[slot] = 0
        self._progress += 1
        self.cache.release(slot)
        if self.spec is not None:
            self.spec.on_release(slot, self)
        if status == CANCELLED:
            self._cancelled += 1
        else:
            self._completed += 1
        if status == STOPPED:
            self._stopped_on_seq += 1
        if status != CANCELLED and r.t_deadline is not None and now > r.t_deadline:
            self._deadline_misses += 1
        self._kstats.harvest()

    def _emit(self, slot: int, tok: int) -> None:
        r = self.slot_req[slot]
        tok = int(tok)
        r.out.append(tok)
        self.slot_remaining[slot] -= 1
        if not self.mixed:
            # the PRNG counter of the next token; in continuous mode the
            # dispatch side owns it (steps in flight have consumed counters
            # past len(r.out))
            self._counters[slot] = len(r.out)
        self._tokens_out += 1
        now = time.perf_counter()
        if len(r.out) == 1:
            r.t_first = now
            self._h_ttft.observe(now - r.t_submit)
            self._h_ttft_queue.observe(r.t_admit - r.t_submit)
            self._h_ttft_prefill.observe(now - r.t_admit)
        else:
            self._h_tpot.observe(now - r.t_last_tok)
        r.t_last_tok = now
        if r.on_token:
            r.on_token(r.rid, tok)
        if r.status != ACTIVE:  # the callback cancelled us mid-emit
            return
        if check_stop(r.out, r.params.stop):
            self._release(slot, STOPPED)
        elif self.slot_remaining[slot] <= 0:
            self._release(slot, DONE)

    def _admit(self) -> None:
        """Admit waiting requests into free capacity; the first output token
        comes from the prefill's last-token logits."""
        fits = lambda r: self.cache.can_admit(  # noqa: E731
            len(r.prompt) + r.max_new, prompt=r.prompt)
        cost = lambda r: self.cache.admission_cost(  # noqa: E731
            len(r.prompt) + r.max_new, prompt=r.prompt)
        while self.scheduler.pending():
            req = self.scheduler.next_request(fits, cost)
            if req is None:
                return
            slot = self.cache.acquire(len(req.prompt) + req.max_new, prompt=req.prompt)
            if slot is None:
                self.scheduler.requeue(req)
                return
            req.status = ACTIVE
            req.slot = slot
            req.t_admit = time.perf_counter()
            p = as_params(req)
            self._temps[slot] = p.temperature
            self._top_ks[slot] = p.top_k
            self._top_ps[slot] = p.top_p
            self._seeds[slot] = p.seed
            self._counters[slot] = 0
            self.slot_req[slot] = req
            self.slot_remaining[slot] = req.max_new
            self._progress += 1
            if self.mixed:
                # no blocking prefill: park a cursor; the mixed steps carry
                # the prompt in under the token budget, and the dispatch
                # carrying the final chunk samples the first token
                self._admit_seq += 1
                self._spec_remaining[slot] = req.max_new
                self._prefilling[slot] = PrefillCursor(
                    req, req.prompt, slot=slot, order=self._admit_seq,
                    off=int(self.cache.pos[slot]))
                continue
            logits = self.prefiller.prefill(self.cache, slot, req.prompt, rid=req.rid)
            self.cache.commit(slot, req.prompt)
            if self.spec is not None:
                # the draft's own admission (DraftModel enters the prompt in
                # its cache), before the first emit so round one can draft
                self.spec.on_admit(slot, req.prompt, self)
            first = M.sample_tokens(logits[:, -1], [p.temperature], [p.top_k], [p.top_p],
                                    [p.seed], [0])
            self._emit(slot, int(first.cpu()[0]))

    def _active(self) -> bool:
        return any(r is not None for r in self.slot_req)

    # --- continuous mode: ahead-of-time dispatch ----------------------------

    def _samp_snapshot(self):
        """Ring snapshots of the per-slot sampling lanes on the device, and
        whether any lane samples (read from the host's temperatures)."""
        ring = self._ring
        return (ring.take("temps", self._temps),
                ring.take("top_ks", self._top_ks.astype(np.int64)),
                ring.take("top_ps", self._top_ps),
                ring.take("seeds", self._seeds.astype(np.int64)),
                ring.take("counters", self._counters.astype(np.int64))), bool(
                    np.any(self._temps > 0))

    def _dispatch(self) -> bool:
        """Issue ONE step without waiting for its result (continuous mode).

        Decode lanes feed on ``_chain`` (the previous dispatch's sampled
        tokens, on the device); prefill lanes carry their allotted chunk of
        prompt tokens. Host bookkeeping crosses through the snapshot ring.
        PRNG counters and per-slot budgets advance speculatively here; the
        retire side only materializes tokens. Returns False when no lane
        had work."""
        decode_lanes = [s for s, r in enumerate(self.slot_req)
                        if r is not None and s not in self._prefilling
                        and self._spec_remaining[s] > 0]
        allot = (self.scheduler.allot(list(self._prefilling.values()), self.mixed_budget)
                 if self._prefilling else [])
        if not decode_lanes and not allot:
            return False
        t0 = time.perf_counter()
        ring, paged = self._ring, self.cache.paged
        #: (slot, request, emits): emits=False for non-final prefill chunks
        lanes: list[tuple[int, Request, bool]] = []
        writes: list[tuple[int, int]] = []
        commits: list[tuple[int, Request]] = []
        if allot:
            # a mixed step: prefill chunks ride the decode batch, width W =
            # the token budget
            W = self.mixed_budget
            host_toks = np.zeros((self.n_slots, W), np.int32)
            n_real = np.zeros(self.n_slots, np.int32)
            use_chain = np.zeros(self.n_slots, bool)
            for cur, n in allot:
                s = cur.slot
                chunk = cur.take(n)
                host_toks[s, :len(chunk)] = chunk
                n_real[s] = len(chunk)
                self.cache.prepare(s, len(chunk))  # paged: draw pages
                writes.append((s, len(chunk)))
                # the final chunk's lane emits the request's FIRST token
                lanes.append((s, cur.req, cur.done))
                if cur.done:
                    commits.append((s, cur.req))
            for s in decode_lanes:
                n_real[s] = 1
                use_chain[s] = True
                self.cache.prepare(s, 1)
                writes.append((s, 1))
                lanes.append((s, self.slot_req[s], True))
            # snapshots AFTER every prepare (prepare mutates block tables),
            # BEFORE the speculative counter bump below
            samp, sampled = self._samp_snapshot()
            toks = ring.take("toks", host_toks)
            # decode lanes take their input from the device chain
            first = torch.where(ring.take("use_chain", use_chain), self._chain, toks[:, 0])
            toks = torch.cat([first[:, None], toks[:, 1:]], dim=1)
            logits = M.mixed_step(
                self.params, toks, ring.take("pos", self.cache.pos),
                ring.take("n_real", n_real), self.cache.caches, self.cfg, self.policy,
                impl=self.impl,
                block_tables=ring.take("bt", self.cache.block_tables) if paged else None,
                page_size=self.cache.page_size if paged else None)
            nxt = M.sample_tokens(logits[:, 0], *samp, sampled=sampled)
            self._mixed_steps += 1
        else:
            # a pure-decode step: S = 1, fused attention eligible
            for s in decode_lanes:
                self.cache.prepare(s, 1)
                writes.append((s, 1))
                lanes.append((s, self.slot_req[s], True))
            samp, sampled = self._samp_snapshot()
            logits = M.decode_step(
                self.params, self._chain[:, None], ring.take("pos", self.cache.pos),
                self.cache.caches, self.cfg, self.policy, impl=self.impl,
                block_tables=ring.take("bt", self.cache.block_tables) if paged else None,
                fused_attn=self.fused_attn)
            nxt = M.sample_tokens(logits[:, -1], *samp, sampled=sampled)
        for s, n in writes:
            self.cache.advance(s, n)
        for s, req in commits:
            # prompt fully in flight: the lane decodes from the next step,
            # and its pages are published to the prefix index (any later
            # reader is issued after these writes, on the same stream)
            del self._prefilling[s]
            self.cache.commit(s, req.prompt)
        self._decode_steps += 1
        # speculative state: steps in flight have consumed these counter
        # values; the retire side never rewrites them
        for s, req, emits in lanes:
            if emits:
                self._counters[s] += 1
                self._spec_remaining[s] -= 1
        self._chain = nxt
        self._tickets.append(self._ticket(nxt) + (lanes,))
        self._progress += 1
        self.monitor.observe(time.perf_counter() - t0)
        return True

    def _ticket(self, nxt: torch.Tensor) -> tuple:
        """(host tokens, event): on CUDA the sampled tokens are copied into a
        pinned buffer without waiting, and an event recorded after the copy
        is what the retire waits on; on the CPU they are ready now."""
        if nxt.device.type != "cuda":
            return nxt, None
        buf = (self._ticket_bufs.pop() if self._ticket_bufs else
               torch.empty(self.n_slots, dtype=torch.int32, pin_memory=True))
        buf.copy_(nxt, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev

    def _retire_one(self) -> None:
        """Materialize the OLDEST in-flight step: wait on its event (the hot
        loop's one host sync), then emit. Lanes whose request turned over
        since dispatch (stop hit, cancel, slot reuse) are dropped by
        identity."""
        buf, ev, lanes = self._tickets.popleft()
        if ev is not None:
            ev.synchronize()
        nxt = buf.tolist()
        if ev is not None:
            self._ticket_bufs.append(buf)
        self._progress += 1
        for s, req, emits in lanes:
            if not emits:
                continue
            if self.slot_req[s] is not req or req.status != ACTIVE:
                continue  # released after this step was issued
            self._emit(s, nxt[s])

    def step(self) -> bool:
        """One engine iteration. Returns True while work remains.

        Serialized mode: admit (blocking prefill), then one decode step for
        every active slot, read back at once. Continuous mode: retire the
        oldest ticket once ``inflight`` are in flight, admit (no prefill),
        dispatch one mixed or pure-decode step ahead of time; when nothing
        is dispatchable, retire a ticket instead, so the pipeline always
        moves."""
        if self._closed:
            raise RuntimeError("engine is closed")
        t0 = time.perf_counter()
        self._run_t0 = t0
        try:
            if self.mixed:
                if len(self._tickets) >= self.inflight_depth:
                    self._retire_one()
                self._admit()
                if not self._dispatch() and self._tickets:
                    self._retire_one()
            elif self.spec is not None:
                self._admit()
                if self._active():
                    self._spec_round()
            else:
                self._admit()
                if self._active():
                    self._decode_all()
        finally:
            self._serve_seconds += time.perf_counter() - t0
            self._run_t0 = None
        return bool(self.scheduler.pending() or self._active() or self._tickets)

    def _decode_all(self) -> None:
        """The serialized decode step: feed each slot's last generated token
        (prefill already sampled the first token from its own logits) and
        read the sampled tokens back at once."""
        toks = np.zeros((self.n_slots, 1), np.int32)
        for s, r in enumerate(self.slot_req):
            if r is not None:
                toks[s, 0] = r.out[-1]
                self.cache.prepare(s, 1)  # paged: draw a page
        nxt, _ = self._step(toks)
        self._decode_steps += 1
        nxt = nxt.cpu().numpy()
        for s in range(self.n_slots):
            if self.slot_req[s] is None:
                continue
            self.cache.advance(s, 1)
            self._emit(s, int(nxt[s]))
            self._progress += 1

    # --- speculative decoding: the round ------------------------------------

    def _draft(self, tok0: torch.Tensor, pos: np.ndarray) -> torch.Tensor:
        """``spec_k`` chained draft steps from ``tok0`` ((B, 1) on the device)
        at ``pos`` (OUT_OF_RANGE for lanes that take no part): step j writes
        row pos + j (the target's cache, or the draft's own) and samples at
        counter + j, the cell the verify scores offset j at, so a draft whose
        logits match the target's is always accepted. Unfused, as the
        verify reads. Returns the drafts (B, k) int32, on the device."""
        sp, dev = self.spec, self.device
        shared = sp.shares_cache
        caches = self.cache.caches if shared else sp.caches
        bt = host_copy(self.cache.block_tables, dev) if shared and self.cache.paged else None
        pos = host_copy(pos, dev)
        tok, drafts = tok0, []
        for j in range(self.spec_k):
            logits = M.decode_step(sp.params, tok, pos + j, caches, sp.cfg, sp.policy,
                                   impl=self.impl, block_tables=bt, fused_attn=False)
            nxt = M.sample_tokens(logits[:, -1], self._temps, self._top_ks, self._top_ps,
                                  self._seeds, self._counters + j)
            drafts.append(nxt)
            tok = nxt[:, None]
        return torch.stack(drafts, dim=1)

    def _spec_round(self) -> None:
        """One speculation round over every active slot (serialized mode).

        A slot with at least k+1 tokens of budget left takes part: the draft
        proposes k tokens, the target scores all k+1 positions in one
        ``spec_verify_step``, and the longest prefix where draft and target
        agree is accepted on the host; it and the target's token at the
        first mismatch are emitted together (1..k+1 tokens a round). A slot
        nearer its budget rides the verify as a plain decode lane
        (``n_real`` 1). Rejected rows roll back through ``truncate``. Drafts
        and targets come back in one copy, the round's one host sync."""
        k = self.spec_k
        W = k + 1
        t0 = time.perf_counter()
        dev = self.device
        toks = np.zeros((self.n_slots, W), np.int32)
        n_real = np.zeros(self.n_slots, np.int32)
        participants: list[int] = []
        active: list[int] = []
        for s, r in enumerate(self.slot_req):
            if r is None:
                continue
            active.append(s)
            toks[s, 0] = r.out[-1]
            if self.slot_remaining[s] >= W:
                participants.append(s)
                n_real[s] = W
                self.cache.prepare(s, W)  # paged: draw the whole window
            else:
                n_real[s] = 1
                self.cache.prepare(s, 1)
        if participants:
            src = self.cache.pos if self.spec.shares_cache else self.spec.pos
            dpos = np.full(self.n_slots, OUT_OF_RANGE, np.int32)
            dpos[participants] = src[participants]
            tok0 = host_copy(toks[:, :1], dev)
            window = torch.cat([tok0, self._draft(tok0, dpos)], dim=1)
        else:
            window = host_copy(toks, dev)
        paged = self.cache.paged
        targets = M.spec_verify_step(
            self.params, window, host_copy(self.cache.pos, dev), host_copy(n_real, dev),
            self._temps, self._top_ks, self._top_ps, self._seeds, self._counters,
            self.cache.caches, self.cfg, self.policy, impl=self.impl,
            block_tables=host_copy(self.cache.block_tables, dev) if paged else None,
            page_size=self.cache.page_size if paged else None)
        # the round's one host sync: window (its drafts) and targets together
        both = torch.cat([window, targets], dim=1).cpu().numpy()
        drafts, targets = both[:, 1:W], both[:, W:]
        self._decode_steps += 1
        self._spec_rounds += 1
        for s in active:
            r = self.slot_req[s]
            if n_real[s] == W:
                dr, tg = drafts[s], targets[s]
                m = 0
                while m < k and dr[m] == tg[m]:
                    m += 1
                # cache bookkeeping BEFORE emitting: _emit may release the
                # slot (budget, stop, a cancelling callback), which resets
                # its position wholesale
                self.cache.advance(s, W)
                self.cache.truncate(s, k - m)
                if not self.spec.shares_cache:
                    self.spec.pos[s] = int(self.cache.pos[s])
                self._spec_proposed += k
                self._spec_accepted += m
                self._h_spec_len.observe(m + 1)
                for j in range(m + 1):
                    self._emit(s, int(tg[j]))
                    if self.slot_req[s] is not r or r.status != ACTIVE:
                        break  # released mid-round: drop the tail
            else:
                self.cache.advance(s, 1)
                self._emit(s, int(targets[s, 0]))
            self._progress += 1
        self.monitor.observe(time.perf_counter() - t0)

    def drain(self) -> None:
        """Step until no queued, active or in-flight work remains; raises
        instead of spinning when queued requests can never be admitted
        (dispatches and retires count as progress)."""
        idle = 0
        while True:
            before = self._progress
            if not self.step():
                return
            if self._progress != before:
                idle = 0
                continue
            idle += 1
            time.sleep(0)
            if idle >= 1000:
                raise RuntimeError(
                    f"drain() wedged: {self.scheduler.pending()} queued request(s) cannot be "
                    f"admitted and no in-flight work remains to free capacity")

    def run(self, requests: Sequence[Request], *, on_token: Optional[Callable] = None):
        """Batch wrapper: submit every request, drain, return
        ``{rid: [token, ...]}``."""
        for r in requests:
            need = len(r.prompt) + (r.params.max_new if r.params is not None else r.max_new)
            self.cache.check_admissible(need)
        for r in requests:
            if on_token is not None:
                r.on_token = on_token
            self._submit_request(r)
        self.drain()
        return {r.rid: r.out for r in requests}

    # --- observability ------------------------------------------------------

    def metrics(self) -> dict:
        """Serving metrics snapshot, with the reference's key names; the
        ``spec/`` keys count speculation rounds, proposed and accepted draft
        tokens and the accepted length a round (their off values without
        ``spec``)."""
        elapsed = self._serve_seconds
        if self._run_t0 is not None:
            elapsed += time.perf_counter() - self._run_t0
        elapsed = max(elapsed, 1e-9)
        return {
            **{f"cache/{k}": v for k, v in self.cache.stats().items()},
            "requests_completed": self._completed,
            "cancelled": self._cancelled,
            "stopped_on_sequence": self._stopped_on_seq,
            "deadline_misses": self._deadline_misses,
            "tokens_generated": self._tokens_out,
            "tokens_per_s": self._tokens_out / elapsed,
            "decode_steps": self._decode_steps,
            "mode": "continuous" if self.mixed else "serialized",
            "mixed_steps": self._mixed_steps,
            "mixed_budget": self.mixed_budget if self.mixed else 0,
            "inflight_depth": self.inflight_depth if self.mixed else 0,
            "inflight": len(self._tickets),
            "fused_attn": self.fused_attn,
            "spec/enabled": self.spec is not None,
            "spec/policy": self.spec.name if self.spec is not None else "off",
            "spec/k": self.spec_k if self.spec is not None else 0,
            "spec/rounds": self._spec_rounds,
            "spec/proposed": self._spec_proposed,
            "spec/accepted": self._spec_accepted,
            "spec/acceptance_rate": (self._spec_accepted / self._spec_proposed
                                     if self._spec_proposed else 0.0),
            **self._h_spec_len.summary("spec/accepted_len"),
            "prefill_mode": self.prefiller.name,
            "prefill_chunk": self.prefiller.chunk,
            "prefill_jit_calls": self.prefiller.jit_calls,
            **self._h_ttft.summary("slo/ttft"),
            **self._h_ttft_queue.summary("slo/ttft_queue"),
            **self._h_ttft_prefill.summary("slo/ttft_prefill"),
            **self._h_tpot.summary("slo/tpot"),
            "queue_depth": self.scheduler.pending(),
            "active_slots": self.cache.active_slots(),
            "slot_resets": self.cache.resets,
            "step_ema_s": self.monitor.ema or 0.0,
            "stragglers": self.monitor.stragglers,
            "scheduler": self.scheduler.name,
            **self._kstats.op_stats(),
        }
