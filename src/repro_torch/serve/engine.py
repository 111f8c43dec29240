"""Serving facade, serialized loop (counterpart of ``repro.serve.engine``).

The engine composes the cache manager (:mod:`repro_torch.serve.cache`),
the admission scheduler (:mod:`repro_torch.serve.scheduler`) and the
chunked prefill (:mod:`repro_torch.serve.prefill`), and owns the decode
loop and the request lifecycle: ``submit()`` returns a handle, the caller
drives ``step()`` / ``drain()`` (``run()`` is the batch wrapper), every
request exit goes through ``_release``, and ``metrics()`` snapshots the
same keys as the reference's serialized mode.

Each step admits waiting requests (blocking chunked prefill; the first
token comes from the prefill's last-token logits) and then runs ONE decode
step for every active slot: ``models.model.decode_step`` over ``n_slots``
static slots with per-slot positions, followed by the greedy sampler.

The engine runs on CUDA unless the caller passes ``device="cpu"``;
``device=None`` means CUDA and raises where CUDA is absent. Not ported
yet: continuous batching (``mixed=True``), speculative decoding
(``spec``), tracing (``trace``), the prefix cache and stochastic sampling.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np

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
from repro_torch.serve.boundary import host_copy
from repro_torch.serve.cache import PagedKVCache, SlotCache, make_cache
from repro_torch.serve.prefill import make_prefiller
from repro_torch.serve.scheduler import Scheduler, make_scheduler
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
        per-op timing comes with the tracer, not ported yet)."""
        self.harvest()
        calls: collections.Counter = collections.Counter()
        for k, v in self._counts.items():
            calls[k.op] += v
        out: dict = {}
        for op in sorted(calls):
            out[f"kernels/{op}_calls"] = calls[op]
            out[f"kernels/{op}_s"] = 0.0
        return out


class ServeEngine:
    """Serialized serving over ``n_slots`` static cache slots."""

    def __init__(self, params, cfg: ArchConfig, policy: PrecisionPolicy, *,
                 n_slots: int = 4, s_max: int = 64, impl="auto",
                 scheduler: Union[str, Scheduler, None] = "fcfs",
                 prefill: str = "auto", prefill_chunk: int = 16,
                 cache: Union[str, SlotCache, PagedKVCache, None] = "slot",
                 page_size: Optional[int] = None, n_pages: Optional[int] = None,
                 fused_attn: Optional[bool] = None, mixed: bool = False,
                 spec=None, trace=None, device=None):
        if mixed:
            raise NotImplementedError("continuous batching (mixed=True) is not ported yet")
        if spec is not None:
            raise NotImplementedError("speculative decoding is not ported yet")
        if trace is not None:
            raise NotImplementedError("tracing is not ported yet")
        self.device = resolve_device(device)
        self.params, self.cfg, self.policy = params, cfg, policy
        if fused_attn is None:
            fused_attn = cfg.family in M.PREFILL_CHUNKABLE_FAMILIES
        self.fused_attn = bool(fused_attn)
        dispatch.ensure_policy_supported(policy)
        self.n_slots, self.s_max = n_slots, s_max
        self.impl = impl
        self.cache = make_cache(cache, cfg, policy, n_slots, s_max, page_size=page_size,
                                n_pages=n_pages, device=self.device)
        self.scheduler = make_scheduler(scheduler)
        self.monitor = StepMonitor()
        self._kstats = KernelStatsAccumulator()
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_remaining = np.zeros(n_slots, np.int32)
        self._temps = np.zeros(n_slots, np.float32)
        self.prefiller = make_prefiller(
            prefill, params, cfg, policy, impl=impl, chunk=prefill_chunk,
            page_size=self.cache.page_size if self.cache.paged else None, device=self.device)
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
        self._h_spec_len = LatencyHistogram()
        self._serve_seconds = 0.0
        self._run_t0: Optional[float] = None
        self._next_rid = 0
        self._closed = False

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
        if not req.params.greedy:
            raise NotImplementedError(
                "stochastic sampling (temperature > 0) is not ported yet: ROADMAP "
                "Queue 1 item 8, seeded sampling")
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
        self._closed = True

    # --- request lifecycle: the loop ----------------------------------------

    def _step(self, toks: np.ndarray):
        """One decode + greedy sample step for every slot. ``pos`` and the
        block tables cross to the device as snapshots (host_copy). Returns
        (sampled (B,) int32 on the device, logits (B, 1, V))."""
        t0 = time.perf_counter()
        dev = self.device
        bt = host_copy(self.cache.block_tables, dev) if self.cache.paged else None
        logits = M.decode_step(self.params, host_copy(toks, dev),
                               host_copy(self.cache.pos, dev), self.cache.caches, self.cfg,
                               self.policy, impl=self.impl, block_tables=bt,
                               fused_attn=self.fused_attn)
        nxt = M.sample_tokens(logits[:, -1], self._temps)
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
        self._progress += 1
        self.cache.release(slot)
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
            self.slot_req[slot] = req
            self.slot_remaining[slot] = req.max_new
            self._progress += 1
            logits = self.prefiller.prefill(self.cache, slot, req.prompt, rid=req.rid)
            self.cache.commit(slot, req.prompt)
            first = M.sample_tokens(logits[:, -1], np.float32([p.temperature]))
            self._emit(slot, int(first.cpu()[0]))

    def _active(self) -> bool:
        return any(r is not None for r in self.slot_req)

    def step(self) -> bool:
        """One engine iteration: admit (blocking prefill), then one decode
        step for every active slot, read back at once. Returns True while
        work remains."""
        if self._closed:
            raise RuntimeError("engine is closed")
        t0 = time.perf_counter()
        self._run_t0 = t0
        try:
            self._admit()
            if self._active():
                # feed each slot's last generated token (prefill already
                # sampled the first token from its own logits)
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
        finally:
            self._serve_seconds += time.perf_counter() - t0
            self._run_t0 = None
        return bool(self.scheduler.pending() or self._active())

    def drain(self) -> None:
        """Step until no queued or active work remains; raises instead of
        spinning when queued requests can never be admitted."""
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
        """Serving metrics snapshot, with the reference's serialized-mode
        key names (the continuous-batching and speculative keys report
        their off values)."""
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
            "mode": "serialized",
            "mixed_steps": 0,
            "mixed_budget": 0,
            "inflight_depth": 0,
            "inflight": 0,
            "fused_attn": self.fused_attn,
            "spec/enabled": False,
            "spec/policy": "off",
            "spec/k": 0,
            "spec/rounds": 0,
            "spec/proposed": 0,
            "spec/accepted": 0,
            "spec/acceptance_rate": 0.0,
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
