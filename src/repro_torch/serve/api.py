"""Request-lifecycle API v1: sampling params, requests, and handles.

This module is the engine's CLIENT surface — everything a caller needs to
submit work and consume results without touching engine internals:

  * :class:`SamplingParams` — a frozen, validated description of HOW to
    decode one request: greedy (``temperature=0``, the default — bit-
    identical to the pre-v1 argmax path) or stochastic
    (temperature / top-k / top-p) with a per-request ``seed``, plus
    stop-token sequences and the ``max_new`` budget. Hashable and
    reusable across requests; the engine never mutates it.
  * :class:`Request` — one unit of work plus its engine-managed lifecycle
    state: status (``queued -> active -> done | stopped | cancelled``),
    timestamps (submit / admit / first-token / done), and the generated
    tokens. Constructing one directly with ``max_new=`` is the PR-2..4
    batch-mode idiom and still works (``ServeEngine.run``); ``submit()``
    builds them for you.
  * :class:`RequestHandle` — what ``engine.submit()`` returns: a cursor
    over one in-flight request. ``tokens()`` streams tokens as they are
    generated (driving ``engine.step()`` on demand — the engine is
    synchronous, so iterating IS serving), ``result()`` drains to
    completion, ``cancel()`` releases the request's cache resources
    mid-decode (safe under prefix sharing: pages with other live readers
    are decref'd, never zeroed).

The decode-side contract: every request's tokens are produced by ONE
batched sampler (``models.model.sample_tokens``) that follows each decode
step — per-slot temperature/top-k/top-p vectors and a
counter-based PRNG key (``fold_in(PRNGKey(seed), n_tokens_emitted)``), so
the sampled stream depends only on (params, logits), never on slot
assignment, batch composition, or cache backend.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Callable, Iterator, Optional, Sequence


def _normalize_stop(stop) -> tuple[tuple[int, ...], ...]:
    """Coerce ``stop`` into a tuple of token-id tuples. Accepts a single
    sequence of ints or a sequence of sequences — including numpy arrays
    and numpy integer scalars (token ids in this codebase are routinely
    np.int32, e.g. ``stop=prompt[-2:]``), which is why this materializes
    via ``list`` and tests ``numbers.Integral`` instead of truthiness and
    ``isinstance(..., int)``."""
    if stop is None:
        return ()
    seqs = list(stop)
    if not seqs:
        return ()
    if all(isinstance(t, numbers.Integral) for t in seqs):
        seqs = [seqs]  # a single flat stop sequence
    out = tuple(tuple(int(t) for t in seq) for seq in seqs)
    if any(len(seq) == 0 for seq in out):
        raise ValueError("empty stop sequence")
    return out


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How to decode one request.

    ``temperature=0`` (the default) is GREEDY — the sampler lowers to the
    same argmax the pre-v1 engine used, so default-params tokens are
    bit-identical to the PR-4 baselines. ``temperature>0`` samples from the
    (optionally top-k / top-p truncated) softmax with a per-request
    ``seed``; the PRNG key for the i-th generated token is
    ``fold_in(PRNGKey(seed), i)``, making streams reproducible run-to-run
    and independent across slots.

    ``stop``: stop-token sequences (tuple of int tuples; a single flat
    sequence is accepted and wrapped). Generation halts when the output's
    tail equals any sequence; the matching tokens ARE included in the
    output and the request completes with status ``"stopped"``.
    """

    temperature: float = 0.0
    top_k: int = 0          # 0 = off; else keep the k highest logits
    top_p: float = 1.0      # 1.0 = off; else smallest nucleus with mass >= p
    seed: int = 0
    stop: tuple[tuple[int, ...], ...] = ()
    max_new: int = 16

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        object.__setattr__(self, "stop", _normalize_stop(self.stop))
        object.__setattr__(self, "seed", int(self.seed) % (1 << 32))

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


#: Request lifecycle states. QUEUED/ACTIVE are live; the rest are terminal.
QUEUED, ACTIVE, DONE, STOPPED, CANCELLED = (
    "queued", "active", "done", "stopped", "cancelled")
TERMINAL = (DONE, STOPPED, CANCELLED)


@dataclasses.dataclass(eq=False)
class Request:
    """One serving request plus its engine-managed lifecycle state.

    ``eq=False``: a request is an identity, not a value — two requests with
    equal fields are still distinct lifecycle objects. (Field equality
    would also make ``Scheduler.remove``'s ``list.remove`` compare prompt
    ndarrays, whose ambiguous truth value raises the very ValueError that
    method treats as "not queued" — a queued-cancel that silently no-ops.)

    ``max_new`` is the legacy batch-mode knob; when ``params`` is set its
    ``max_new`` wins (the engine syncs the field at submit). ``priority``
    (higher admits first) and ``deadline`` (seconds from submit; the
    engine stamps the absolute ``t_deadline`` and counts
    ``deadline_misses``) only matter under the ``"priority"`` scheduler —
    other policies ignore them by design.
    """

    rid: int
    prompt: "object"  # (S,) int32 np.ndarray
    max_new: int = 16
    params: Optional[SamplingParams] = None
    priority: int = 0
    deadline: Optional[float] = None
    out: Optional[list] = None
    on_token: Optional[Callable] = None
    # engine-managed lifecycle (timestamps are time.perf_counter values)
    status: str = QUEUED
    slot: Optional[int] = None
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_last_tok: float = 0.0  # engine TPOT probe: previous token's emit time
    t_done: float = 0.0
    t_deadline: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.status in TERMINAL


class RequestHandle:
    """Caller's view of one submitted request (returned by
    ``ServeEngine.submit``).

    The engine is synchronous: nothing decodes unless someone calls
    ``engine.step()`` / ``drain()``. The handle's consuming methods do that
    for you — iterating ``tokens()`` steps the engine exactly as far as
    needed to produce the next token (other in-flight requests advance on
    the same steps; continuous batching is preserved), and ``result()``
    drains until this request finishes.
    """

    def __init__(self, engine, request: Request):
        self._engine = engine
        self.request = request

    # --- state --------------------------------------------------------------

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def status(self) -> str:
        return self.request.status

    @property
    def done(self) -> bool:
        return self.request.finished

    # --- consumption --------------------------------------------------------

    def tokens(self) -> Iterator[int]:
        """Stream this request's tokens as they are generated.

        Yields every token exactly once (including any already generated
        before iteration starts). Returns when the request reaches a
        terminal state — including ``cancel()`` from inside the consuming
        loop, which makes the iterator stop after the tokens generated so
        far."""
        cursor = 0
        while True:
            out = self.request.out or []
            while cursor < len(out):
                yield out[cursor]
                cursor += 1
            if self.request.finished:
                return
            self._engine.step()

    def result(self) -> list[int]:
        """Drive the engine until this request finishes; return its tokens."""
        while not self.request.finished:
            self._engine.step()
        return list(self.request.out or [])

    def cancel(self) -> bool:
        """Cancel the request: de-queue it (if still waiting) or release its
        slot and cache resources mid-decode (if active). Tokens generated so
        far stay readable on the handle. Returns False if the request had
        already finished."""
        return self._engine.cancel(self.request)

    def __repr__(self) -> str:
        n = len(self.request.out or [])
        return (f"RequestHandle(rid={self.rid}, status={self.status!r}, "
                f"tokens={n})")


def as_params(req: Request) -> SamplingParams:
    """The request's effective sampling params: explicit ``params`` (its
    ``max_new`` wins) or greedy defaults built from the legacy ``max_new``
    field — the PR-2..4 batch construction decodes exactly as before."""
    if req.params is None:
        return SamplingParams(max_new=req.max_new)
    return req.params


def check_stop(out: Sequence[int], stop: tuple[tuple[int, ...], ...]) -> bool:
    """Does the output's tail equal any stop sequence?"""
    return any(len(out) >= len(seq) and tuple(out[-len(seq):]) == seq
               for seq in stop)
