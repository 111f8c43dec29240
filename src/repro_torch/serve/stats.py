"""Streaming latency statistics for the serving engine's ``metrics()``.

Serving SLOs are stated in percentiles (TTFT p95, TPOT p99 — tail latency
is what users feel), and a long-lived engine cannot keep a per-request list
just to sort it at metrics time. :class:`LatencyHistogram` is the standard
fix: log-spaced bins over the latency range, O(bins) memory forever,
percentile queries by rank-walking the counts. The resolution trade is
explicit — a percentile is reported as its bin's UPPER edge (clamped to the
observed max), i.e. a pessimistic estimate that is off by at most one bin
ratio (~24% at the default 96 bins across 9 decades). For SLO gating,
pessimistic-and-monotone beats exact-but-unbounded.

The engine namespaces these summaries ``slo/`` in ``metrics()``:
``slo/ttft_p50_s``, ``slo/tpot_p95_s``, ... — see ServeEngine.metrics.
"""

from __future__ import annotations

import math


class LatencyHistogram:
    """Log-spaced streaming histogram over ``[lo, hi)`` seconds.

    ``observe(v)`` clamps into the edge bins (a latency above ``hi`` still
    counts — it just saturates the top bin; ``vmax`` keeps the true max).
    ``percentile(q)`` returns the upper edge of the bin holding the q-th
    ranked observation, clamped to ``[vmin, vmax]``; by construction
    ``percentile`` is monotone in q, so p50 <= p95 <= p99 always holds.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e3, bins: int = 96):
        if not (0 < lo < hi) or bins < 1:
            raise ValueError(f"bad histogram shape: lo={lo} hi={hi} bins={bins}")
        self.lo, self.hi, self.bins = float(lo), float(hi), int(bins)
        self._span = math.log(self.hi / self.lo)
        self.counts = [0] * self.bins
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if v <= self.lo:
            i = 0
        else:
            i = min(self.bins - 1,
                    int(math.log(v / self.lo) / self._span * self.bins))
        self.counts[i] += 1

    def percentile(self, q: float) -> float:
        """q in [0, 100] -> seconds (0.0 when empty)."""
        if self.n == 0:
            return 0.0
        rank = min(max(math.ceil(q / 100.0 * self.n), 1), self.n)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                edge = self.lo * math.exp((i + 1) / self.bins * self._span)
                return min(max(edge, self.vmin), self.vmax)
        return self.vmax  # unreachable: counts sum to n

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into this histogram (bin-wise add) and return self.

        Merging only makes sense between identically-binned histograms —
        multi-engine/replica aggregation constructs them from the same
        defaults, so shape mismatch is a caller bug, not a case to resample.
        The merged percentiles are exactly what a single histogram observing
        both streams would report; mean/min/max are exact.
        """
        if (self.lo, self.hi, self.bins) != (other.lo, other.hi, other.bins):
            raise ValueError(
                f"cannot merge histograms with different bin layouts: "
                f"({self.lo}, {self.hi}, {self.bins}) vs "
                f"({other.lo}, {other.hi}, {other.bins})")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def summary(self, prefix: str) -> dict:
        """The ``metrics()`` fragment for this series: p50/p95/p99 + count.
        (``max`` and ``mean`` ride along because SLO reports quote both the
        worst case and the average alongside the tail.)"""
        return {
            f"{prefix}_p50_s": self.percentile(50),
            f"{prefix}_p95_s": self.percentile(95),
            f"{prefix}_p99_s": self.percentile(99),
            f"{prefix}_mean_s": self.mean,
            f"{prefix}_max_s": self.vmax,
            f"{prefix}_count": self.n,
        }
