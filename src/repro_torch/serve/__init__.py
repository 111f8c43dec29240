"""Serving subsystem: cache managers (slot, paged and prefix-sharing),
scheduler, chunked prefill, the snapshot ring, the draft policies of
speculative decoding and the engine facade, serialized, speculative or
continuous (counterpart of ``repro.serve``)."""

from repro_torch.serve.api import Request, RequestHandle, SamplingParams
from repro_torch.serve.boundary import SnapshotRing, host_copy
from repro_torch.serve.cache import (
    CACHE_BACKENDS,
    CapacityError,
    PagedKVCache,
    SlotCache,
    make_cache,
)
from repro_torch.serve.engine import KernelStatsAccumulator, ServeEngine, StepMonitor
from repro_torch.serve.prefill import ChunkedPrefill, PrefillCursor, make_prefiller
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import (
    SCHEDULERS,
    BestFitScheduler,
    FCFSScheduler,
    PriorityScheduler,
    Scheduler,
    ShortestPromptFirstScheduler,
    make_scheduler,
)
from repro_torch.serve.spec import SPEC_POLICIES, DraftModel, DraftPolicy, SelfDraft, make_spec
from repro_torch.serve.stats import LatencyHistogram

__all__ = [
    "CACHE_BACKENDS", "CapacityError", "PagedKVCache", "PrefixCache", "SlotCache", "make_cache",
    "LatencyHistogram", "host_copy", "KernelStatsAccumulator", "Request", "RequestHandle",
    "SamplingParams", "ServeEngine", "StepMonitor", "ChunkedPrefill", "PrefillCursor",
    "make_prefiller", "SnapshotRing",
    "SCHEDULERS", "BestFitScheduler", "FCFSScheduler", "PriorityScheduler", "Scheduler",
    "ShortestPromptFirstScheduler", "make_scheduler",
    "DraftModel", "DraftPolicy", "SPEC_POLICIES", "SelfDraft", "make_spec",
]
