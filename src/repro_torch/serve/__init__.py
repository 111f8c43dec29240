"""Serving subsystem, serialized mode: cache managers, scheduler, chunked
prefill and the engine facade (counterpart of ``repro.serve``)."""

from repro_torch.serve.api import Request, RequestHandle, SamplingParams
from repro_torch.serve.boundary import host_copy
from repro_torch.serve.cache import (
    CACHE_BACKENDS,
    CapacityError,
    PagedKVCache,
    SlotCache,
    make_cache,
)
from repro_torch.serve.engine import KernelStatsAccumulator, ServeEngine, StepMonitor
from repro_torch.serve.prefill import ChunkedPrefill, make_prefiller
from repro_torch.serve.scheduler import (
    SCHEDULERS,
    BestFitScheduler,
    FCFSScheduler,
    PriorityScheduler,
    Scheduler,
    ShortestPromptFirstScheduler,
    make_scheduler,
)
from repro_torch.serve.stats import LatencyHistogram

__all__ = [
    "CACHE_BACKENDS", "CapacityError", "PagedKVCache", "SlotCache", "make_cache",
    "LatencyHistogram", "host_copy", "KernelStatsAccumulator", "Request", "RequestHandle",
    "SamplingParams", "ServeEngine", "StepMonitor", "ChunkedPrefill", "make_prefiller",
    "SCHEDULERS", "BestFitScheduler", "FCFSScheduler", "PriorityScheduler", "Scheduler",
    "ShortestPromptFirstScheduler", "make_scheduler",
]
