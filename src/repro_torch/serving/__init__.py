"""Continuous-batching VP serving (port of `repro.serving`): paged cache,
scheduler, runner (one CUDA graph per decode bucket on the card), engine,
and the resilience layer (fault injection, SLO classes, graceful
degradation)."""
from .page_cache import PagedKVCache, SubSpec, plan_cache, page_group_bytes
from .scheduler import Request, RunningRequest, Scheduler, SLOClass, \
    SLO_CLASSES, VirtualClock, WallClock
from .runner import ModelRunner, oracle_generate, supports_chunked
from .engine import ServingEngine
from .faults import FaultPlan, KVBitFlip, LogitPoison, PagePressure, \
    SlowStep, TransientComputeError, TransientFault

__all__ = [
    "PagedKVCache", "SubSpec", "plan_cache", "page_group_bytes",
    "Request", "RunningRequest", "Scheduler", "SLOClass", "SLO_CLASSES",
    "VirtualClock", "WallClock",
    "ModelRunner", "oracle_generate", "supports_chunked", "ServingEngine",
    "FaultPlan", "KVBitFlip", "LogitPoison", "PagePressure", "SlowStep",
    "TransientComputeError", "TransientFault",
]
