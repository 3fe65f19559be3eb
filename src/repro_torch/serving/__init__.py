"""Serving: the continuous-batching engine (dense and paged cache layouts),
the paged KV pool with its prefix cache, and the async front end with
data-parallel routing."""
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_cache import PagePool, PagedKVCache
from repro_torch.serving.scheduler import (
    AsyncRequest, AsyncScheduler, AsyncServeEngine,
    DataParallelAsyncEngine, PrefixAffinityRouter, TokenStream,
    VirtualClock, WallClock, interleave_supported, latency_metrics,
    poisson_arrivals, serve_open_loop,
)

__all__ = ["AsyncRequest", "AsyncScheduler", "AsyncServeEngine",
           "DataParallelAsyncEngine", "PagePool", "PagedKVCache",
           "PrefixAffinityRouter", "Request", "ServeEngine", "TokenStream",
           "VirtualClock", "WallClock", "interleave_supported",
           "latency_metrics", "poisson_arrivals", "serve_open_loop"]
