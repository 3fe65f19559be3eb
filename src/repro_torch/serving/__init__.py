"""Serving: the continuous-batching engine (dense and paged cache layouts)
and the paged KV pool with its prefix cache."""
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_cache import PagePool, PagedKVCache

__all__ = ["PagePool", "PagedKVCache", "Request", "ServeEngine"]
