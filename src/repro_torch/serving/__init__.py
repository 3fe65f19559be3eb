"""Serving: the continuous-batching engine (dense cache layout)."""
from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
