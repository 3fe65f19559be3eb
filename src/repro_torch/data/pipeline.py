"""Deterministic, sharded, resumable data pipeline.

Port of ``repro.data.pipeline``.  Training data is a synthetic token
stream: a batch is a stateless function of (seed, step, shard), which
gives

  * **determinism / resume**: restarting from step N regenerates exactly
    the stream from N (a checkpoint stores only the step counter);
  * **sharding**: each data-parallel rank draws only its shard;
  * **prefetch**: a background thread keeps ``prefetch`` batches ready.

The draws come from numpy's ``default_rng([seed, step, shard])``, not
JAX's PRNG, so the tokens differ from the reference's stream with the same
properties.  Batches are CPU tensors (int64 tokens, fp32 masks and
embeddings); the trainer moves them to its device.  ``FileSource`` reads
a memory-mapped token file (uint16 / uint32) with the same step-indexed
access.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    frontend: str = "tokens"          # tokens | frames | patches
    d_model: int = 0                  # for embedding front ends
    n_mtp: int = 0


class SyntheticSource:
    """Stateless synthetic batches: batch = f(seed, step, shard)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1):
        if cfg.global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.local_batch = cfg.global_batch // n_shards

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, step, self.shard])
        b, s = self.local_batch, cfg.seq_len
        ones = torch.ones((b, s), dtype=torch.float32)
        if cfg.frontend == "tokens":
            tokens = torch.from_numpy(
                rng.integers(0, cfg.vocab, (b, s + 1 + cfg.n_mtp)))
            batch = {"inputs": tokens[:, :s], "targets": tokens[:, 1:s + 1],
                     "loss_mask": ones}
            if cfg.n_mtp:
                batch["mtp_targets"] = torch.stack(
                    [tokens[:, 2 + j:s + 2 + j] for j in range(cfg.n_mtp)],
                    dim=-1)
            return batch
        inputs = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
        return {"inputs": torch.from_numpy(inputs),
                "targets": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                         (b, s))),
                "loss_mask": ones}


class FileSource:
    """Memory-mapped token file; step-indexed strided reads."""

    def __init__(self, path: str, cfg: DataConfig, shard: int = 0,
                 n_shards: int = 1, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.local_batch = cfg.global_batch // n_shards

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        b, s = self.local_batch, cfg.seq_len
        n_tok = len(self.tokens)
        span = s + 1
        starts = ((step * cfg.global_batch + self.shard * b + np.arange(b))
                  * span) % max(n_tok - span, 1)
        rows = np.stack([self.tokens[st:st + span] for st in starts])
        rows = torch.from_numpy(rows.astype(np.int64) % cfg.vocab)
        return {"inputs": rows[:, :-1], "targets": rows[:, 1:],
                "loss_mask": torch.ones((b, s), dtype=torch.float32)}


class PrefetchIterator:
    """Background-thread prefetch over a step-indexed source."""

    def __init__(self, source, start_step: int = 0, prefetch: int = 2):
        self.source = source
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._next_to_produce = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            step = self._next_to_produce
            batch = self.source.batch_at(step)
            try:
                self._q.put((step, batch), timeout=1.0)
                self._next_to_produce = step + 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def state(self) -> int:
        """Checkpointable position: the next step to be consumed."""
        return self.step

    def close(self):
        self._stop.set()
        self._thread.join()
