"""Data pipeline: synthetic LM streams + binary token shards, host-sharded,
with background prefetch.  The port of the JAX package's
``data/pipeline.py``, numpy only: the same seeds give the same tokens in
both packages.

The synthetic stream produces *learnable* sequences (affine next-token
recurrences per document, plus noise tokens) so a run demonstrably reduces
loss rather than fitting random noise.  The trainer reads the *global* batch
(one host) and gives pod rank r its rows, as the reference's ``P(dp)``
sharding does.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    kind: str = "synthetic"        # synthetic | binary
    path: Optional[str] = None     # binary shard file (uint16/uint32)
    seed: int = 0
    noise: float = 0.05


class SyntheticLM:
    """Deterministic affine-recurrence documents: t_{i+1} = (a*t_i + b) % V."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, host_count: int = 1):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed * 9_973 + host_id)
        self.host_id = host_id
        self.host_count = host_count
        if cfg.global_batch % host_count:
            raise ValueError(f"global_batch {cfg.global_batch} must divide "
                             f"across {host_count} hosts")
        self.local_batch = cfg.global_batch // host_count

    def __iter__(self) -> Iterator[np.ndarray]:
        V = self.cfg.vocab_size
        S = self.cfg.seq_len + 1
        a_choices = np.array([3, 5, 7, 11, 13], np.int64)
        while True:
            a = self.rng.choice(a_choices, size=(self.local_batch, 1))
            b = self.rng.integers(0, 17, size=(self.local_batch, 1))
            t0 = self.rng.integers(0, V, size=(self.local_batch, 1))
            toks = np.empty((self.local_batch, S), np.int64)
            toks[:, :1] = t0
            for i in range(1, S):
                toks[:, i:i + 1] = (a * toks[:, i - 1:i] + b) % V
            if self.cfg.noise > 0:
                mask = self.rng.random((self.local_batch, S)) < self.cfg.noise
                toks[mask] = self.rng.integers(0, V, size=int(mask.sum()))
            yield toks.astype(np.int32)


class BinaryTokens:
    """Flat binary token file (np.uint16/uint32), strided across hosts."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, host_count: int = 1,
                 dtype=np.uint16):
        if cfg.path is None:
            raise ValueError("DataConfig(kind='binary') needs a path")
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.host_id = host_id
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count

    def __iter__(self) -> Iterator[np.ndarray]:
        S = self.cfg.seq_len + 1
        n_seq = len(self.data) // S
        if n_seq == 0:
            raise ValueError(f"{self.cfg.path}: {len(self.data)} tokens hold no "
                             f"sequence of {S}")
        idx = self.host_id
        while True:
            rows = []
            for _ in range(self.local_batch):
                r = self.data[(idx % n_seq) * S:(idx % n_seq + 1) * S]
                rows.append(np.asarray(r, np.int32))
                idx += self.host_count
            yield np.stack(rows)


class Prefetcher:
    """Background-thread prefetch (depth-N queue): keeps the step loop fed."""

    def __init__(self, it: Iterator[np.ndarray], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass


def make_pipeline(cfg: DataConfig, *, prefetch: int = 2, host_id: int = 0,
                  host_count: int = 1):
    """The token stream of `cfg`: ``host_count`` hosts each read their
    share (the port's trainer reads the global batch: one host)."""
    if cfg.kind == "binary":
        src: Iterator[np.ndarray] = iter(BinaryTokens(cfg, host_id, host_count))
    elif cfg.kind == "synthetic":
        src = iter(SyntheticLM(cfg, host_id, host_count))
    else:
        raise ValueError(f"unknown data kind {cfg.kind!r}; have synthetic|binary")
    return Prefetcher(src, depth=prefetch) if prefetch else src
