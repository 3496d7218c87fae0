"""Deterministic synthetic data pipeline with per-host sharding + prefetch.

Production shape: each host generates only its shard of the global batch
(``host_batch = global_batch / n_hosts``), deterministically from
``(seed, step, host_id)`` so restarts and elastic resizes reproduce the
same global stream regardless of host count.  A background thread
prefetches ``prefetch`` steps ahead, overlapping host-side generation
with device compute.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..models.config import ArchConfig, ShapeConfig


@dataclass
class DataConfig:
    seed: int = 1234
    prefetch: int = 2


class SyntheticTokenPipeline:
    """Deterministic LM token batches (plus stub embeddings for the
    audio/vision frontends)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 data_cfg: Optional[DataConfig] = None,
                 host_id: int = 0, n_hosts: int = 1):
        assert shape.global_batch % n_hosts == 0
        self.cfg = cfg
        self.shape = shape
        self.dc = data_cfg or DataConfig()
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.host_batch = shape.global_batch // n_hosts

    # ---------------------------------------------------------------- #
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for ``step`` (pure function of (seed, step, host))."""
        rng = np.random.default_rng(
            (self.dc.seed * 1_000_003 + step) * 4096 + self.host_id)
        b, s = self.host_batch, self.shape.seq_len
        out: Dict[str, np.ndarray] = {}
        if self.cfg.frontend == "token":
            toks = rng.integers(0, self.cfg.vocab, size=(b, s + 1),
                                dtype=np.int32)
            out["tokens"] = toks[:, :-1]
            out["labels"] = toks[:, 1:]
        else:
            out["embeds"] = rng.standard_normal(
                (b, s, self.cfg.d_model)).astype(np.float32)
            out["labels"] = rng.integers(0, self.cfg.vocab, size=(b, s),
                                         dtype=np.int32)
        return out

    # ---------------------------------------------------------------- #
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iterate(0)

    def iterate(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator starting at ``start_step`` (checkpoint
        restore passes the restored step so the stream is seamless)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.dc.prefetch)
        stop = threading.Event()

        def producer() -> None:
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.1)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
