"""Deterministic synthetic data pipeline (counterpart of
repro/data/pipeline.py, copied: numpy only).

Produces packed LM batches with document structure (Zipf-distributed
tokens, EOS-separated documents), sharded across hosts: each process
materializes only its slice of the global batch (process_index-based),
so the pipeline scales to multi-pod topologies without a central reader.
A background prefetch thread keeps one batch in flight.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 2
    mean_doc_len: int = 512
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if self.global_batch % self.process_count:
            raise ValueError("global_batch must divide across processes")
        self.local_batch = self.global_batch // self.process_count

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic per-(step, process) packed batch."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.process_index)
        b, s = self.local_batch, self.seq_len
        # Zipf-ish token distribution (truncated)
        ranks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        tokens = (ranks % (self.vocab_size - 3)) + 3
        # EOS-separated document packing
        doc_break = rng.random((b, s + 1)) < 1.0 / self.mean_doc_len
        tokens = np.where(doc_break, self.eos_id, tokens)
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }


def make_batch_iterator(ds: SyntheticTokens, start_step: int = 0,
                        prefetch: int = 2) -> Iterator[Dict[str,
                                                            np.ndarray]]:
    """Background-prefetched iterator (restartable from any step)."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
