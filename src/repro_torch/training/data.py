"""Deterministic synthetic token pipeline with host-side prefetch — a copy
of :mod:`repro.training.data` (the port imports nothing of the reference
package): the same numpy batches for the same seed, step and process.

Real deployments swap in a tokenized corpus reader; the interface (iterator
of {"tokens","labels"} with per-host sharding by process index) is what the
train loop and the elastic-restart logic rely on.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1):
        self.vocab = vocab
        self.batch = batch // process_count
        self.seq = seq
        self.seed = seed
        self.process_index = process_index
        self.step = 0
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = False
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _gen(self, step: int):
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.process_index)
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _producer(self):
        step = self.step
        while not self._stop:
            try:
                self._q.put(self._gen(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        batch = self._q.get()
        self.step += 1
        return batch

    def seek(self, step: int):
        """Restart-from-checkpoint: drop the prefetch queue, regenerate."""
        self._stop = True
        self._thread.join(timeout=2)
        while not self._q.empty():
            self._q.get_nowait()
        self.step = step
        self._stop = False
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def close(self):
        self._stop = True
