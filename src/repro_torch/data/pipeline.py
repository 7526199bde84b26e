"""Device-feeding data pipeline: host generators -> device batches.

Port of ``repro.data.pipeline``: a background prefetch thread drives the
numpy generator while the previous step runs, and each batch is placed on
the training device (the reference places it with the mesh's batch
sharding; one device here).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class Pipeline:
    def __init__(self, gen: Iterator[Dict[str, np.ndarray]], *,
                 device: torch.device, prefetch: int = 2):
        self._gen = gen
        self._device = device
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._gen:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def _place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device)
                for k, v in batch.items()}

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return self._place(item)

    def close(self):
        """Stop the worker after the batch it is making (it may be blocked
        on a full queue until the consumer takes one more)."""
        self._stop.set()


def lm_generator(vocab_size: int, seq_len: int, batch: int, *, seed: int = 0,
                 steps: Optional[int] = None):
    from repro_torch.data.synthetic import markov_stream
    it = markov_stream(vocab_size, seq_len, batch, seed=seed)
    n = 0
    while steps is None or n < steps:
        arr = next(it)
        yield {"tokens": arr[:, :-1], "targets": arr[:, 1:]}
        n += 1
