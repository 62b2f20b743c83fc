"""Sharded input pipeline with prefetch (the reference's
``data/pipeline.py``, paper §IV-D).

``ShardedLoader`` yields batches of a host-resident dataset in a
deterministic order: the same seed, batch size and index set give the
reference's batches, through ``set_batch`` / ``set_indices`` too.
:meth:`ShardedLoader.next_indices` advances it and returns only the
sample indices, for a caller that keeps the data on the card and gathers
there.  ``Prefetcher`` keeps ``depth`` batches on the device ahead of
compute from a background thread.
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class ShardedLoader:
    """Deterministic infinite batch iterator over a host-resident dataset."""

    def __init__(self, data: Dict[str, np.ndarray], batch: int, *,
                 seed: int = 0, indices: Optional[np.ndarray] = None):
        self.data = data
        self.batch = batch
        self.indices = indices if indices is not None else np.arange(
            len(next(iter(data.values()))))
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(self.indices)
        self._cursor = 0

    def set_batch(self, batch: int) -> None:
        self.batch = batch

    def set_indices(self, indices: np.ndarray) -> None:
        """Dynamic reallocation (the Hermes allocator moves the shard)."""
        self.indices = indices
        self._order = self.rng.permutation(self.indices)
        self._cursor = 0

    def next_indices(self) -> np.ndarray:
        """The sample indices of the next batch (reshuffled when the
        current permutation cannot fill a whole batch)."""
        if self._cursor + self.batch > len(self._order):
            self._order = self.rng.permutation(self.indices)
            self._cursor = 0
        idx = self._order[self._cursor:self._cursor + self.batch]
        self._cursor += self.batch
        return idx

    def __next__(self) -> Dict[str, np.ndarray]:
        idx = self.next_indices()
        return {k: v[idx] for k, v in self.data.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def epoch_steps(self) -> int:
        return max(1, len(self.indices) // self.batch)


class Prefetcher:
    """Keeps ``depth`` device-resident batches in flight ahead of compute.
    Call :meth:`close` when done: it stops and joins the thread."""

    def __init__(self, loader: ShardedLoader, device, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _run(self):
        while not self._stop.is_set():
            batch = self._put_device(next(self.loader))
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=1.0)
                    break
                except _queue.Full:
                    continue

    def __next__(self) -> Dict[str, torch.Tensor]:
        return self.q.get()

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
