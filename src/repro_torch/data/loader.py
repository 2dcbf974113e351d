"""Host data loading for the LM trainer (port of ``repro.data.loader``):
per-process sharded batching with a background prefetch thread.

Each process owns ``1/process_count`` of the global batch; ``ShardedLoader``
yields that slice.  One process by default (rank 0 of 1), or the
``torch.distributed`` group's rank and size when one is initialised.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def _process() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedLoader:
    def __init__(
        self,
        generator: Callable[[int], dict],
        *,
        global_batch: int,
        process_index: int | None = None,
        process_count: int | None = None,
        prefetch: int = 2,
    ):
        """``generator(step) -> dict of np arrays`` producing the global
        batch; the loader slices out this process's shard and prefetches."""
        self.generator = generator
        self.global_batch = global_batch
        rank, size = _process()
        self.pi = rank if process_index is None else process_index
        self.pc = size if process_count is None else process_count
        assert global_batch % self.pc == 0
        self.local_batch = global_batch // self.pc
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _local_slice(self, batch: dict) -> dict:
        lo = self.pi * self.local_batch
        hi = lo + self.local_batch
        return {k: v[lo:hi] for k, v in batch.items()}

    def _fill(self):
        step = 0
        while not self._stop.is_set():
            try:
                item = self._local_slice(self.generator(step))
                self._q.put(item, timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()


def synthetic_lm_generator(vocab_size: int, seq_len: int, global_batch: int,
                           seed: int = 0):
    """Zipf token batches with next-token labels (numpy-identical to JAX's)."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def gen(step: int) -> dict:
        rng = np.random.default_rng(seed + step)
        toks = rng.choice(vocab_size, size=(global_batch, seq_len + 1), p=probs)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    return gen
