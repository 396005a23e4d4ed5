"""Deterministic synthetic data pipeline with per-host sharding + prefetch
(a copy of src/repro/data/pipeline.py: numpy only, the same batches for
the same (seed, step, host)).

Every batch is a pure function of (seed, step, host): after a failure the
restarted job replays exactly the same stream from the restored step — the
data side of the fault-tolerance story (runtime/).  A background prefetch
thread keeps ``depth`` batches ahead of the training loop.

The synthetic stream has next-token structure so the LM has signal to
fit: token[t+1] = (a * token[t] + c + noise) mod vocab, with ``a`` and
``c`` drawn once per dataset seed, noise in {0, 1}, and each row's first
token uniform (the reference's docstring calls it Zipf-ish and the
multiplier per-sequence; its code, copied here, does neither).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLMDataset", "Prefetcher"]


class SyntheticLMDataset:
    """Deterministic, restart-replayable synthetic LM batches."""

    def __init__(
        self,
        vocab: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
    ):
        assert global_batch % num_hosts == 0, (global_batch, num_hosts)
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.host_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The host-local shard of the global batch for ``step``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        b, s, v = self.host_batch, self.seq_len, self.vocab
        # A dataset-global affine bigram process (token[t+1] = a*token[t]+c
        # + small noise mod v): a *learnable* next-token structure so smoke
        # training visibly reduces the loss within tens of steps.
        grng = np.random.default_rng(np.random.SeedSequence([self.seed]))
        a = int(grng.integers(1, 8))
        c = int(grng.integers(0, v))
        start = rng.integers(0, v, size=(b, 1), dtype=np.int64)
        noise = rng.integers(0, 2, size=(b, s), dtype=np.int64)
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = start[:, 0]
        for t in range(1, s):
            toks[:, t] = (a * toks[:, t - 1] + c + noise[:, t]) % v
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = tokens[:, 0]
        return {"tokens": tokens, "labels": labels}

    def iter_from(self, step: int) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            finally:
                self._q.put(self._DONE)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
