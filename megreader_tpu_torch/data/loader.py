"""Batching loader: dataset dicts -> stacked numpy batches, prefetched.

A port of ``megreader_tpu/data/loader.py`` for recognition: the same shuffle
(``np.random.default_rng(seed + epoch)``, the epoch counted from 1 at each
``iter``), so both packages visit a dataset in the same order, index for
index; ``drop_last``; a thread pool that fetches the samples of a batch; a
background thread that keeps ``prefetch`` batches ready. Batches stay numpy
(images uint8): the train step's prepare moves them to the card and casts
there.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Sequence

import numpy as np

from ..core.charset import Charset

_STACK_KEYS_REC = ("image", "size")


def recognition_collate(samples: Sequence[Dict], charset: Charset, max_label_len: int = 32) -> Dict:
    """{image, size} stacked, texts encoded to (B, max_label_len) int32
    labels (0-padded) and (B,) int32 lengths, the texts kept as a list."""
    batch = {k: np.stack([s[k] for s in samples]) for k in _STACK_KEYS_REC if k in samples[0]}
    texts = [s["text"] for s in samples]
    labels, lengths = charset.encode_batch(texts, max_label_len)
    batch["label"] = labels
    batch["label_length"] = lengths
    batch["text"] = texts
    return batch


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Loader:
    """Iterate a dataset in batches with optional shuffle and prefetch.

    ``host_shard`` is the identity in one process; with a process group of
    several ranks it raises (multi-GPU data parallelism is ROADMAP Queue 1
    item 14). ``worker_mode='process'`` raises (ROADMAP Queue 1 item 7)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Callable[[Sequence[Dict]], Dict],
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        host_shard: bool = False,
        workers: int = 4,
        worker_mode: str = "thread",
    ):
        if worker_mode != "thread":
            raise NotImplementedError(
                f"worker_mode={worker_mode!r}: only the thread pool is ported "
                "(ROADMAP Queue 1 item 7)"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.host_shard = host_shard
        self.workers = workers
        self._pool = None
        self.epoch = 0

    def close(self):
        """Shut the worker pool down."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.host_shard and _world_size() > 1:
            raise NotImplementedError(
                "host_shard across ranks needs multi-GPU data parallelism (ROADMAP Queue 1 item 14)"
            )
        return idx

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _fetch(self, chunk) -> Dict:
        if self.workers > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.workers)
            samples = list(self._pool.map(self.dataset.__getitem__, [int(i) for i in chunk]))
        else:
            samples = [self.dataset[int(i)] for i in chunk]
        return self.collate(samples)

    def _batches(self) -> Iterator[Dict]:
        idx = self._indices()
        end = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        for s in range(0, end, self.batch_size):
            yield self._fetch(idx[s : s + self.batch_size])

    def __iter__(self) -> Iterator[Dict]:
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            finally:
                q.put(done)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
