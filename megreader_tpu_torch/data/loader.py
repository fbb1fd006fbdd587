"""Batching loader: dataset dicts -> stacked numpy batches, prefetched.

A port of ``megreader_tpu/data/loader.py``: the recognition, detection and
spotting collates (``detection_collate`` stacks host GT maps in compact wire
types; ``detection_collate_polys`` pads polygon lists for the device GT maps,
and ``spotting_collate`` adds each polygon's transcript), and
the same shuffle (``np.random.default_rng(seed + epoch)``, the epoch counted
from 1 at each ``iter``), so both packages visit a dataset in the same order, index for
index; ``drop_last``; a pool that fetches the samples of a batch, of threads
or (``worker_mode='process'``) of processes; a background thread that keeps
``prefetch`` batches ready. Batches stay numpy (images uint8): the train
step's prepare moves them to the card and casts there.

Process workers start from a ``forkserver`` (never ``fork``: the parent runs
torch's threads by then), and each receives the dataset once, through the
pool's initializer, so a dataset must pickle. They run the dataset's numpy
code only and never touch the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Sequence, Tuple

import numpy as np

from ..core.charset import Charset

_STACK_KEYS_REC = ("image", "size")
_STACK_KEYS_DET = ("image", "gt", "mask", "thresh_map", "thresh_mask", "scale")
_LIST_KEYS = ("polygons", "ignore", "texts", "text", "filename")


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


def detection_collate(samples: Sequence[Dict]) -> Dict:
    """Host GT maps stacked in compact wire types: images and binary maps
    uint8, the threshold map float16 (the device casts after the copy);
    polygons, flags, texts and names kept as lists."""
    batch = {k: np.stack([s[k] for s in samples]) for k in _STACK_KEYS_DET if k in samples[0]}
    for k in ("gt", "mask", "thresh_mask"):
        if k in batch:
            batch[k] = batch[k].astype(np.uint8)
    if "thresh_map" in batch:
        batch["thresh_map"] = batch["thresh_map"].astype(np.float16)
    for k in _LIST_KEYS:
        if k in samples[0]:
            batch[k] = [s[k] for s in samples]
    return batch


def detection_collate_polys(samples: Sequence[Dict], max_polys: int = 16) -> Dict:
    """Images and padded polygon buffers for the device GT maps: polys (B, P,
    4, 2) float32, poly_valid and poly_ignore (B, P) bool, plus the list keys.

    ``max_polys`` is the least capacity, not a cap: P doubles until every
    page's polygons fit, so no instance is dropped."""
    from ..ops.gt_maps import pad_polygons

    batch = {"image": np.stack([s["image"] for s in samples])}
    if "scale" in samples[0]:
        batch["scale"] = np.stack([s["scale"] for s in samples])
    cap = max_polys
    need = max((len(s["polygons"]) for s in samples), default=0)
    while cap < need:
        cap *= 2
    polys, valid, ign = zip(*(pad_polygons(s["polygons"], s["ignore"], cap) for s in samples))
    batch["polys"] = np.stack(polys)
    batch["poly_valid"] = np.stack(valid)
    batch["poly_ignore"] = np.stack(ign)
    for k in _LIST_KEYS:
        if k in samples[0]:
            batch[k] = [s[k] for s in samples]
    return batch


def spotting_collate(samples: Sequence[Dict], charset: Charset, max_polys: int = 16,
                     max_label_len: int = 16) -> Dict:
    """RoI spotting: ``detection_collate_polys`` plus each polygon's
    transcript, encoded in slot order: label (B, P, max_label_len) and
    label_length (B, P) int32, zero in the empty slots. Host GT maps, where
    the samples carry them (the shared-trunk spotter's joint training), pass
    through in ``detection_collate``'s compact types."""
    batch = detection_collate_polys(samples, max_polys)
    B, cap = batch["poly_valid"].shape
    labels = np.zeros((B, cap, max_label_len), np.int32)
    lengths = np.zeros((B, cap), np.int32)
    for b, s in enumerate(samples):
        texts = s.get("texts") or []
        if texts:
            enc, lens = charset.encode_batch(texts[:cap], max_label_len)
            labels[b, :len(enc)] = enc
            lengths[b, :len(enc)] = lens
    batch["label"] = labels
    batch["label_length"] = lengths
    if "gt" in samples[0]:
        for k in ("gt", "mask", "thresh_mask"):
            batch[k] = np.stack([s[k] for s in samples]).astype(np.uint8)
        batch["thresh_map"] = np.stack([s["thresh_map"] for s in samples]).astype(np.float16)
    return batch


#: the dataset of a process worker, set once by the pool's initializer
_worker_dataset = None


def _init_worker(dataset) -> None:
    global _worker_dataset
    _worker_dataset = dataset


def _worker_get(i: int) -> Dict:
    return _worker_dataset[i]


def _rank_and_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Loader:
    """Iterate a dataset in batches with optional shuffle and prefetch.

    ``host_shard`` gives each rank of the process group that is up every
    ``world``-th index of the (shuffled) order from its rank on, as the JAX
    loader gives each host; the identity in one process. ``worker_mode`` is
    ``'thread'`` or ``'process'``; either gives the same batches."""

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
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.host_shard = host_shard
        self.workers = workers
        self.worker_mode = worker_mode
        self._pool = None
        self.epoch = 0

    def close(self):
        """Shut the worker pool down."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown
            pass

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.host_shard:
            rank, world = _rank_and_world()
            idx = idx[rank::world]
        return idx

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _make_pool(self):
        if self.worker_mode == "process":
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            return ProcessPoolExecutor(max_workers=self.workers,
                                       mp_context=multiprocessing.get_context("forkserver"),
                                       initializer=_init_worker, initargs=(self.dataset,))
        from concurrent.futures import ThreadPoolExecutor

        return ThreadPoolExecutor(max_workers=self.workers)

    def _fetch(self, chunk) -> Dict:
        if self.workers > 1:
            if self._pool is None:
                self._pool = self._make_pool()
            get = _worker_get if self.worker_mode == "process" else self.dataset.__getitem__
            samples = list(self._pool.map(get, [int(i) for i in chunk]))
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
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b in self._batches():
                    if not put(b):
                        return
            except BaseException as e:  # raised in the consumer, not lost here
                put(e)
            finally:
                put(done)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()  # a consumer that stops early releases the thread
