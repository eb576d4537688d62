"""Epoch-based batch loader of numpy batches, as the JAX package's.

Batches are dicts of stacked numpy arrays: points [B, N, 3] float32,
labels [B, N] int32 and category [B] int32 (PartNet items have no
category: zeros).  They stay numpy here; HypHCSystem copies them to its
device on the thread that runs the step, so the prefetch threads never
touch CUDA.
"""
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _collate(items):
    if len(items[0]) == 3:
        pts, cls, seg = zip(*items)
        category = np.asarray(cls, np.int32)
    else:
        pts, seg = zip(*items)
        category = np.zeros(len(pts), np.int32)
    return {"points": np.stack(pts)[..., :3].astype(np.float32), "category": category,
            "labels": np.stack(seg).astype(np.int32)}


class DataLoader:
    """Epoch iterator over a map-style dataset.

    With `shuffle`, each epoch's order is a permutation drawn from one
    numpy Generator seeded with `seed` at construction, so successive
    epochs differ and two loaders built alike give the same batches.  With
    `drop_last` a short final batch is dropped.  With num_workers > 0 a
    pool of that many threads reads the items (the C++ txt parser releases
    the GIL) and up to `prefetch` collated batches wait in a queue.
    """

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 seed=0, num_workers=0, prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(2, prefetch)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            yield idx

    def __iter__(self):
        if self.num_workers <= 0:
            for idx in self._batch_indices():
                yield _collate([self.dataset[int(i)] for i in idx])
            return
        yield from self._iter_prefetch()

    def _iter_prefetch(self):
        batches = list(self._batch_indices())
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(pool):
            try:
                for idx in batches:
                    if stop.is_set():
                        return
                    items = list(pool.map(lambda i: self.dataset[int(i)], idx))
                    if not put(_collate(items)):
                        return
                put(done)
            except BaseException as e:  # handed to the consumer, which raises it
                put(("error", e))

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool, \
                ThreadPoolExecutor(max_workers=1) as driver:
            producer = driver.submit(produce, pool)
            try:
                while True:
                    batch = q.get()
                    if batch is done:
                        break
                    if isinstance(batch, tuple):
                        raise batch[1]
                    yield batch
            finally:
                stop.set()
        producer.result()
