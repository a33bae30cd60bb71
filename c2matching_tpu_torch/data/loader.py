"""Batch loader: numpy NHWC batches, with threaded prefetch for training.

Counterpart of ``c2matching_tpu/data/loader.py``: indices from a sampler,
or ``RandomState(seed + epoch)``'s permutation when shuffling, or in
order; batches of ``batch_size`` stacked by ``default_collate``, the last
partial one dropped with ``drop_last``; with ``num_workers`` > 0 a
producer thread keeps two batches ahead, its items read by a pool of that
many threads (the decode and the bicubic chain spend their time in numpy
and zlib, which release the GIL). The datasets draw their augmentation
from the global ``random`` state, as the JAX package's do, so with more
than one worker the draw each item gets depends on the threads' order;
the order of the items does not.
"""
import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def default_collate(items):
    """Stack a list of sample dicts into a batch dict. Arrays are stacked;
    scalars become numpy arrays; strings/tuples become lists."""
    batch = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        first = vals[0]
        if isinstance(first, np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(first, (bool, int, float, np.bool_, np.integer,
                                np.floating)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals
    return batch


class DataLoader:
    """Iterate ``dataset`` in batches (by default: in order, one item a
    batch, synchronously, which is the val/test loader).

    Args:
        dataset: indexable with __len__.
        batch_size: items per batch.
        sampler: an iterable of indices (a fresh iterator per epoch), or
            None.
        shuffle: with no sampler, a permutation per epoch.
        num_workers: prefetch threads (0: synchronous).
        drop_last: drop the last partial batch.
        seed: the base of the shuffle's seed (seed + epoch).
    """

    def __init__(self, dataset, batch_size=1, sampler=None, shuffle=False,
                 num_workers=0, drop_last=False, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _indices(self):
        if self.sampler is not None:
            return iter(self.sampler)
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            return iter(rng.permutation(n).tolist())
        return iter(range(n))

    def __len__(self):
        n = len(self.sampler if self.sampler is not None else self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        batches = _batched(self._indices(), self.batch_size, self.drop_last)
        if self.num_workers <= 0:
            for batch_idx in batches:
                yield default_collate([self.dataset[i] for i in batch_idx])
            return
        yield from self._prefetch_iter(batches)

    def _prefetch_iter(self, batches, depth=2):
        """Up to ``depth`` batches ahead, each read by the thread pool."""
        out_q = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def producer():
            # the end marker (None, or the exception) goes out in a finally:
            # a raising __getitem__ reaches the consumer as the error
            err = None
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            break
                        items = list(pool.map(self.dataset.__getitem__,
                                              batch_idx))
                        out_q.put(default_collate(items))
            except Exception as e:  # noqa: BLE001 - re-raised by the consumer
                err = e
            finally:
                out_q.put(err)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            # drain so that a producer blocked on a full queue can finish
            while thread.is_alive():
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()


def _batched(index_iter, batch_size, drop_last):
    while True:
        chunk = list(itertools.islice(index_iter, batch_size))
        if not chunk:
            return
        if len(chunk) < batch_size and drop_last:
            return
        yield chunk
