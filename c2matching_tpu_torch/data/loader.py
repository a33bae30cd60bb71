"""Synchronous batch loader for evaluation.

Counterpart of the val/test use of ``c2matching_tpu/data/loader.py``: the
dataset's items in order, one a batch, stacked by ``default_collate``. The threaded prefetch and the shuffling samplers of
training wait for the train runner.
"""
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
    """Iterate ``dataset`` in order, one item a batch (the reference's
    val/test loader)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield default_collate([self.dataset[i]])
