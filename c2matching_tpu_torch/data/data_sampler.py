"""Iteration-oriented sampler.

Counterpart of ``c2matching_tpu/data/data_sampler.py``: the dataset
enlarged by ``ratio``, a permutation seeded by the epoch, indices taken
modulo the dataset, every ``num_replicas``-th one from ``rank``.
"""
import math

import numpy as np


class EnlargedIterSampler:
    """Epoch-seeded, ratio-enlarged, process-strided index sampler."""

    def __init__(self, dataset_size, num_replicas=1, rank=0, ratio=100):
        if not 0 <= rank < num_replicas:
            raise ValueError(f'rank {rank} outside 0..{num_replicas - 1}')
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(
            math.ceil(dataset_size * ratio / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState(self.epoch)
        indices = rng.permutation(self.total_size) % self.dataset_size
        indices = indices[self.rank:self.total_size:self.num_replicas]
        return iter(indices.tolist())

    def __len__(self):
        return self.num_samples
