"""Datasets, samplers and loaders of the port.

Counterpart of ``c2matching_tpu/data/__init__.py``: ``create_dataset``
dispatches on the YAML ``type`` (``RefCUFEDDataset`` of stage 3 and
evaluation, ``ContrasDataset`` / ``ContrasValDataset`` of stages 1-2);
``create_dataloader`` gives the train loader (``batch_size //
num_processes`` a process, ``drop_last``, a shuffle or a sampler,
prefetch threads for ``n_workers``) or the batch-1 in-order loader of
evaluation; ``create_train_sampler`` the ratio-enlarged sampler, whose
indices are split over the processes (every ``num_processes``-th from
``rank``).
"""
import logging

from .contras_dataset import ContrasDataset, ContrasValDataset
from .data_sampler import EnlargedIterSampler
from .loader import DataLoader, default_collate
from .ref_cufed_dataset import RefCUFEDDataset

logger = logging.getLogger('base')

DATASETS = {'RefCUFEDDataset': RefCUFEDDataset,
            'ContrasDataset': ContrasDataset,
            'ContrasValDataset': ContrasValDataset}


def create_dataset(dataset_opt):
    """Instantiate a dataset from its YAML block (``type`` key)."""
    kind = dataset_opt['type']
    if kind not in DATASETS:
        raise ValueError(f'dataset type {kind!r} is not ported; the port has '
                         f'{sorted(DATASETS)}')
    dataset = DATASETS[kind](dataset_opt)
    logger.info(
        f"Dataset {dataset.__class__.__name__} - {dataset_opt['name']} "
        'is created.')
    return dataset


def create_dataloader(dataset, dataset_opt, num_processes=1, rank=0,
                      sampler=None, seed=0):
    """The loader of the block's phase: in train, batches of
    ``batch_size // num_processes`` (the process's part of the global
    batch; 0 raises) with the last partial one dropped, shuffled by
    ``RandomState(seed + epoch)`` (``use_shuffle``, default on) unless a
    ``sampler`` gives the order, read by ``n_workers`` threads (at least
    1); in val / test, one item a batch in order. ``rank`` is accepted
    for the JAX package's signature: the sampler holds the split."""
    phase = dataset_opt['phase']
    if phase == 'train':
        batch_size = dataset_opt['batch_size'] // num_processes
        if batch_size < 1:
            raise ValueError(
                f"batch_size {dataset_opt['batch_size']} < "
                f'{num_processes} processes: the per-process batch would '
                'be 0')
        shuffle = dataset_opt.get('use_shuffle', True)
        return DataLoader(dataset, batch_size=batch_size,
                          sampler=sampler,
                          shuffle=shuffle and sampler is None,
                          num_workers=dataset_opt.get('n_workers', 1) or 1,
                          drop_last=True, seed=seed)
    if phase in ('val', 'test'):
        return DataLoader(dataset)
    raise ValueError(f'Wrong dataset phase: {phase}.')


def create_train_sampler(dataset, dataset_opt, num_processes=1, rank=0):
    """The sampler that enlarges the dataset by ``dataset_enlarge_ratio``
    (default 1), ``rank``'s share of ``num_processes``."""
    ratio = dataset_opt.get('dataset_enlarge_ratio', 1) or 1
    return EnlargedIterSampler(len(dataset), num_replicas=num_processes,
                               rank=rank, ratio=ratio)


__all__ = ['DATASETS', 'ContrasDataset', 'ContrasValDataset', 'DataLoader',
           'EnlargedIterSampler', 'RefCUFEDDataset', 'create_dataloader',
           'create_dataset', 'create_train_sampler', 'default_collate']
