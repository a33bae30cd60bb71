"""Datasets and loaders of the port (evaluation).

Counterpart of ``c2matching_tpu/data/__init__.py`` for the val/test
phases: ``create_dataset`` dispatches on the YAML ``type``, and
``create_dataloader`` gives the batch-1 in-order loader the reference
uses for evaluation.
"""
import logging

from .loader import DataLoader, default_collate
from .ref_cufed_dataset import RefCUFEDDataset

logger = logging.getLogger('base')

DATASETS = {'RefCUFEDDataset': RefCUFEDDataset}


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


def create_dataloader(dataset, dataset_opt):
    """The batch-1 in-order loader of the val/test phases."""
    phase = dataset_opt['phase']
    if phase in ('val', 'test'):
        return DataLoader(dataset)
    if phase == 'train':
        raise NotImplementedError('train loaders come with the train runner')
    raise ValueError(f'Wrong dataset phase: {phase}.')


__all__ = ['DATASETS', 'DataLoader', 'RefCUFEDDataset', 'create_dataloader',
           'create_dataset', 'default_collate']
