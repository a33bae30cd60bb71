"""Multi-process data parallelism of the port (``torch.distributed``), and
the band split of batch-1 evaluation (``spatial``)."""
from .mesh import (LAUNCHERS, all_reduce_sum, allreduce_max_across_processes,
                   allreduce_sum_across_processes, average_gradients,
                   backend_for, broadcast_parameters, get_rank,
                   get_world_size, init_distributed, mean_across_ranks,
                   pad_batch_to, shard_batch, sum_across_ranks)
from .spatial import (Band, allreduce_sum, band_for, exchange_halo,
                      gather_rows)

__all__ = ['LAUNCHERS', 'Band', 'all_reduce_sum',
           'allreduce_max_across_processes', 'allreduce_sum',
           'allreduce_sum_across_processes',
           'average_gradients', 'backend_for', 'band_for',
           'broadcast_parameters', 'exchange_halo', 'gather_rows',
           'get_rank', 'get_world_size', 'init_distributed',
           'mean_across_ranks', 'pad_batch_to', 'shard_batch',
           'sum_across_ranks']
