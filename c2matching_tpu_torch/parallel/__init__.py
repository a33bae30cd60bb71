"""Multi-process data parallelism of the port (``torch.distributed``)."""
from .mesh import (LAUNCHERS, all_reduce_sum, allreduce_max_across_processes,
                   allreduce_sum_across_processes, average_gradients,
                   backend_for, broadcast_parameters, get_rank,
                   get_world_size, init_distributed, mean_across_ranks,
                   pad_batch_to, shard_batch, sum_across_ranks)

__all__ = ['LAUNCHERS', 'all_reduce_sum', 'allreduce_max_across_processes',
           'allreduce_sum_across_processes', 'average_gradients',
           'backend_for', 'broadcast_parameters', 'get_rank',
           'get_world_size', 'init_distributed', 'mean_across_ranks',
           'pad_batch_to', 'shard_batch', 'sum_across_ranks']
