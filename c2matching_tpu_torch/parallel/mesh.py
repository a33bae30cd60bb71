"""Process groups and data parallelism over ``torch.distributed``.

Counterpart of ``c2matching_tpu/parallel/mesh.py``. The JAX package runs
one program over a mesh of devices and lets XLA insert the collectives;
the port runs one process a device (``torchrun`` or SLURM) and makes
them by hand:

- ``init_distributed(opt, launcher, device)`` reads the launcher's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``, whose default is ``dist_params.port``) and joins the
  process group. ``dist_params.backend``: the JAX package's ``ici`` means
  NCCL on CUDA and gloo on the CPU; ``nccl`` and ``gloo`` are taken as
  they are. A CUDA process takes the card ``LOCAL_RANK`` modulo the
  cards it sees.
- ``shard_batch`` is the rank's contiguous slice of a global batch, the
  layout ``make_array_from_process_local_data`` gives a batch sharded on
  its leading axis; ``pad_batch_to`` repeats the last item.
- ``allreduce_sum_across_processes`` sums a float64 vector on the host
  (validation's metric sums); at world size 1 it is the identity.
- ``average_gradients`` all-reduces the flattened gradients after a
  backward and divides by the world size: the mean over the global batch
  that the JAX package's sharded step differentiates. DDP is not used: it
  does not support ``torch.autograd.grad``, which the gradient penalty
  calls.
- ``all_reduce_sum`` is a differentiable (twice: the gradient penalty
  differentiates through it) all-reduce for the global BatchNorm.
- ``broadcast_parameters`` copies rank 0's parameters and buffers to
  every rank at start.

Without a process group every function acts as world size 1.
"""
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger('base')

LAUNCHERS = ('none', 'pytorch', 'slurm')


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def backend_for(opt, device):
    """The process group's backend: ``dist_params.backend`` with ``ici``
    (the JAX package's value, also the default) read as NCCL on CUDA and
    gloo on the CPU."""
    name = ((opt or {}).get('dist_params') or {}).get('backend') or 'ici'
    device = torch.device(device)
    if name == 'ici':
        return 'nccl' if device.type == 'cuda' else 'gloo'
    if name not in ('nccl', 'gloo'):
        raise ValueError(f'dist_params.backend {name!r}: the port takes '
                         "'ici', 'nccl' or 'gloo'")
    if name == 'nccl' and device.type != 'cuda':
        raise ValueError(f'dist_params.backend nccl needs a CUDA device, '
                         f'not {device}')
    return name


def _launcher_env(launcher):
    """(rank, world size, local rank) from the launcher's environment."""
    env = os.environ
    if launcher == 'pytorch':
        rank = int(env['RANK'])
        return rank, int(env['WORLD_SIZE']), int(env.get('LOCAL_RANK',
                                                          rank))
    if launcher == 'slurm':
        return (int(env['SLURM_PROCID']), int(env['SLURM_NTASKS']),
                int(env.get('SLURM_LOCALID', 0)))
    raise ValueError(f'launcher {launcher!r}: one of {LAUNCHERS}')


def init_distributed(opt=None, launcher='none', device='cuda'):
    """Join the process group of ``launcher``. Returns (rank, world size,
    the process's device). ``launcher`` 'none' starts no group: (0, 1,
    ``device``)."""
    device = torch.device(device)
    if launcher == 'none':
        return 0, 1, device
    rank, world, local_rank = _launcher_env(launcher)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('a CUDA device was asked for, but no CUDA '
                               "card is available; pass device 'cpu'")
        if device.index is None:
            device = torch.device('cuda',
                                  local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend_for(opt, device)
    port = (os.environ.get('MASTER_PORT')
            or ((opt or {}).get('dist_params') or {}).get('port') or 29500)
    addr = os.environ.get('MASTER_ADDR') or 'localhost'
    dist.init_process_group(backend, init_method=f'tcp://{addr}:{port}',
                            rank=rank, world_size=world)
    logger.info(f'process group: rank {rank} of {world}, backend {backend}, '
                f'device {device}')
    return rank, world, device


def _comm_device():
    """Where host values go for a collective: NCCL reduces CUDA tensors
    only."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def shard_batch(batch, rank, world):
    """The rank's contiguous slice of every array of a global batch dict.

    An array whose leading axis does not divide by ``world`` is taken
    whole (each rank computes it, as the JAX package replicates it);
    entries without a leading axis (paths, flags) pass through."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, 'shape') and getattr(v, 'ndim', 0) >= 1:
            n = v.shape[0]
            if n % world == 0:
                per = n // world
                v = v[rank * per:(rank + 1) * per]
            else:
                logger.warning(f'batch axis {n} of {k!r} not divisible by '
                               f'world size {world}; every rank takes it '
                               'whole')
        out[k] = v
    return out


def pad_batch_to(batch, batch_size):
    """Pad the leading axis of every array to ``batch_size`` by repeating
    its last item; returns (batch, n_real)."""
    n_real = None
    out = {}
    for k, v in batch.items():
        if hasattr(v, 'shape') and getattr(v, 'ndim', 0) >= 1:
            n_real = v.shape[0]
            if v.shape[0] < batch_size:
                pad = np.repeat(v[-1:], batch_size - v.shape[0], axis=0)
                v = np.concatenate([v, pad], axis=0)
        out[k] = v
    return out, n_real


def allreduce_sum_across_processes(values):
    """Sum a small 1-D float64 vector over the processes (validation's
    metric sums and counts). World size 1: the identity."""
    values = np.asarray(values, np.float64)
    if get_world_size() == 1:
        return values
    t = torch.as_tensor(values, dtype=torch.float64, device=_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def allreduce_max_across_processes(value):
    """The largest of a host float over the processes."""
    if get_world_size() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def sum_across_ranks(t):
    """The sum of a tensor over the ranks, outside autograd."""
    if get_world_size() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def mean_across_ranks(values):
    """{name: the mean over the ranks} of a dict of scalars, in one
    collective (in float64)."""
    world = get_world_size()
    if world == 1 or not values:
        return values
    names = list(values)
    tensors = [v for v in values.values() if torch.is_tensor(v)]
    device = tensors[0].device if tensors else torch.device('cpu')
    packed = torch.stack([torch.as_tensor(values[k], dtype=torch.float64,
                                          device=device).detach().reshape(())
                          for k in names])
    packed = sum_across_ranks(packed) / world
    return dict(zip(names, packed.unbind()))


def average_gradients(params):
    """Replace each parameter's gradient by its mean over the ranks, in
    one all-reduce of the flattened gradients. A missing gradient counts
    as zeros, so that every rank reduces the same layout. Runs whenever a
    process group exists (at world size 1 the sum of one is exact)."""
    if not dist.is_initialized():
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    world = dist.get_world_size()
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat)
    if world > 1:
        flat.div_(world)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n


def broadcast_parameters(*modules):
    """Copy rank 0's parameters and buffers to every rank."""
    if get_world_size() == 1:
        return
    for module in modules:
        if module is None:
            continue
        for t in module.state_dict().values():
            if torch.is_tensor(t):
                dist.broadcast(t, src=0)


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the all-reduce of the gradient,
    itself differentiable."""

    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(tensor):
    """The sum over the ranks of ``tensor``, differentiable (at any
    order). World size 1: ``tensor``."""
    if get_world_size() == 1:
        return tensor
    return _AllReduceSum.apply(tensor)
