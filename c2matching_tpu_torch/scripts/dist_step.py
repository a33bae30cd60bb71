"""Training steps on given global batches at every rank of a process group,
and the state they leave: the tool that holds a multi-process step
against one process on the same global batch.

    python -m torch.distributed.run --nproc_per_node 2 \
        -m c2matching_tpu_torch.scripts.dist_step -opt <options> \
        --batches <batches.pt> --out <dir> --launcher pytorch \
        [--device cpu] [--resume-after N] [--float64]

``-opt`` is a training options file (``.yml``) or an options dict
already parsed (``.json``). ``--batches`` holds a list of global batches
(dicts of numpy arrays, as the train loader gives them). Each rank builds
the model, then for step k = 1, 2, ... feeds its ``shard_batch`` of batch
k and runs ``optimize_parameters(k)`` (with ``--float64``:
``float64_grads``, the step's logs and gradients in float64, no update).
After each step it keeps the model's ``log_dict``, the trained nets'
gradients (before Adam: the averaged ones), parameters and buffers, D's
buffers (its BatchNorms' running statistics) just before D's Adam step,
the step's milliseconds (host clock between two synchronises) and those
of its gradient all-reduces. ``--resume-after N`` saves after step N (rank
0 writes), then every rank builds the model anew from those files and
the ``.state`` and goes on. Rank r writes ``<out>/rank<r>.pt`` and prints
one JSON line with its times, peak device memory and the kernels' launch
counts over the steps. TF32 is off, as in the parity checks.
``run_steps`` is the same loop in process; given another run's records
(``follow``), it starts each step after the first from that run's
parameters and buffers, so that each step's gradients are compared from
the same state (Adam moves a parameter by about its LR whatever its
gradient's size, so two runs' parameters part by up to twice the LR a
step where a gradient is rounding noise, and later steps start apart).
"""
import argparse
import copy
import json
import os
import os.path as osp
import time

import torch
import torch.distributed as dist

from ..models import create_model
from ..ops import deform_conv_backward, deform_im2col, match_argmax
from ..parallel import LAUNCHERS, init_distributed, shard_batch
from ..utils import check_resume, dict_to_nonedict, get_root_logger
from ..utils.options import parse


def trained_nets(model):
    """{label: net} of the nets a model's optimizers update."""
    if hasattr(model, 'trained'):
        return {model.net_label: model.trained}
    nets = {'net_g': model.net_g}
    if getattr(model, 'net_d', None) is not None:
        nets['net_d'] = model.net_d
    return nets


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _cpu(named):
    return {k: t.detach().cpu().clone() for k, t in named}


def _record(model, logs, grads=None, d_stats=None):
    """The state one step leaves, on the CPU."""
    out = {'logs': {k: float(v) for k, v in logs.items()},
           'grads': {}, 'params': {}, 'buffers': {}, 'd_stats': d_stats}
    for label, net in trained_nets(model).items():
        out['params'][label] = _cpu(net.named_parameters())
        out['buffers'][label] = _cpu(net.named_buffers())
        got = (grads if grads is not None else
               {k: p.grad for k, p in net.named_parameters()
                if p.grad is not None})
        if got:
            out['grads'][label] = _cpu(got.items())
    return out


def _load(model, record):
    """Set the trained nets' parameters and buffers to ``record``'s."""
    with torch.no_grad():
        for label, net in trained_nets(model).items():
            for k, t in net.named_parameters():
                t.copy_(record['params'][label][k])
            for k, t in net.named_buffers():
                t.copy_(record['buffers'][label][k])


def _watch_d(model, seen):
    """Keep D's buffers in ``seen`` at each of D's Adam steps, before the
    step."""
    if getattr(model, 'net_d', None) is not None:
        model.optimizer_d.register_step_pre_hook(
            lambda *_: seen.append(_cpu(model.net_d.named_buffers())))


def _resumed(opt, device, step):
    """The model built anew from the checkpoints of ``step`` and its
    ``.state``."""
    opt = copy.deepcopy(opt)
    state = osp.join(opt['path']['training_state'], f'{step}.state')
    opt['path']['resume_state'] = state
    check_resume(opt, str(step))
    model = create_model(opt, device)
    model.resume_training(state)
    return model


def run_steps(opt, batches, device, rank=0, world=1, resume_after=None,
              float64=False, follow=None):
    """The records of each step (see the module docstring) and each
    step's and its all-reduces' milliseconds."""
    device = torch.device(device)
    model = create_model(opt, device)
    d_stats = []
    _watch_d(model, d_stats)
    allreduce_s = []
    real_sync = model.sync_gradients

    def timed_sync(params):
        _sync(device)
        t0 = time.perf_counter()
        real_sync(params)
        _sync(device)
        allreduce_s.append(time.perf_counter() - t0)

    records, times = [], []
    for step, batch in enumerate(batches, start=1):
        model.sync_gradients = timed_sync
        if follow is not None and step > 1:
            _load(model, follow[step - 2])
        shard = shard_batch(batch, rank, world)
        allreduce_s.clear()
        d_stats.clear()
        _sync(device)
        t0 = time.perf_counter()
        if float64:
            logs, grads = model.float64_grads(shard)
        else:
            model.feed_data(shard)
            model.optimize_parameters(step)
            logs, grads = model.log_dict, None
        _sync(device)
        times.append({'step': step, 'ms': 1e3 * (time.perf_counter() - t0),
                      'allreduce_ms': 1e3 * sum(allreduce_s)})
        records.append(_record(model, logs, grads,
                               d_stats[-1] if d_stats else None))
        if step == resume_after:
            model.save(0, step)
            if world > 1:
                dist.barrier()
            model = _resumed(opt, device, step)
            _watch_d(model, d_stats)
            real_sync = model.sync_gradients
    return records, times


def _options(path):
    if path.endswith('.json'):
        with open(path) as f:
            return json.load(f)
    return parse(path, is_train=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', required=True,
                        help='training options (.yml, or a parsed .json)')
    parser.add_argument('--batches', required=True,
                        help='torch.save\'d list of global batches')
    parser.add_argument('--out', required=True)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--launcher', choices=LAUNCHERS, default='none')
    parser.add_argument('--resume-after', type=int, default=None)
    parser.add_argument('--float64', action='store_true',
                        help='float64_grads instead of optimize_parameters')
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = _options(args.opt)
    rank, world, device = init_distributed(opt, args.launcher, args.device)
    try:
        opt['dist'] = world > 1
        opt['rank'], opt['world_size'] = rank, world
        get_root_logger()
        batches = torch.load(args.batches, weights_only=False)
        if device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(device)
        records, times = run_steps(
            dict_to_nonedict(opt), batches, device, rank, world,
            args.resume_after, args.float64)
        os.makedirs(args.out, exist_ok=True)
        torch.save(records, osp.join(args.out, f'rank{rank}.pt'))
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == 'cuda' else None)
        launches = {k.__name__: k.launches for k in (
            match_argmax, deform_im2col, deform_conv_backward)}
        print(json.dumps({'rank': rank, 'world': world, 'steps': times,
                          'peak_gib': peak, 'launches': launches}),
              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
