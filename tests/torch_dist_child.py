"""Child processes of the port's multi-process tests
(``tests/test_torch_parallel*.py``), and ``spawn`` to start them.

``spawn(jobs)`` runs, for each job, ``world`` copies of this file on the
CPU with the environment ``torch.distributed.run`` would give them
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port), all jobs at once, and waits a
bounded time for each process. Its modes:

- ``step <dist_step arguments>``: ``c2matching_tpu_torch.scripts.
  dist_step`` (training steps on given global batches);
- ``naive <dist_step arguments>``: the same with the contrastive loss
  divided by each rank's own count of samples over the 128 gate (the
  per-rank mean that the global count replaces);
- ``validate <options .json> <out .json>``: the stage-3 model's
  ``validation`` on the options' val set; each rank writes its means.
- ``validate_spatial <options .json> <out>``: the same with the images
  saved and INFO logs on every rank; each rank writes its means and its
  count of saved images.
- ``spatial <requests .npz> <weights .pt> <out>``: the tiny eval model
  (``SPATIAL_NETS``, ``val_spatial_shard: true``) on the given weights:
  ``feed_data`` / ``test`` on each request; each rank writes each
  request's cropped output, offset statistics, band and collective
  counts.
- ``spatial_units <out>``: the banded ops on ``unit_inputs()``; each rank
  writes its results.
- ``match_band <inputs .pt> <out>``: ``batched_patch_match`` on the rank's
  band of the inputs' ``feat_in`` against the whole ``feat_ref``, with
  their ``compute_dtype``; each rank writes its indices and values.

``start(jobs)`` starts the jobs and returns the wait of ``spawn``.
"""
import json
import os
import os.path as osp
import socket
import subprocess
import sys
import tempfile

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def spawn(jobs, timeout=120, script=None):
    """Start every job at once, each ``world`` ranks of this file (or of
    ``script``, a module run with -m) with its ``args``, and wait at most
    ``timeout`` seconds for each process. ``jobs``: [(args, world)].
    Returns, per job, [(returncode, stdout + stderr)] by rank."""
    return start(jobs, script)(timeout)


def start(jobs, script=None):
    """Start the jobs as ``spawn`` does; returns ``wait(timeout=120)``,
    which gives ``spawn``'s result and stops every process left, as
    ``wait.stop()`` does at any time."""
    cmd = ([sys.executable, '-m', script] if script
           else [sys.executable, __file__])
    groups = []

    def stop():
        for procs in groups:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()

    def wait(timeout=120):
        try:
            out = []
            for procs in groups:
                res = []
                for proc, log in procs:
                    proc.wait(timeout=timeout)
                    log.seek(0)
                    res.append((proc.returncode, log.read()))
                out.append(res)
            return out
        finally:
            stop()

    try:
        for args, world in jobs:
            port = str(free_port())
            procs = []
            for rank in range(world):
                env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                           MASTER_PORT=port, PYTHONPATH=REPO,
                           OMP_NUM_THREADS='2')
                # a file, not a pipe: a rank blocked on a full pipe would
                # hold the others in their collectives
                log = tempfile.TemporaryFile('w+')
                procs.append((subprocess.Popen(
                    cmd + list(args), env=env, cwd=REPO, stdout=log,
                    stderr=subprocess.STDOUT, text=True), log))
            groups.append(procs)
    except BaseException:
        stop()
        raise
    wait.stop = stop
    return wait


def _naive():
    """The contrastive loss of each rank over its own gated count."""
    from c2matching_tpu_torch.models.teacher_contras_model import \
        ContrasModel
    real = ContrasModel._loss_opts
    ContrasModel._loss_opts = lambda self: dict(real(self), world=1)


def _validate(opt_path, out_path):
    import torch.distributed as dist
    from c2matching_tpu_torch.data import create_dataloader, create_dataset
    from c2matching_tpu_torch.models import create_model
    from c2matching_tpu_torch.parallel import init_distributed
    from c2matching_tpu_torch.utils import dict_to_nonedict
    with open(opt_path) as f:
        opt = dict_to_nonedict(json.load(f))
    rank, world, device = init_distributed(opt, 'pytorch', 'cpu')
    try:
        model = create_model(opt, device)
        val_opt = opt['datasets']['val']
        loader = create_dataloader(create_dataset(val_opt), val_opt)
        avgs = model.validation(loader, 0, None)
        with open(f'{out_path}.rank{rank}', 'w') as f:
            json.dump({k: float(v) for k, v in avgs.items()}, f)
    finally:
        dist.destroy_process_group()


def _validate_spatial(opt_path, out_path):
    """``validation`` with the images saved, every rank logging at INFO;
    each rank writes its means and the count of images it saved."""
    import logging
    import torch.distributed as dist
    from c2matching_tpu_torch.data import create_dataloader, create_dataset
    from c2matching_tpu_torch.models import create_model
    from c2matching_tpu_torch.models.sr_model import SRModel
    from c2matching_tpu_torch.parallel import init_distributed
    from c2matching_tpu_torch.utils import dict_to_nonedict
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    saved = []
    real = SRModel._save_val_image
    SRModel._save_val_image = lambda self, img, name, *a: (
        saved.append(name), real(self, img, name, *a))
    with open(opt_path) as f:
        opt = dict_to_nonedict(json.load(f))
    rank, world, device = init_distributed(opt, 'pytorch', 'cpu')
    try:
        model = create_model(opt, device)
        val_opt = opt['datasets']['val']
        loader = create_dataloader(create_dataset(val_opt), val_opt)
        avgs = model.validation(loader, 0, None, save_img=True)
        with open(f'{out_path}.rank{rank}', 'w') as f:
            json.dump({'avgs': {k: float(v) for k, v in avgs.items()},
                       'saved': saved}, f)
    finally:
        dist.destroy_process_group()


# the tiny eval model of tests/test_parallel.py (its nets' option blocks)
SPATIAL_NETS = {
    'network_g': {'type': 'RestorationNet', 'ngf': 8, 'n_blocks': 1,
                  'groups': 8},
    'network_map': {'type': 'CorrespondenceGenerationArch'},
    'network_extractor': {'type': 'ContrasExtractorSep'},
}


def spatial_model(weights, spatial=True):
    """The tiny eval model on the CPU with the state dicts ``weights``
    ({'g', 'extractor', 'map'}) loaded."""
    from c2matching_tpu_torch.models import create_model
    from c2matching_tpu_torch.utils import dict_to_nonedict
    model = create_model(dict_to_nonedict(dict(
        SPATIAL_NETS, name='spatial', is_train=False, scale=4,
        model_type='RefRestorationModel', val_spatial_shard=spatial,
        manual_seed=0)), 'cpu')
    for key, net in (('g', model.net_g), ('extractor', model.net_extractor),
                     ('map', model.net_map)):
        net.load_state_dict(weights[key], strict=True)
    return model


def spatial_outputs(model, requests):
    """{request: {'out', 'stats', 'band', 'collectives'}} of the model's
    ``feed_data`` / ``test`` / ``cropped_output`` on each request of
    ``requests`` (an .npz's arrays named '<request>/<key>'); 'collectives'
    are the request's own ``spatial.stats``."""
    from c2matching_tpu_torch.parallel import spatial
    out = {}
    for name in sorted({k.split('/')[0] for k in requests}):
        spatial.reset_stats()
        model.feed_data({k.split('/')[1]: requests[k] for k in requests
                         if k.startswith(f'{name}/')})
        model.test()
        out[name] = {'out': model.cropped_output().numpy(),
                     'stats': {k: float(v) for k, v in
                               model._offset_warn_stats.items()},
                     'band': model._band,
                     'collectives': dict(spatial.stats)}
    return out


def _spatial(requests_path, weights_path, out_path):
    import logging
    import numpy as np
    import torch
    import torch.distributed as dist
    from c2matching_tpu_torch.parallel import init_distributed
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    torch.set_num_threads(1)
    rank, _, _ = init_distributed({}, 'pytorch', 'cpu')
    try:
        model = spatial_model(torch.load(weights_path, weights_only=True))
        out = spatial_outputs(model, dict(np.load(requests_path)))
        torch.save(out, f'{out_path}.rank{rank}')
    finally:
        dist.destroy_process_group()


def unit_inputs(h):
    """Seeded inputs of the banded ops' unit tests, for an image of ``h``
    rows: an NHWC image, a conv stack's input, an LR image, match
    features and a deformable conv's operands."""
    import numpy as np
    import torch
    rng = np.random.RandomState(h)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32))
    return {'image': t(1, h, 5, 3), 'conv': t(1, h, 10, 4),
            'lr': t(1, h, 6, 3), 'feat_in': t(1, h, 7, 16),
            'feat_ref': t(1, h, 7, 16), 'x': t(1, h, 6, 16),
            'offset': t(1, h, 6, 2, 9, 2, scale=3.0),
            'mask': torch.sigmoid(t(1, h, 6, 2, 9)),
            'weight': t(9, 16, 8, scale=0.1), 'bias': t(8)}


UNIT_HEIGHTS = (8, 4, 7)    # the images' rows: bands of 4, of 2 (at world
                            # 2 the last band then holds no query row), and
                            # of 3 and 4


def unit_nets():
    """The conv stack of the units: a Conv2d and two residual blocks."""
    import torch
    from c2matching_tpu_torch.models.archs.arch_util import (ResBlockStack,
                                                             conv)
    gen = torch.Generator().manual_seed(3)
    return conv(4, 8, gen, std=0.2), ResBlockStack(8, 2, gen)


def unit_ops(inputs, band=None):
    """The banded ops on ``inputs`` (whole with ``band`` None, else the
    band's rows of the per-pixel inputs, the reference features and the
    deformable conv's x whole): {name: result}."""
    import torch
    from c2matching_tpu_torch.ops.deform_conv import (deform_im2col,
                                                      modulated_deform_conv)
    from c2matching_tpu_torch.ops.flow import batched_pre_offsets
    from c2matching_tpu_torch.ops.patch_match import batched_patch_match
    from c2matching_tpu_torch.ops.resize import upscale
    from c2matching_tpu_torch.parallel import exchange_halo
    take = (lambda x: x) if band is None else band.take
    row0 = 0 if band is None else band.row0
    out = {}
    if band is not None:
        out['halo'] = exchange_halo(take(inputs['image']), band, 2, 1)
    first, stack = unit_nets()
    with torch.no_grad():
        out['convs'] = stack(first(take(inputs['conv']), band), band)
    out['upscale'] = upscale(take(inputs['lr']), 4, band=band)
    idx, val = batched_patch_match(take(inputs['feat_in']),
                                   inputs['feat_ref'], band=band)
    out['match_idx'], out['match_val'] = idx, val
    pre = batched_pre_offsets(idx, band=band)
    out.update({f'pre_{k}': v for k, v in pre.items()})
    padding = (1 - row0, 1)
    offset, mask = take(inputs['offset']), take(inputs['mask'])
    out['cols'] = deform_im2col(inputs['x'][0], offset[0], mask[0],
                                padding=padding)
    with torch.no_grad():
        out['mdc'] = modulated_deform_conv(
            inputs['x'], offset, mask, inputs['weight'], inputs['bias'],
            padding=padding)
    return out


def _spatial_units(out_path):
    import torch
    import torch.distributed as dist
    from c2matching_tpu_torch.parallel import band_for, init_distributed
    torch.set_num_threads(1)
    rank, world, _ = init_distributed({}, 'pytorch', 'cpu')
    try:
        out = {h: unit_ops(unit_inputs(h), band_for(h, rank, world))
               for h in UNIT_HEIGHTS}
        torch.save(out, f'{out_path}.rank{rank}')
    finally:
        dist.destroy_process_group()


def _match_band(in_path, out_path):
    import torch
    import torch.distributed as dist
    from c2matching_tpu_torch.ops.patch_match import batched_patch_match
    from c2matching_tpu_torch.parallel import band_for, init_distributed
    torch.set_num_threads(1)
    rank, world, _ = init_distributed({}, 'pytorch', 'cpu')
    try:
        inputs = torch.load(in_path, weights_only=False)
        feat_in = inputs['feat_in']
        band = band_for(feat_in.shape[1], rank, world)
        idx, val = batched_patch_match(
            band.take(feat_in), inputs['feat_ref'],
            compute_dtype=inputs['compute_dtype'], band=band)
        torch.save({'band': (band.row0, band.rows), 'idx': idx, 'val': val},
                   f'{out_path}.rank{rank}')
    finally:
        dist.destroy_process_group()


def main(argv):
    mode, rest = argv[0], argv[1:]
    modes = {'validate': _validate, 'validate_spatial': _validate_spatial,
             'spatial': _spatial, 'spatial_units': _spatial_units,
             'match_band': _match_band}
    if mode in modes:
        modes[mode](*rest)
        return
    if mode == 'naive':
        _naive()
    from c2matching_tpu_torch.scripts import dist_step
    dist_step.main(rest)


if __name__ == '__main__':
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
