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
    cmd = ([sys.executable, '-m', script] if script
           else [sys.executable, __file__])
    groups = []
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
        for procs in groups:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()


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


def main(argv):
    mode, rest = argv[0], argv[1:]
    if mode == 'validate':
        _validate(*rest)
        return
    if mode == 'naive':
        _naive()
    from c2matching_tpu_torch.scripts import dist_step
    dist_step.main(rest)


if __name__ == '__main__':
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
