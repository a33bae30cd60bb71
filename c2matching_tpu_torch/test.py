"""Test entry point of the port, the counterpart of ``mmsr/test.py``:

    python -m c2matching_tpu_torch.test -opt options/test/<config>.yml \
        [--device cpu] [--launcher {none,pytorch,slurm}]
    python -m torch.distributed.run --nproc_per_node N \
        -m c2matching_tpu_torch.test -opt <config>.yml --launcher pytorch

Parses the options file, builds one batch-1 loader per sorted dataset
block, creates the model and runs its validation on each: per-image and
average PSNR, PSNR_Y and SSIM_Y go to the log (and the file
``results/<name>/test_<name>_<time>.log``), and the restored images to
``results/<name>/visualization`` when ``save_img`` is set. The model runs
on the CUDA card unless ``--device`` names another device; with no card
it raises rather than fall back to the CPU.

``--launcher pytorch`` (torchrun's environment) or ``slurm`` runs one
process a card (``parallel.init_distributed``; ``dist_params.backend``
as in training). Each rank then scores every world-th image, or, with
the options' ``val_spatial_shard: true``, every image split into one
horizontal band a rank: the JAX runner's one process over all local
devices. Rank 0 alone makes the results tree, writes the log file and
saves the images; every rank returns the same averages.
"""
import argparse
import logging
import os
import os.path as osp
import time

import torch.distributed as dist

from .data import create_dataloader, create_dataset
from .models import create_model
from .parallel import LAUNCHERS, init_distributed
from .utils import dict2str, dict_to_nonedict, get_root_logger, make_exp_dirs
from .utils.options import parse


def run(opt_path, device='cuda', launcher='none'):
    """Validate the model of ``opt_path`` on each of its datasets (in the
    process group of ``launcher``, which the run leaves at its end).
    Returns {dataset name: {metric: average}}."""
    opt = parse(opt_path, is_train=False)
    rank, world, device = init_distributed(opt, launcher, device)
    try:
        return _test(opt, rank, world, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _test(opt, rank, world, device):
    if rank == 0:
        make_exp_dirs(opt)
    if world > 1:
        dist.barrier()
    stamp = time.strftime('%Y%m%d_%H%M%S', time.localtime())
    log_file = osp.join(opt['path']['log'], f"test_{opt['name']}_{stamp}.log")
    logger = get_root_logger(logger_name='base', log_level=logging.INFO,
                             log_file=log_file)
    logger.info(dict2str(opt))

    opt = dict_to_nonedict(opt)

    test_loaders = []
    for _, dataset_opt in sorted(opt['datasets'].items()):
        test_set = create_dataset(dataset_opt)
        test_loader = create_dataloader(test_set, dataset_opt)
        logger.info(f"Number of test images in {dataset_opt['name']}: "
                    f'{len(test_set)}')
        test_loaders.append(test_loader)

    model = create_model(opt, device)

    results = {}
    for test_loader in test_loaders:
        test_set_name = test_loader.dataset.opt['name']
        logger.info(f'Testing {test_set_name}...')
        results[test_set_name] = model.validation(
            test_loader, current_iter=opt['name'], tb_logger=None,
            save_img=opt['save_img'])
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--device', default='cuda',
                        help="torch device of the model (default: the CUDA "
                             "card, under a launcher the card LOCAL_RANK; "
                             "'cpu' runs on the CPU)")
    parser.add_argument('--launcher', choices=LAUNCHERS, default='none',
                        help='job launcher of a multi-process run')
    parser.add_argument('--local_rank', type=int, default=0,
                        help='the local rank, where the launcher passes it '
                             'as an argument rather than LOCAL_RANK')
    args = parser.parse_args(argv)
    if args.launcher == 'pytorch':
        os.environ.setdefault('LOCAL_RANK', str(args.local_rank))
    return run(args.opt, args.device, args.launcher)


if __name__ == '__main__':
    main()
