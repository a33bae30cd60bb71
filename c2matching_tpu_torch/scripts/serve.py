"""Batch serving CLI: RefSR inference at batch N over a pair list.

Counterpart of ``scripts/serve.py`` of the JAX package. It streams
(input, ref) pairs from the test dataset blocks of an options file,
groups them into batches of shape-compatible items, runs the model's
serving forward (``RefRestorationModel.feed_data`` / ``test`` /
``cropped_output``) at batch N and writes the x4 outputs as PNG:

    python -m c2matching_tpu_torch.scripts.serve \
        -opt options/test/test_C2_matching_serving.yml --batch 16 \
        [--out results/<name>_serve] [--device cpu]

    python -m torch.distributed.run --nproc_per_node <cards> \
        -m c2matching_tpu_torch.scripts.serve -opt <config>.yml \
        --batch 16 --launcher pytorch

Items whose (padded LR, original GT) shapes differ land in different
buckets; a bucket flushes when it holds ``--batch`` items, and the
partial buckets flush at the end, padded by repeating their last item
(the padding is dropped after the run). The model runs each batch at its
own LR shape, which a bucket shares. Items are decoded and preprocessed
(PNG decode, the PIL bicubic chain) on two threads, at most 2 x batch
ahead, so host work overlaps the card's.

Under ``--launcher pytorch`` (or ``slurm``; ``parallel/``) every rank
reads and buckets the whole stream, so each batch keeps the one-process
composition and padding, and rank r runs and writes the flushes whose
index modulo the world size is r, on the card ``LOCAL_RANK``. Rank 0 logs
the images of all ranks over the slowest rank's time.

The images/s line of ``serve.log`` is END-TO-END: decode, the bicubic
chain, the card's forward and the PNG encode. The model runs on the CUDA
card unless ``--device`` names another device (``cpu``: the counterpart
of the JAX package's ``C2MATCHING_PLATFORM=cpu``); with no card it
raises. The JAX package's persistent compile cache has no counterpart:
PyTorch runs eagerly.
"""
import argparse
import collections
import logging
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor

import torch.distributed as dist

from ..data import create_dataset, default_collate
from ..models import create_model
from ..parallel import (LAUNCHERS, allreduce_max_across_processes,
                        allreduce_sum_across_processes, init_distributed)
from ..utils import dict_to_nonedict, get_root_logger, imwrite, tensor2img
from ..utils.options import parse


def _prefetched(dataset, n, pool, window):
    """Yield dataset items in order with at most ``window`` decodes in
    flight: bounded host memory, unlike an eager pool.map over n."""
    pending = collections.deque(
        pool.submit(dataset.__getitem__, i)
        for i in range(min(window, n)))
    nxt = len(pending)
    while pending:
        yield pending.popleft().result()
        if nxt < n:
            pending.append(pool.submit(dataset.__getitem__, nxt))
            nxt += 1


def bucket_batches(items_iter, batch_size):
    """Group an item stream into shape-compatible batches of up to
    ``batch_size``, yielding (items, names) per flush.

    The key is BOTH the padded LR shape and the unpadded GT shape: test
    items pad input and ref to their common max but keep img_in at the
    original GT size, so two pairs can share an LR shape while their
    img_in shapes differ (collate would fail on one batch). Leftover
    partial buckets are yielded at the end.
    """
    buckets = {}  # (lq (h, w), gt (h, w)) -> (items, names)
    for idx, item in enumerate(items_iter):
        key = (item['img_in_lq'].shape[:2], item['img_in'].shape[:2])
        items, names = buckets.setdefault(key, ([], []))
        items.append(item)
        names.append(osp.splitext(
            osp.basename(item.get('lq_path') or f'{idx:06d}'))[0]
            + f'_{idx:06d}')
        if len(items) == batch_size:
            yield buckets.pop(key)
    yield from buckets.values()


def _flush(model, items, names, out_dir, batch_size, logger):
    """Run one bucket's batch (padded to ``batch_size``) and write its
    outputs. Returns the number of images written."""
    n_real = len(items)
    padded = items + [items[-1]] * (batch_size - n_real)
    model.feed_data(default_collate(padded))
    model.test()
    out = model.cropped_output()[:n_real].float().cpu().numpy()
    for i in range(n_real):
        img = tensor2img(out[i])
        if padded[i].get('padding'):
            oh, ow = padded[i]['original_size']
            img = img[:int(oh), :int(ow)]
        imwrite(img, osp.join(out_dir, f'{names[i]}.png'))
    logger.info(f'served {n_real} images '
                f'(bucket {items[0]["img_in_lq"].shape[:2]})')
    return n_real


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to a test/serving option YAML file.')
    parser.add_argument('--batch', type=int, default=16,
                        help='serving batch size (static; partial final '
                             'batches are padded)')
    parser.add_argument('--out', type=str, default=None,
                        help='output dir (default results/<name>_serve)')
    parser.add_argument('--device', default='cuda',
                        help="torch device of the model (default: the CUDA "
                             "card, under a launcher the card LOCAL_RANK; "
                             "'cpu' runs on the CPU)")
    parser.add_argument('--launcher', choices=LAUNCHERS, default='none',
                        help='job launcher of a multi-process run')
    parser.add_argument('--local_rank', type=int, default=0)
    args = parser.parse_args(argv)
    if args.launcher == 'pytorch':
        os.environ.setdefault('LOCAL_RANK', str(args.local_rank))
    opt = parse(args.opt, is_train=False)
    rank, world, device = init_distributed(opt, args.launcher, args.device)
    try:
        _serve(dict_to_nonedict(opt), args, rank, world, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _serve(opt, args, rank, world, device):
    out_dir = args.out or osp.join('results', f"{opt['name']}_serve")
    os.makedirs(out_dir, exist_ok=True)
    logger = get_root_logger(logger_name='base', log_level=logging.INFO,
                             log_file=osp.join(out_dir, 'serve.log'))

    model = create_model(opt, device)

    test_phases = sorted(p for p in opt['datasets'] if p.startswith('test'))
    for phase in test_phases:
        dataset_opt = opt['datasets'][phase]
        dataset = create_dataset(dataset_opt)
        n = len(dataset)
        # one subdirectory per dataset when serving several: per-phase name
        # indices restart at 0 and ref basenames can repeat across sets,
        # which would overwrite the earlier phase's outputs
        phase_dir = (out_dir if len(test_phases) == 1 else
                     osp.join(out_dir, str(dataset_opt['name'] or phase)))
        os.makedirs(phase_dir, exist_ok=True)
        logger.info(f"serving {n} pairs from {dataset_opt['name']} "
                    f'at batch {args.batch} -> {phase_dir}')

        t0 = time.time()
        served = 0
        with ThreadPoolExecutor(max_workers=2) as pool:
            stream = _prefetched(dataset, n, pool, window=2 * args.batch)
            for i, (items, names) in enumerate(
                    bucket_batches(stream, args.batch)):
                if i % world == rank:
                    served += _flush(model, items, names, phase_dir,
                                     args.batch, logger)
        dt = allreduce_max_across_processes(time.time() - t0)
        served = int(allreduce_sum_across_processes([served])[0])
        logger.info(f'{served} images in {dt:.1f}s end-to-end '
                    f'({served / dt:.2f} img/s incl. host decode/PIL'
                    f'{f" over {world} ranks" if world > 1 else ""}; '
                    'see scripts/profile_serving.py for the card alone)')


if __name__ == '__main__':
    main()
