"""Test entry point of the port, the counterpart of ``mmsr/test.py``:

    python -m c2matching_tpu_torch.test -opt options/test/<config>.yml \
        [--device cpu]

Parses the options file, builds one batch-1 loader per sorted dataset
block, creates the model and runs its validation on each: per-image and
average PSNR, PSNR_Y and SSIM_Y go to the log (and the file
``results/<name>/test_<name>_<time>.log``), and the restored images to
``results/<name>/visualization`` when ``save_img`` is set. The model runs
on the CUDA card unless ``--device`` names another device; with no card
it raises rather than fall back to the CPU.
"""
import argparse
import logging
import os.path as osp
import time

from .data import create_dataloader, create_dataset
from .models import create_model
from .utils import dict2str, dict_to_nonedict, get_root_logger, make_exp_dirs
from .utils.options import parse


def run(opt_path, device='cuda'):
    """Validate the model of ``opt_path`` on each of its datasets. Returns
    {dataset name: {metric: average}}."""
    opt = parse(opt_path, is_train=False)

    make_exp_dirs(opt)
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
                             "card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)
    return run(args.opt, args.device)


if __name__ == '__main__':
    main()
