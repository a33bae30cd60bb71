"""Reference-based CUFED dataset (input, ref) pair loader.

Counterpart of ``c2matching_tpu/data/ref_cufed_dataset.py``: decode to
BGR float [0, 1]; in the train phase, resize the ref to ``gt_size`` with
PIL's bicubic through uint8 (the port's ``data/pil_resize.py``; PIL's
RGB<->BGR swaps around it change no value) and flip / rotate both images
(``augment``); in the val / test phases, mod-crop to the scale and
zero-pad input and ref to a common size when they differ. Then the
PIL-bicubic down x1/scale and back up chain with its uint8 round trips.
Output arrays are HWC RGB float32. In val / test, ``img_in`` is the input
before the pad, and ``lq_path`` is the ref path, as in the JAX package.

With ``io_backend: {type: lmdb}`` the two dataroots are ``*.lmdb``
databases (``scripts/create_cufed_lmdb.py``): the pairs are their shared
keys, sorted, and the input and the ref are read through the client keys
'in' and 'ref'.
"""
import numpy as np

from ..utils.util import imfrombytes, impad
from .file_client import FileClient
from .transforms import augment, mod_crop, to_rgb_hwc
from .util import (paired_paths_from_ann_file, paired_paths_from_folder,
                   paired_paths_from_lmdb, pil_bicubic_resize,
                   pil_chain_lq_up)


class RefCUFEDDataset:
    """opt keys: dataroot_in, dataroot_ref, ann_file, io_backend,
    filename_tmpl, scale, phase, and in train gt_size, use_flip, use_rot."""

    def __init__(self, opt):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        self.in_folder = opt['dataroot_in']
        self.ref_folder = opt['dataroot_ref']
        self.filename_tmpl = opt.get('filename_tmpl') or '{}'

        if self.io_backend_opt['type'] == 'lmdb':
            self.io_backend_opt['db_paths'] = [self.in_folder,
                                               self.ref_folder]
            self.io_backend_opt['client_keys'] = ['in', 'ref']
            self.paths = paired_paths_from_lmdb(
                [self.in_folder, self.ref_folder], ['in', 'ref'])
        elif opt.get('ann_file'):
            self.paths = paired_paths_from_ann_file(
                [self.in_folder, self.ref_folder], ['in', 'ref'],
                opt['ann_file'])
        else:
            self.paths = paired_paths_from_folder(
                [self.in_folder, self.ref_folder], ['in', 'ref'],
                self.filename_tmpl)

    def __getitem__(self, index):
        if self.file_client is None:
            backend_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(backend_opt.pop('type'),
                                          **backend_opt)
        scale = self.opt['scale']

        in_path = self.paths[index]['in_path']
        img_in = imfrombytes(self.file_client.get(in_path, 'in')).astype(
            np.float32) / 255.
        ref_path = self.paths[index]['ref_path']
        img_ref = imfrombytes(self.file_client.get(ref_path, 'ref')).astype(
            np.float32) / 255.

        if self.opt['phase'] == 'train':
            gt_size = self.opt['gt_size']
            img_ref = pil_bicubic_resize(img_ref, (gt_size, gt_size))
            img_in, img_ref = augment([img_in, img_ref], self.opt['use_flip'],
                                      self.opt['use_rot'])
        else:
            img_in = mod_crop(img_in, scale)
            img_in_gt = img_in.copy()
            img_ref = mod_crop(img_ref, scale)
            img_in_h, img_in_w = img_in.shape[:2]
            img_ref_h, img_ref_w = img_ref.shape[:2]
            padding = False
            if img_in_h != img_ref_h or img_in_w != img_ref_w:
                padding = True
                target_h = max(img_in_h, img_ref_h)
                target_w = max(img_in_w, img_ref_w)
                img_in = impad(img_in, (target_h, target_w))
                img_ref = impad(img_ref, (target_h, target_w))
            original_size = (img_in_h, img_in_w)

        img_in_lq, img_in_up = pil_chain_lq_up(img_in, scale)
        img_ref_lq, img_ref_up = pil_chain_lq_up(img_ref, scale)

        out = dict(zip(
            ('img_in', 'img_in_lq', 'img_in_up', 'img_ref', 'img_ref_lq',
             'img_ref_up'),
            to_rgb_hwc([img_in, img_in_lq, img_in_up, img_ref, img_ref_lq,
                        img_ref_up])))
        if self.opt['phase'] != 'train':
            out['img_in'] = to_rgb_hwc(img_in_gt)
            out['lq_path'] = ref_path
            out['padding'] = padding
            out['original_size'] = original_size
        return out

    def __len__(self):
        return len(self.paths)
