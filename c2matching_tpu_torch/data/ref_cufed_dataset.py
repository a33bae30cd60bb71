"""Reference-based CUFED dataset (input, ref) pair loader, test phase.

Counterpart of ``c2matching_tpu/data/ref_cufed_dataset.py`` for the
``val`` / ``test`` phases: decode to BGR float [0, 1], mod-crop to the
scale, zero-pad input and ref to a common size when they differ, then the
PIL-bicubic down x1/scale and back up chain with its uint8 round trips.
Output arrays are HWC RGB float32; ``img_in`` is the input before the pad,
and ``lq_path`` is the ref path, as in the JAX package. The train phase
(PIL resize of the ref to ``gt_size``, flips and rotations) waits for the
training slice.
"""
import numpy as np

from ..utils.util import imfrombytes, impad
from .file_client import FileClient
from .transforms import mod_crop, to_rgb_hwc
from .util import (paired_paths_from_ann_file, paired_paths_from_folder,
                   pil_chain_lq_up)


class RefCUFEDDataset:
    """opt keys: dataroot_in, dataroot_ref, ann_file, io_backend,
    filename_tmpl, scale, phase."""

    def __init__(self, opt):
        if opt['phase'] == 'train':
            raise NotImplementedError(
                'RefCUFEDDataset: the train phase is not ported yet; it '
                'comes with the stage-3 training slice')
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        if self.io_backend_opt['type'] != 'disk':
            raise ValueError(
                f"RefCUFEDDataset: io_backend {self.io_backend_opt['type']!r}"
                " is not ported; the port reads from 'disk'")
        self.in_folder = opt['dataroot_in']
        self.ref_folder = opt['dataroot_ref']
        self.filename_tmpl = opt.get('filename_tmpl') or '{}'

        if opt.get('ann_file'):
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
        out['img_in'] = to_rgb_hwc(img_in_gt)
        out['lq_path'] = ref_path
        out['padding'] = padding
        out['original_size'] = original_size
        return out

    def __len__(self):
        return len(self.paths)
