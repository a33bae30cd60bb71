"""Datasets of the contrastive correspondence network (stages 1 and 2).

Counterpart of ``c2matching_tpu/data/contras_dataset.py``: a random
homography from jittered crop corners warps the input image; the item
holds both images, their PIL-bicubic down-and-up versions and the dense
transformed coordinate grid that gives the triplet loss its ground truth.
The cv2 calls are the port's own (``data/warp.py``). Randomness comes
from the global ``np.random`` and ``random`` states, with the same calls
in the same order as the JAX package; the validation pool of homographies
is drawn from ``RandomState(0)``. With ``io_backend: {type: lmdb}`` the
pairs are the two databases' shared keys, sorted, and every image is read
through the client key 'in', as in the JAX package.
"""
import numpy as np

from ..utils.util import imfrombytes
from .file_client import FileClient
from .transforms import augment, mod_crop, to_rgb_hwc
from .util import (paired_paths_from_ann_file, paired_paths_from_folder,
                   paired_paths_from_lmdb, pil_chain_lq_up)
from .warp import get_perspective_transform, resize_cubic, warp_perspective


def image_pair_generation(img, random_perturb_range=(0, 32),
                          cropping_window_size=160, rng=np.random):
    """A random homography from jittered crop corners. Returns (the warped
    image, H, H^-1), or with ``img`` None only H^-1 (drawn for a 160 x 160
    image)."""
    if img is not None:
        h, w = img.shape[:2]
    else:
        h = w = 160

    crop_s = cropping_window_size
    lo, hi = random_perturb_range
    x_tl = rng.randint(hi, max(w, w - crop_s - hi))
    y_tl = rng.randint(hi, max(h, h - crop_s - hi))
    rect1 = np.array(
        [(x_tl, y_tl), (x_tl + crop_s, y_tl), (x_tl + crop_s, y_tl + crop_s),
         (x_tl, y_tl + crop_s)], dtype=np.float32)

    def jitter(v):
        return v + rng.randint(lo, hi) * rng.choice([-1.0, 1.0])

    rect2 = np.array([(jitter(x), jitter(y)) for x, y in rect1],
                     dtype=np.float32)

    homography = get_perspective_transform(rect1, rect2)
    h_inverse = np.linalg.inv(homography)

    if img is not None:
        return warp_perspective(img, h_inverse, (w, h)), homography, h_inverse
    return h_inverse


def transformed_coordinate_grid(h_inverse, gt_h, gt_w):
    """The (gt_h, gt_w, 3) float32 grid of H^-1-transformed homogeneous
    (x, y, 1) pixel coordinates."""
    grid_x, grid_y = np.meshgrid(np.arange(gt_w), np.arange(gt_h))
    grid_z = np.ones(grid_x.shape)
    coordinate = np.stack((grid_x, grid_y, grid_z), axis=0).reshape(3, -1)
    transformed = h_inverse @ coordinate
    transformed = transformed / transformed[2, :]
    return transformed.T.reshape(gt_h, gt_w, 3).astype(np.float32)


class _ContrasBase:
    """opt keys: dataroot_in, dataroot_ref, io_backend, filename_tmpl,
    ann_file, scale, and in train gt_size, use_flip, use_rot. The ref
    folder (or database) only pairs the paths: both images of an item come
    from the input image."""

    def __init__(self, opt):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        folders = [opt['dataroot_in'], opt['dataroot_ref']]
        if self.io_backend_opt['type'] == 'lmdb':
            self.io_backend_opt['db_paths'] = folders
            self.io_backend_opt['client_keys'] = ['in', 'ref']
            self.paths = paired_paths_from_lmdb(folders, ['in', 'ref'])
        elif opt.get('ann_file'):
            self.paths = paired_paths_from_ann_file(folders, ['in', 'ref'],
                                                    opt['ann_file'])
        else:
            self.paths = paired_paths_from_folder(
                folders, ['in', 'ref'], opt.get('filename_tmpl') or '{}')

    def _load_bgr(self, path):
        if self.file_client is None:
            backend_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(backend_opt.pop('type'),
                                          **backend_opt)
        return imfrombytes(self.file_client.get(path, 'in')).astype(
            np.float32) / 255.

    def _finalize(self, img_in, img_in_transformed, h_inverse):
        gt_h, gt_w = img_in.shape[:2]
        scale = self.opt['scale']
        coords = transformed_coordinate_grid(h_inverse, gt_h, gt_w)
        _lq, img_in_up = pil_chain_lq_up(img_in, scale)
        _lq_t, img_in_transformed_up = pil_chain_lq_up(img_in_transformed,
                                                       scale)
        imgs = to_rgb_hwc([img_in, img_in_transformed, img_in_up,
                           img_in_transformed_up])
        return {
            'img_in': imgs[0],
            'img_in_up': imgs[2],
            'img_ref': imgs[1],
            'img_ref_up': imgs[3],
            'transformed_coordinate': coords,
        }

    def __len__(self):
        return len(self.paths)


class ContrasDataset(_ContrasBase):
    """Training pairs: the input resized to ``gt_size`` (cv2's bicubic),
    flipped and rotated, and a random homography per item."""

    def __getitem__(self, index):
        img_in = self._load_bgr(self.paths[index]['in_path'])
        gt_h = gt_w = self.opt['gt_size']
        img_in = resize_cubic(img_in, (gt_w, gt_h))
        img_in = augment([img_in], self.opt['use_flip'], self.opt['use_rot'])
        img_in_transformed, _h, h_inverse = image_pair_generation(
            img_in, (0, 10), 160)
        return self._finalize(img_in, img_in_transformed, h_inverse)


class ContrasValDataset(_ContrasBase):
    """Validation pairs: the input mod-cropped to the scale, warped by a
    fixed pool of homographies drawn from ``RandomState(0)``."""

    def __init__(self, opt):
        super().__init__(opt)
        rng = np.random.RandomState(0)
        self.transform_matrices = [
            image_pair_generation(None, (0, 10), 160, rng=rng)
            for _ in range(len(self.paths))
        ]

    def __getitem__(self, index):
        img_path = self.paths[index]['in_path']
        img_in = mod_crop(self._load_bgr(img_path), self.opt['scale'])
        gt_h, gt_w = img_in.shape[:2]
        h_inverse = self.transform_matrices[index]
        img_in_transformed = warp_perspective(img_in, h_inverse, (gt_w, gt_h))
        out = self._finalize(img_in, img_in_transformed, h_inverse)
        out['name'] = img_path
        return out
