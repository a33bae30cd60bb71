"""Correspondence generation: dense matching -> multi-scale pre-offsets.

Counterpart of ``c2matching_tpu/models/archs/corres_generation_arch.py``.
The matching part has no parameters; the module carries the frozen VGG19
(``vgg.*``) that extracts the HR reference features for the restoration
net.

With a ``band`` (``val_spatial_shard``) each rank matches its band's
query rows and computes its band of the reference's VGG19 features; the
reference's contrastive features and its VGG19 features are gathered
whole, since the match and the deformable convs read all of them. (The
JAX package shards the reference too. Computing it whole on every rank
instead would repeat the VGG's work world times to save the gathers; the
whole features are on every rank either way: the relu1_1 of an HR
512x384 reference is 50 MB in f32.)
"""
from torch import nn

from ...ops.flow import batched_pre_offsets
from ...ops.patch_match import batched_patch_match
from ...parallel.spatial import gather_rows
from .vgg_arch import VGGFeatureExtractor


class CorrespondenceGenerationArch(nn.Module):
    """Match contrastive features; emit 9-candidate offsets and the VGG19
    features of the HR reference.

    ``match_dtype``: dtype of the correlation operands only (the serving
    knob); None keeps f32. ``dtype``: compute dtype of the VGG19's convs.
    ``stride`` is taken and not read, as in the JAX package (the match is
    dense at every stride).
    """

    def __init__(self, patch_size=3, stride=1,
                 vgg_layer_list=('relu3_1', 'relu2_1', 'relu1_1'),
                 vgg_type='vgg19', match_dtype=None, generator=None,
                 dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.match_dtype = match_dtype
        self.vgg = VGGFeatureExtractor(layer_name_list=list(vgg_layer_list),
                                       vgg_type=vgg_type, generator=generator,
                                       dtype=dtype)

    def forward(self, dense_features, img_ref_hr, band=None):
        """
        Args:
            dense_features: {'dense_features1': (B, H, W, C) input-branch
                features, 'dense_features2': (B, H, W, C) ref-branch ones}.
            img_ref_hr: (B, 4H, 4W, 3) HR reference image in [0, 1].
            band: None, or the ``parallel.Band`` (in the features' LR rows)
                of which the features and img_ref_hr hold the rows.
        Returns:
            (pre_offset, img_ref_feat): pre_offset maps relu{3,2,1}_1 to
            (B, 9, H_s, W_s, 2) offsets, last dim (x, y), the band's rows
            of them with a band; img_ref_feat maps the VGG layers to
            (B, H_s, W_s, C_s), whole.
        """
        feat_ref = dense_features['dense_features2']
        if band is not None:
            feat_ref = gather_rows(feat_ref, band)
        max_idx, _ = batched_patch_match(
            dense_features['dense_features1'], feat_ref,
            patch_size=self.patch_size, compute_dtype=self.match_dtype,
            band=band)
        pre_offset = batched_pre_offsets(max_idx, patch_size=self.patch_size,
                                         band=band)
        if band is None:
            return pre_offset, self.vgg(img_ref_hr)
        img_ref_feat = self.vgg(img_ref_hr, band.scaled(4))
        return pre_offset, {k: gather_rows(v, band)
                            for k, v in img_ref_feat.items()}
