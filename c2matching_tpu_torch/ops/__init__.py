"""Tensor ops of the port: resize, flow, patch matching and the deformable
conv (exact and windowed), with the three hand-written kernels
(patch-match argmax, the deformable im2col and the window contraction)
behind their wrappers."""
from .dcn_window import (modulated_deform_conv_windowed,
                         modulated_deform_conv_windowed_chunked,
                         window_applicable)
from .dcn_window_kernel import (window_contract, window_contract_plain,
                                window_conv, window_conv_plain)
from .deform_conv import (deform_conv, deform_im2col, deform_im2col_plain,
                          modulated_deform_conv)
from .flow import batched_pre_offsets, match_to_pre_offsets
from .patch_match import batched_patch_match, patch_match
from .patch_match_kernel import match_argmax, match_argmax_plain
from .resize import pixel_shuffle, upscale

__all__ = [
    'batched_patch_match', 'batched_pre_offsets', 'deform_conv',
    'deform_im2col', 'deform_im2col_plain', 'match_argmax',
    'match_argmax_plain', 'match_to_pre_offsets', 'modulated_deform_conv',
    'modulated_deform_conv_windowed',
    'modulated_deform_conv_windowed_chunked', 'patch_match', 'pixel_shuffle',
    'upscale', 'window_applicable', 'window_contract',
    'window_contract_plain', 'window_conv', 'window_conv_plain',
]
