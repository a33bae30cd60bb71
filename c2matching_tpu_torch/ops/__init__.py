"""Tensor ops of the port: resize, flow, patch matching, the deformable
conv (exact and windowed) and the conv epilogue, with the hand-written
kernels (patch-match argmax, the deformable im2col, the deformable conv's
backward, the window contraction and the conv epilogue) behind their
wrappers."""
from .conv_epilogue import conv_epilogue, conv_epilogue_plain
from .dcn_window import (modulated_deform_conv_windowed,
                         modulated_deform_conv_windowed_chunked,
                         window_applicable)
from .dcn_window_kernel import (window_contract, window_contract_plain,
                                window_conv, window_conv_plain)
from .deform_conv import (deform_col2im, deform_conv, deform_conv_backward,
                          deform_conv_backward_plain, deform_conv_fused,
                          deform_conv_fused_plain, deform_im2col,
                          deform_im2col_backward_plain, deform_im2col_plain,
                          deform_psroi_pooling, fused_applicable,
                          modulated_deform_conv, split_backward,
                          torch_weight_to_kco)
from .flow import (batched_pre_offsets, flow_warp, index_to_flow,
                   match_to_pre_offsets, resize_flow, shifted_offsets,
                   tensor_shift, upsample_flow)
from .patch_match import batched_patch_match, patch_match
from .patch_match_kernel import match_argmax, match_argmax_plain
from .resize import (bilinear_resize, nearest_up, pixel_shuffle,
                     pixel_unshuffle, upscale)

__all__ = [
    'batched_patch_match', 'batched_pre_offsets', 'bilinear_resize',
    'conv_epilogue', 'conv_epilogue_plain',
    'deform_col2im', 'deform_conv', 'deform_conv_backward',
    'deform_conv_backward_plain', 'deform_conv_fused',
    'deform_conv_fused_plain', 'deform_im2col',
    'deform_im2col_backward_plain', 'deform_im2col_plain',
    'deform_psroi_pooling', 'flow_warp', 'fused_applicable',
    'index_to_flow', 'match_argmax',
    'match_argmax_plain', 'match_to_pre_offsets', 'modulated_deform_conv',
    'modulated_deform_conv_windowed',
    'modulated_deform_conv_windowed_chunked', 'nearest_up', 'patch_match',
    'pixel_shuffle', 'pixel_unshuffle', 'resize_flow', 'shifted_offsets',
    'split_backward', 'tensor_shift', 'torch_weight_to_kco', 'upsample_flow',
    'upscale', 'window_applicable', 'window_contract',
    'window_contract_plain', 'window_conv', 'window_conv_plain',
]
