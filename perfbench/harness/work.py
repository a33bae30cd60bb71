"""The chip's peaks and the work of the measured layers.

Peaks: NVIDIA's data sheet for one H100 SXM (dense, at the 700 W limit):
3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores, 495
TFLOP/s TF32 and 989 TFLOP/s bfloat16 on them. A share of a peak is the
least time the chip could take for the work over the time measured, so a
sound count never passes 100%.

The work functions count what the algorithm needs at the request's own
(valid) size, never what an implementation hands its kernels: each input
and output byte once, each multiply-add as two operations.
"""
import torch

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {'float32': 67e12, 'tfloat32': 495e12, 'bfloat16': 989e12}
# bilinear sample of one column element: the four corner weights, four
# multiply-adds and the mask (as in the B3 kernel's own count)
SAMPLE_OPS = 13
# a column element's share of the offset and mask gradients: the four
# corner dots' multiply-adds and the two coordinate weights
BACKWARD_SAMPLE_OPS = 8
ELEM = {'float32': 4, 'bfloat16': 2}


def bound_s(nbytes, tensor_core_s=0.0, simt_s=0.0):
    """The least seconds for the work: bytes at the memory rate against
    the tensor cores' and the SIMT pipes' seconds, which may overlap."""
    return max(nbytes / PEAK_BYTES_S, tensor_core_s, simt_s)


def layer_sizes(hr):
    """{VGG layer: (height, width)} of the restoration's three scales for
    an HR request of ``hr``: relu3_1 at the LR size, relu2_1 at twice it,
    relu1_1 at the HR size."""
    h, w = hr
    return {'relu3_1': (h // 4, w // 4), 'relu2_1': (h // 2, w // 2),
            'relu1_1': (h, w)}


LAYER_CHANNELS = {'relu3_1': 256, 'relu2_1': 128, 'relu1_1': 64}
# the matcher's features: the contrastive extractor's conv3_1
MATCH_CHANNELS = 256


def match_patches(valid_hw):
    """The 3x3 patches of a valid feature size: queries, and reference
    patches that can win."""
    return (valid_hw[0] - 2) * (valid_hw[1] - 2)


def b1_work(n_query, n_ref, depth, dtype, batch=1):
    """(bytes, operations, seconds bound) of the argmax over ``n_ref``
    reference patches of ``n_query`` query patches, ``depth`` deep (9
    times the channels), for ``batch`` pairs: q and r read once in
    ``dtype``, an index and a value written per query."""
    nbytes = batch * ((n_query + n_ref) * depth * ELEM[dtype] + 8 * n_query)
    ops = batch * 2 * n_query * n_ref * depth
    if dtype == 'bfloat16':
        t = ops / PEAK_FLOPS['bfloat16']
    else:       # float32 to float32 accuracy: three TF32 products
        t = 3 * ops / PEAK_FLOPS['tfloat32']
    return nbytes, ops, bound_s(nbytes, tensor_core_s=t)


def dynagg_work(shape, ref_channels, offset_channels, groups, gather_dtype):
    """(bytes, seconds bound) of one DynAgg call on ``shape`` = (B, H, W):
    the reference feature, the offset feature, the match's offsets, both
    weights and the output once; the offset conv in TF32, the
    contraction in the gather dtype (float32 matmuls run without TF32),
    the bilinear sampling on the SIMT pipes."""
    b, h, w = shape
    c, cp, taps = ref_channels, offset_channels, 9
    p = b * h * w
    om = 3 * groups * taps
    nbytes = 4 * (p * c + p * cp + p * taps * 2 + om * (cp * taps + 1)
                  + c * (c * taps + 1) + p * c)
    conv_ops = 2 * p * taps * cp * om
    contract_ops = 2 * p * taps * c * c
    cols = p * taps * c
    tc = conv_ops / PEAK_FLOPS['tfloat32']
    simt = SAMPLE_OPS * cols / PEAK_FLOPS['float32']
    if gather_dtype == 'bfloat16':
        tc += contract_ops / PEAK_FLOPS['bfloat16']
    else:
        simt += contract_ops / PEAK_FLOPS['float32']
    return nbytes, bound_s(nbytes, tensor_core_s=tc, simt_s=simt)


def b3_backward_work(shape, channels, groups, co, dtype='float32'):
    """(bytes, seconds bound) of the offset and mask gradients of one
    DynAgg over a batch: x, the offsets, the mask, grad_out and the
    (9C, Co) weight read once, the two gradients written once; the
    columns' gradient grad_out @ w^T as three TF32 products, then the
    corner dots."""
    b, h, w = shape
    taps = 9
    p = b * h * w
    n_cols = p * taps * channels
    e = ELEM[dtype]
    offsets = p * groups * taps * 2 * 4
    masks = p * groups * taps * 4
    nbytes = (p * channels * e + offsets + masks + p * co * 4
              + taps * channels * co * 4 + offsets + masks)
    tf32_ops = 3 * 2 * n_cols * co
    f32_ops = BACKWARD_SAMPLE_OPS * n_cols
    return nbytes, bound_s(nbytes,
                           tensor_core_s=tf32_ops / PEAK_FLOPS['tfloat32'],
                           simt_s=f32_ops / PEAK_FLOPS['float32'])


def count_flops(fn, *args, **kwargs):
    """Total FLOPs of ``fn(*args)`` under ``FlopCounterMode`` (run it on
    'meta' tensors: nothing is computed)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()
