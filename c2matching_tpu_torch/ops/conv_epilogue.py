"""Conv epilogue: ``y = act(y + bias) [+ residual]``, in place on a conv's
NHWC output, in one pass.

No counterpart in the JAX package, where XLA fuses a convolution's bias,
activation and residual add into the convolution's output. PyTorch's cuDNN
path runs each as a pass of its own after the convolution; the CUDA source
``csrc/conv_epilogue.cu`` runs them in one, after a convolution that cuDNN
ran without a bias. ``conv_epilogue`` calls the registered operator
``torch.ops.c2matching.conv_epilogue`` (a fake implementation lets
``torch.export`` trace it): on a CPU tensor it takes the plain version,
``conv_epilogue_plain``; on a CUDA tensor it launches the kernel or raises.
"""
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

# the activations by name, and their codes in the kernel
ACTS = {None: 0, 'relu': 1, 'lrelu': 2}
LRELU_SLOPE = 0.1
_ENTRY = {torch.float32: 'c2m_conv_epilogue_f32',
          torch.bfloat16: 'c2m_conv_epilogue_bf16'}
DTYPES = tuple(_ENTRY)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_float,
                                      ctypes.c_void_p])


def _kernel(dtype):
    fn = getattr(_build.load('conv_epilogue'), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def conv_epilogue_plain(y, bias, act=None, residual=None, slope=LRELU_SLOPE):
    """Plain version, in place on ``y`` and returning it: the unfused
    sequence's ops and roundings (the bias add of PyTorch's cuDNN path,
    ``F.relu`` or ``F.leaky_relu``, then ``residual + out``)."""
    y.add_(bias)
    if act == 'relu':
        torch.relu_(y)
    elif act == 'lrelu':
        F.leaky_relu(y, slope, inplace=True)
    if residual is not None:
        y.add_(residual)
    return y


def conv_epilogue(y, bias, act=None, residual=None, slope=LRELU_SLOPE):
    """``y = act(y + bias) [+ residual]`` in place; returns ``y``.

    Args:
        y: (..., C) conv output, float32 or bfloat16, contiguous with C
            innermost (NHWC); overwritten.
        bias: (C,) of y's dtype.
        act: None, 'relu' or 'lrelu' (leaky ReLU of ``slope``).
        residual: None, or a tensor of y's shape and dtype, added last.

    Calls the registered operator ``torch.ops.c2matching.conv_epilogue``.
    Each value equals the unfused sequence's bit for bit: every
    intermediate is rounded to y's dtype where that sequence stores it.
    ``conv_epilogue.launches`` counts the kernel's launches (none on the
    CPU). Needs no graph: the caller runs it only where no autograd
    graph is recorded.
    """
    if act not in ACTS:
        raise ValueError(f'conv_epilogue: act {act!r} is none of '
                         f'{list(ACTS)}')
    torch.ops.c2matching.conv_epilogue(y, bias, ACTS[act], slope, residual)
    return y


conv_epilogue.launches = 0


@torch.library.custom_op('c2matching::conv_epilogue', mutates_args=('y',))
def _conv_epilogue_op(y: torch.Tensor, bias: torch.Tensor, act: int,
                      slope: float, residual: Optional[torch.Tensor]) -> None:
    """The operator behind ``conv_epilogue``: the plain version on a CPU
    tensor, the kernel on a CUDA tensor, and a refusal on any other
    device or on what the kernel does not take."""
    _check(y, bias, act, residual)
    if y.device.type == 'cpu':
        names = {code: name for name, code in ACTS.items()}
        conv_epilogue_plain(y, bias, names[act], residual, slope)
        return
    if residual is not None and (residual.untyped_storage().data_ptr()
                                 == y.untyped_storage().data_ptr()):
        raise ValueError('conv_epilogue: residual shares y\'s storage')
    with torch.cuda.device(y.device):
        err = _kernel(y.dtype)(
            y.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), y.numel(),
            y.shape[-1], act, slope, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'conv_epilogue kernel launch failed: CUDA error '
                           f'{err}')
    conv_epilogue.launches += 1


@_conv_epilogue_op.register_fake
def _(y, bias, act, slope, residual):
    _check(y, bias, act, residual, layout=False)


def _check(y, bias, act, residual, layout=True):
    """Raise on operands the kernel does not take (``layout``: their
    contiguity too, which a traced fake tensor need not show)."""
    if y.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'conv_epilogue: unsupported device {y.device}')
    if y.dtype not in _ENTRY:
        raise TypeError(f'conv_epilogue: y is {y.dtype}, not float32 or '
                        'bfloat16')
    if act not in ACTS.values():
        raise ValueError(f'conv_epilogue: unknown activation code {act}')
    if y.dim() < 1 or tuple(bias.shape) != (y.shape[-1],):
        raise ValueError(f'conv_epilogue: bias {tuple(bias.shape)} is not '
                         f'(C,) of y {tuple(y.shape)}')
    operands = [('bias', bias)]
    if residual is not None:
        if tuple(residual.shape) != tuple(y.shape):
            raise ValueError(f'conv_epilogue: residual '
                             f'{tuple(residual.shape)} is not y\'s shape '
                             f'{tuple(y.shape)}')
        operands.append(('residual', residual))
    for name, t in operands:
        if t.dtype != y.dtype:
            raise TypeError(f'conv_epilogue: {name} is {t.dtype}, y '
                            f'{y.dtype}')
        if t.device != y.device:
            raise ValueError(f'conv_epilogue: {name} lies on {t.device}, y '
                             f'on {y.device}')
    if layout:
        for name, t in [('y', y)] + operands:
            if not t.is_contiguous():
                raise ValueError(f'conv_epilogue: {name} is not contiguous '
                                 f'(strides {t.stride()}; C innermost)')
