"""Patch-match argmax (kernel B1): the correlation matmul and a first-max
argmax over ref rows, without writing the scores.

Counterpart of ``c2matching_tpu/ops/pallas/patch_match_kernel.py``. The
CUDA source is ``csrc/patch_match.cu``: Hopper's ``wgmma`` on tiles that
TMA brings into a shared-memory ring, bf16 operands as they are and f32
operands as 3xTF32 (each split into two TF32 parts by an elementwise pass
into scratch the wrapper allocates, three products summed in f32).
``match_argmax`` calls the registered operator
``torch.ops.c2matching.match_argmax`` (a fake implementation gives its
output shapes to ``torch.export``): on a CPU tensor it takes the plain
version, ``match_argmax_plain``; on a CUDA tensor it launches the kernel or
raises.
"""
import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 7)
_ENTRY = {torch.float32: 'c2m_match_argmax_f32',
          torch.bfloat16: 'c2m_match_argmax_bf16'}


def _kernel(dtype):
    fn = getattr(_build.load('patch_match'), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def partitions(batch, nq, nr, dtype):
    """The number of ref-axis partitions the kernel splits a launch of
    these sizes into on the current CUDA device (1: no split)."""
    fn = _build.load('patch_match').c2m_match_argmax_parts
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    parts = fn(batch, nq, nr, int(dtype == torch.bfloat16))
    if parts < 1:
        raise RuntimeError(f'match_argmax: CUDA error {-parts} while sizing '
                           'the launch')
    return parts


def match_argmax_plain(q, r, ref_bias=None):
    """Plain version: the (B, Nq, Nr) scores in f32, then ``argmax`` (the
    first maximum) and ``max``. Same arguments and results as
    ``match_argmax``."""
    scores = torch.matmul(q.float(), r.float().transpose(-1, -2))
    if ref_bias is not None:
        scores = scores + ref_bias.float()
    # argmax returns the first maximal index (torch.max does not promise to)
    return scores.argmax(dim=-1).to(torch.int32), scores.amax(dim=-1)


def match_argmax(q, r, ref_bias=None):
    """argmax over ref rows of ``q @ r.T + ref_bias``, first maximum winning.

    Args:
        q: (B, Nq, D) or (Nq, D) query descriptors, float32 or bfloat16.
        r: (B, Nr, D) or (Nr, D) ref descriptors, same dtype (normalized by
            the caller). Accumulation is always f32.
        ref_bias: optional (Nr,) float32 additive score bias, shared by the
            batch (0 to keep a candidate, -1e30 to exclude it).
    Returns:
        (max_idx int32, max_val float32), each (B, Nq) or (Nq,).

    Calls the registered operator ``torch.ops.c2matching.match_argmax``.
    On a CUDA tensor D must be a multiple of 8 (16 bytes of bf16, the
    tensor maps' stride unit). For f32 operands the wrapper allocates
    their TF32 split as scratch: two f32 copies of q and of r. The
    kernel may split the ref axis into partitions and merge them in a
    last launch; ``match_argmax.launches`` counts one per call all the
    same. ``match_argmax.scratch_bytes`` holds the largest scratch one
    call in the process has allocated (``scratch_bytes``).
    """
    if q.dim() == 2:
        idx, val = match_argmax(q[None], r[None], ref_bias)
        return idx[0], val[0]
    _device(q)
    return torch.ops.c2matching.match_argmax(q, r, ref_bias)


match_argmax.launches = 0
match_argmax.scratch_bytes = 0


def scratch_bytes(batch, nq, nr, d, dtype, parts):
    """Bytes of device scratch the operator allocates for one launch:
    for f32 operands their TF32 split, two f32 copies of q and of r; past
    one partition, each partition's (max, argmax) of every query."""
    split = 2 * batch * (nq + nr) * d * 4 if dtype == torch.float32 else 0
    merge = batch * parts * nq * 8 if parts > 1 else 0
    return split + merge


def _count_scratch(nbytes):
    """Keep the largest scratch of one call on the counter."""
    match_argmax.scratch_bytes = max(match_argmax.scratch_bytes, nbytes)


@torch.library.custom_op('c2matching::match_argmax', mutates_args=())
def _match_argmax_op(q: torch.Tensor, r: torch.Tensor,
                     ref_bias: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator behind ``match_argmax`` on (B, Nq, D) and (B, Nr, D):
    the plain version on a CPU tensor, the kernel on a CUDA tensor, and a
    refusal on any other device."""
    if _device(q) == 'cpu':
        return match_argmax_plain(q, r, ref_bias)
    b, nq, nr = _check(q, r, ref_bias)
    d = q.shape[2]
    q = q.contiguous()
    r = r.contiguous()
    bias = None if ref_bias is None else ref_bias.contiguous()
    for t in (q, r):
        if t.data_ptr() % 16:
            raise ValueError('match_argmax: operands must be 16-byte aligned')
    idx = torch.empty((b, nq), dtype=torch.int32, device=q.device)
    val = torch.empty((b, nq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        parts = partitions(b, nq, nr, q.dtype)
        # f32: the operands' (big, small) TF32 parts, written by the
        # kernel's split pass; the partitions' (max, argmax), merged by its
        # last launch
        q_split = r_split = part_val = part_idx = None
        if q.dtype == torch.float32:
            q_split = torch.empty((2,) + tuple(q.shape), dtype=q.dtype,
                                  device=q.device)
            r_split = torch.empty((2,) + tuple(r.shape), dtype=r.dtype,
                                  device=q.device)
        if parts > 1:
            part_val = torch.empty((b, parts, nq), dtype=torch.float32,
                                   device=q.device)
            part_idx = torch.empty((b, parts, nq), dtype=torch.int32,
                                   device=q.device)
        err = _kernel(q.dtype)(
            q.data_ptr(), r.data_ptr(),
            None if bias is None else bias.data_ptr(), b, nq, nr, d, parts,
            None if q_split is None else q_split.data_ptr(),
            None if r_split is None else r_split.data_ptr(),
            None if part_val is None else part_val.data_ptr(),
            None if part_idx is None else part_idx.data_ptr(),
            idx.data_ptr(), val.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'match_argmax kernel launch failed: CUDA error '
                           f'{err}')
    match_argmax.launches += 1
    _count_scratch(scratch_bytes(b, nq, nr, d, q.dtype, parts))
    return idx, val


@_match_argmax_op.register_fake
def _(q, r, ref_bias):
    if q.device.type == 'cuda':
        _check(q, r, ref_bias)
    b, nq = q.shape[:2]
    return (q.new_empty((b, nq), dtype=torch.int32),
            q.new_empty((b, nq), dtype=torch.float32))


def _device(q):
    """'cpu' or 'cuda'; any other device (meta included, where the operator
    would take its fake implementation) is refused."""
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'match_argmax: unsupported device {q.device}')
    return q.device.type


def _check(q, r, ref_bias):
    """(B, Nq, Nr) of operands the kernel takes; raises on any other."""
    if q.dtype not in _ENTRY or r.dtype != q.dtype:
        raise TypeError(f'match_argmax: q {q.dtype} and r {r.dtype} must '
                        'both be float32 or both bfloat16')
    if q.dim() != 3 or r.dim() != 3 or q.shape[0] != r.shape[0] \
            or q.shape[2] != r.shape[2]:
        raise ValueError(f'match_argmax: shapes {tuple(q.shape)} and '
                         f'{tuple(r.shape)} do not pair')
    b, nq, d = q.shape
    nr = r.shape[1]
    if nq == 0 or nr == 0 or b == 0:
        raise ValueError('match_argmax: empty query or ref set')
    if r.device != q.device:
        raise ValueError('match_argmax: q and r lie on different devices')
    if ref_bias is not None and (tuple(ref_bias.shape) != (nr,)
                                 or ref_bias.dtype != torch.float32
                                 or ref_bias.device != q.device):
        raise ValueError('match_argmax: ref_bias must be float32 (Nr,) on '
                         "q's device")
    if d % 8:
        raise ValueError(f'match_argmax: D = {d} must be a multiple of 8 '
                         '(the kernel stages 16-byte vectors)')
    return b, nq, nr
