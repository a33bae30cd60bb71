#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. card: name and power limit; build the kernels from csrc/ (nvcc).
  2. b1: the patch-match argmax kernel against its plain version on
     random descriptors at the unpadded CUFED5 shape (10332 x 10332,
     D = 2304) in f32 and bf16, plus ragged shapes (batch 2, nq and nr off
     the 128-row tiles, a depth off the 32-word stages), the depths the
     wrapper refuses, exact ties across ref tiles and across the
     partitions of the ref axis, near ties (top-2 gaps from 1e-7 to 1e-3
     on patch-structured descriptors at D = 2304) and the ref_bias
     exclusion.
  3. b3: the deformable im2col kernel against its plain version on random
     inputs at the three unpadded DynAgg shapes of CUFED5 in f32 and bf16,
     plus odd shapes (Cg = 1, 3 and 6, which take the scalar channel loop;
     stride 2; dilation 2), a bf16 image of 1536x1536x128 whose columns
     pass 2^31 elements (64-bit index math; its first and last rows
     against the plain version) and the large-offset probe, which must
     give exact zeros.
  4. b2: the window-contraction kernel of the windowed deformable conv in
     image mode (window_conv: it reads x at each window's origin) against
     its plain version and, bit for bit, against rows mode (window_contract
     on the gathered windows); and the windowed op against the exact op;
     on random DynAgg-structured inputs (G = 8; a block-constant integer
     flow in +-16 plus a residual in +-0.4) at relu1 512x384x64 (blk 4,
     win 8) and relu2 256x192x128 (blk 2, win 6), in f32 and bf16; a
     fallback probe (residual x 5) that must equal the exact op bit for
     bit with no kernel launch; the row-chunked form (8 launches); rows
     mode on odd shapes (ragged tiles, C and Co off the tiles, window
     coordinates far outside the window); image mode on odd shapes with
     origins at both clamps (window rows and columns in the zero ring),
     an output grid smaller than the image, C and Co off the tiles, huge
     coordinates and zero modulation; and shapes or types the kernel
     refuses, which must raise on the card.
  5. main: RefRestorationModel.feed_data / test at full width (ngf 64,
     16 blocks, 8 groups; random weights from a seeded generator) in the
     f32 config and the serving config (bf16 gathers and match operands),
     over requests of CUFED5 size, one of them off the bucket; the launch
     counters must rise on this path; a small request must agree with the
     same nets run on the CPU, where the plain versions run. One more
     HR 512x336 request per config records every kernel's inputs.
  6. path: each kernel against its plain version on exactly the tensors
     the main path gave it (B1 at 11844 x 11844 x 2304 with the valid-shape
     ref_bias; B3 at the padded 128x96, 256x192 and 512x384 DynAggs), in
     both configs; then the windowed op, which no model calls, on the
     relu1 (blk 4) and relu2 (blk 2) DynAggs' own tensors: the branch it
     takes, B2 in image mode against its plain version and rows mode
     there, the prep's and B2's times, and the windowed op against the
     exact op. These are the times of the kernels line.
  7. one JSON line of kernels, the card's line, and last the JSON result.

Exits non-zero, printing no result, when a phase fails or no CUDA card
is present. TF32 is off for convolutions and matmuls throughout.
"""
import contextlib
import importlib
import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

B1_VAL_TOL = 1e-4    # |kernel - plain| of the max score: f32 sums of the
                     # same exact products in two orders, scores of O(4)
B1_GAP_TOL = 1e-4    # indices must agree where the plain top-2 gap exceeds
                     # this; below it the two summation orders may pick
                     # either of two near-equal candidates
B3_F32_TOL = 1e-5    # |kernel - plain| of f32 columns (values of O(1);
                     # the kernel may fuse multiply-adds)
B3_BF16_REL = 2 ** -8  # bf16 columns: one round-to-nearest of the exact
                       # value (half an ulp, at most 2^-8 relative)
MAIN_CPU_TOL = 1e-3  # card (kernels, cuDNN) vs CPU (plain versions) output
                     # of the full f32 model on a small request
B3_LIB_TOL = 1e-3    # grid_sample (the library yardstick) vs B3's columns:
                     # it maps coordinates to [-1, 1] and back, which moves
                     # a sample by ~1e-5 px at 512 px
B2_F32_TOL = 1e-5    # |kernel - plain| of B2's output, f32 rows (outputs
                     # of O(1) at the DCN init scale; sums in other orders)
B2_BF16_TOL = 1e-4   # bf16 rows: both convert the same values to f32
WIN_F32_REL = 1e-4   # windowed op vs exact op, of max |out|: tents and
                     # bilinear corner weights round apart
WIN_BF16_REL = 0.03  # bf16 x: the exact op rounds the weight to bf16, the
                     # windowed op keeps it f32

F32_BLOCKS = {
    'network_g': {'type': 'RestorationNet', 'ngf': 64, 'n_blocks': 16,
                  'groups': 8},
    'network_map': {'type': 'CorrespondenceGenerationArch', 'patch_size': 3,
                    'stride': 1,
                    'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                    'vgg_type': 'vgg19'},
    'network_extractor': {'type': 'ContrasExtractorSep'},
}
SERVING_BLOCKS = {
    'network_g': dict(F32_BLOCKS['network_g'], gather_dtype='bfloat16',
                      trunk_unroll=16),
    'network_map': dict(F32_BLOCKS['network_map'], match_dtype='bfloat16'),
    'network_extractor': {'type': 'ContrasExtractorSep'},
}
# HR request sizes: the CUFED5 bench shape, a CUFED5 image off the 64-px
# bucket, and one on it
REQUESTS = ((512, 336), (500, 332), (512, 384))
DCN_SHAPES = (('relu3_1', 128, 84, 256), ('relu2_1', 256, 168, 128),
              ('relu1_1', 512, 336, 64))
# what the main path hands the kernels for REQUESTS[0], padded to the
# bucket of 16 LR pixels (LR 128x84 -> 128x96): relu3_1 features of
# 128x96 give 126x94 descriptors, and the ref_bias excludes the 126 x 12
# ref patches past the valid 128x84; DynAgg samples at 1x, 2x and 4x
PATH_B1 = (1, 126 * 94, 9 * 256)
PATH_B1_EXCLUDED = 126 * (94 - 82)
PATH_B3 = ((128, 96, 256), (256, 192, 128), (512, 384, 64))
# the windowed op's (blk, win) by the padded DynAgg shape it serves; the
# same shapes, with random DynAgg-structured inputs, in phase b2
WINDOWED = {(512, 384, 64): ('relu1_1', 4, 8),
            (256, 192, 128): ('relu2_1', 2, 6)}
# published peaks of one H100 SXM (dense, at the 700 W limit): device
# memory, f32 outside the tensor cores, bf16 and TF32 in them
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, 'tf32': 495e12}
# B1 runs f32 operands as 3xTF32: three TF32 products per f32 product
B1_TF32_PRODUCTS = 3


class Checks:
    """Collects failed checks so that every phase reports before exit."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        print(('ok   ' if ok else 'FAIL ') + what, flush=True)
        if not ok:
            self.failed.append(what)
        return ok


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, min_ms=25.0):
    """Mean device time of ``fn`` over enough runs to fill ``min_ms`` of
    device time (at least 3), after one timed warm-up. The events bracket
    a whole queue of calls, so the host's time to launch the first call is
    spread over all of them: with 3 runs it would add ~15 us to each,
    which a kernel of 0.1 ms would feel."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(200, math.ceil(min_ms / max(start.elapsed_time(end),
                                                  1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, rate):
    """The least time the card could take for the work, in ms, and what
    bounds it: the bytes over the memory rate against the operations over
    the peak rate of their type (a key of PEAK_FLOPS)."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_S
    t_ops = 1e3 * ops / PEAK_FLOPS[rate]
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ----------------------------------------------------------------- B1
def _b1_compare(check, q, r, bias, label):
    from c2matching_tpu_torch.ops import match_argmax, match_argmax_plain
    idx_k, val_k = match_argmax(q, r, bias)
    idx_p, val_p = match_argmax_plain(q, r, bias)
    scores = torch.matmul(q.float(), r.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    top2 = scores.topk(2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    clear = gaps > B1_GAP_TOL
    near = (gaps >= 1e-7) & (gaps <= 1e-3)
    same = (idx_k == idx_p) | ~clear
    picked = scores.gather(-1, idx_k.long()[..., None])[..., 0]
    err = (val_k - val_p).abs().max().item()
    check(bool(same.all()), f'b1 {label}: indices equal on the '
          f'{int(clear.sum())} of {clear.numel()} rows with top-2 gap > '
          f'{B1_GAP_TOL:g} (on all rows: {int((idx_k == idx_p).sum())}; '
          f'{int(near.sum())} rows have a gap in [1e-7, 1e-3])')
    check(bool(((picked - val_p).abs() <= B1_GAP_TOL).all()),
          f'b1 {label}: every picked index scores within {B1_GAP_TOL:g} of '
          'the max')
    check(err <= B1_VAL_TOL, f'b1 {label}: max |val diff| {err:.3g} <= '
          f'{B1_VAL_TOL:g}')
    return idx_k, err


def _b1_time(q, r, bias, label):
    from c2matching_tpu_torch.ops import match_argmax, match_argmax_plain
    ms = cuda_ms(lambda: match_argmax(q, r, bias))
    plain_ms = cuda_ms(lambda: match_argmax_plain(q, r, bias))
    print(f'b1 {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms',
          flush=True)
    return ms, plain_ms


def _b1_work(q, r, bias):
    """(bytes, operations) of B1: read q, r and the bias once, write the
    index and the value; a multiply-add per (query, kept ref row,
    channel): excluded ref rows cannot win, so their products are not
    needed."""
    b, nq, d = q.shape
    kept = r.shape[1] if bias is None else int((bias == 0).sum())
    moved = nbytes(q, r) + (0 if bias is None else nbytes(bias)) + 8 * b * nq
    return moved, 2 * b * nq * kept * d


def _b1_library_ms(q, r, bias):
    """The same function as PyTorch calls: torch.matmul, the bias, max."""
    def call():
        scores = torch.matmul(q, r.mT)
        return (scores if bias is None else scores + bias).max(dim=-1)
    return cuda_ms(call)


def phase_b1(check, dev):
    from c2matching_tpu_torch.ops import match_argmax, match_argmax_plain
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # the CUFED5 bucket: 126 x 82 descriptors of 9 x 256 channels
    nq = nr = 126 * 82
    d = 9 * 256
    q = randn(nq, d)
    r = randn(nr, d)
    r = r / r.norm(dim=-1, keepdim=True)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        qd, rd = q.to(dtype), r.to(dtype)
        _b1_compare(check, qd, rd, None, f'{nq}x{nr}x{d} {name}')
        _b1_time(qd, rd, None, f'{nq}x{nr}x{d} {name}')
    del q, r, qd, rd
    torch.cuda.empty_cache()

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        # ragged shapes, batched: nq and nr off the 128-row tiles, D off
        # the 32-word stages (a zero-filled tail stage), the ref axis split;
        # ref rows normalised as the main path's, so scores stay O(4)
        _b1_compare(check, randn(2, 300, 72).to(dtype),
                    randn(2, 470, 72).to(dtype), None,
                    f'ragged 2x300x470x72 {name}')
        r = randn(2, 3001, 2312)
        _b1_compare(check, randn(2, 1000, 2312).to(dtype),
                    (r / r.norm(dim=-1, keepdim=True)).to(dtype), None,
                    f'ragged 2x1000x3001x2312 {name} '
                    f'({_b1_parts(2, 1000, 3001, dtype)} partitions)')
        for d_bad in (27, 12):
            try:
                match_argmax(randn(300, d_bad).to(dtype),
                             randn(470, d_bad).to(dtype))
                raised = False
            except ValueError:
                raised = True
            check(raised, f'b1 D = {d_bad} {name}: the wrapper refuses '
                  'D % 8 != 0')
        # exact ties: duplicated ref rows in one 128-row tile and across
        # two, and adjacent (a thread's two columns); the lowest wins
        base = randn(50, 64)
        for r_tie, want in ((torch.cat([base] * 3), torch.arange(50)),
                            (base.repeat_interleave(3, dim=0),
                             3 * torch.arange(50))):
            idx, _ = match_argmax((2 * base).to(dtype), r_tie.to(dtype))
            check(torch.equal(idx.long().cpu(), want),
                  f'b1 ties {name}: the lowest duplicate index wins')
        # exact ties across ref tiles and across partitions: few queries
        # split the ref axis into many partitions, many into few
        for nq_tie in (200, 4096):
            _b1_tie_probe(check, gen, dev, dtype, nq_tie)
        # near ties at full depth
        q, r = _b1_near_ties(gen, dev)
        _b1_compare(check, q.to(dtype), r.to(dtype), None,
                    f'near ties {q.shape[0]}x{r.shape[0]}x{q.shape[1]} {name}'
                    f' ({_b1_parts(1, q.shape[0], r.shape[0], dtype)} '
                    'partitions)')
        del q, r
        # ref_bias: exclude the unbiased winner of every other query
        q = randn(700, 64).to(dtype)
        r = randn(1000, 64).to(dtype)
        win, _ = match_argmax_plain(q, r)
        keep = torch.rand(1000, generator=gen, device=dev) > 0.5
        keep[win[::2].long()] = False
        bias = torch.where(keep, 0.0, -1e30).float()
        idx, _ = _b1_compare(check, q, r, bias, f'ref_bias {name}')
        check(bool(keep[idx.long()].all()),
              f'b1 ref_bias {name}: no excluded row wins')


def _b1_parts(batch, nq, nr, dtype):
    pmk = importlib.import_module('c2matching_tpu_torch.ops.'
                                  'patch_match_kernel')
    return pmk.partitions(batch, nq, nr, dtype)


def _b1_tie_probe(check, gen, dev, dtype, nq, d=256, copies=3):
    """Each query's best ref row duplicated at `copies` random positions
    among normalised random rows (at least 5120 ref rows, 4 per
    duplicate): the lowest position must win."""
    from c2matching_tpu_torch.ops import match_argmax
    name = str(dtype).replace('torch.', '')
    nr = max(5120, 4 * copies * nq)
    base = torch.randn(nq, d, generator=gen, device=dev)
    r = torch.randn(nr, d, generator=gen, device=dev)
    r = r / r.norm(dim=-1, keepdim=True)
    pos = torch.randperm(nr, generator=gen, device=dev)[:copies * nq]
    pos = pos.reshape(nq, copies)
    r[pos.reshape(-1)] = base.repeat_interleave(copies, dim=0)
    parts = _b1_parts(1, nq, nr, dtype)
    idx, _ = match_argmax((2 * base).to(dtype), r.to(dtype))
    check(torch.equal(idx.long(), pos.min(dim=1).values),
          f'b1 ties {name} {nq}x{nr}x{d}: the lowest of {copies} duplicates '
          f'wins across 128-row ref tiles and {parts} partitions')
    if nq <= 256:
        check(parts > 1, f'b1 ties {name} {nq}x{nr}: the ref axis is split '
              f'({parts} partitions)')


def _b1_near_ties(gen, dev, n=2048, extra=2000, d=9 * 256):
    """Patch-structured descriptors: q of 9 L2-normalised pixels of 256
    channels; for each query a normalised near copy of it and a second
    row that scores higher by a gap drawn log-uniformly from 1e-7 to
    1e-3; both among normalised random rows, all shuffled. Returns
    (q, r) in f32."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q = randn(n, 9, d // 9)
    q = (q / q.norm(dim=-1, keepdim=True)).reshape(n, d)
    first = q + 0.02 * randn(n, d)
    first = first / first.norm(dim=-1, keepdim=True)
    gap = 10 ** (-7 + 4 * torch.rand(n, 1, generator=gen, device=dev))
    second = first + gap * q / (q * q).sum(-1, keepdim=True)
    rest = randn(extra, d)
    r = torch.cat([first, second, rest / rest.norm(dim=-1, keepdim=True)])
    perm = torch.randperm(r.shape[0], generator=gen, device=dev)
    return q, r[perm].contiguous()


# ----------------------------------------------------------------- B3
def _dcn_inputs(gen, dev, h, w, c, dtype, g=8, k=9):
    x = torch.randn(h, w, c, generator=gen, device=dev).to(dtype)
    # match offsets are integer shifts; the learned residual is small
    shift = torch.randint(-16, 17, (h, w, 1, k, 2), generator=gen,
                          device=dev).float()
    offset = (shift + 0.5 * torch.randn(h, w, g, k, 2, generator=gen,
                                        device=dev)).contiguous()
    mask = torch.rand(h, w, g, k, generator=gen, device=dev)
    return x, offset, mask


def _b3_compare(check, x, offset, mask, label, **conv):
    """Kernel columns against the plain version's on the same inputs
    (``conv``: the stride, padding and dilation); returns the max
    |difference|."""
    from c2matching_tpu_torch.ops import deform_im2col, deform_im2col_plain
    cols_k = deform_im2col(x, offset, mask, **conv).float()
    err = (cols_k - deform_im2col_plain(x, offset, mask, **conv).float())
    err = err.abs().max().item()
    if x.dtype == torch.float32:
        ok = err <= B3_F32_TOL
        bound = f'{B3_F32_TOL:g}'
    else:
        # against the unrounded f32 columns of the same bf16 input: one
        # rounding to bf16 plus f32 arithmetic error
        exact = deform_im2col_plain(x.float(), offset, mask, **conv)
        ok = bool(((cols_k - exact).abs()
                   <= B3_BF16_REL * exact.abs() + B3_F32_TOL).all())
        bound = f'{B3_BF16_REL:g}|v| + {B3_F32_TOL:g} of the f32 columns'
        del exact
    check(ok, f'b3 {label}: max |cols diff| {err:.3g} within {bound}')
    del cols_k
    torch.cuda.empty_cache()
    return err


def _b3_time(x, offset, mask, label):
    from c2matching_tpu_torch.ops import deform_im2col, deform_im2col_plain
    ms = cuda_ms(lambda: deform_im2col(x, offset, mask))
    plain_ms = cuda_ms(lambda: deform_im2col_plain(x, offset, mask))
    print(f'b3 {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms',
          flush=True)
    torch.cuda.empty_cache()
    return ms, plain_ms


# ops per column element: four corner weights, four multiply-adds, the mask
B3_OPS_PER_COL = 13


def _b3_work(x, offset, mask):
    """(bytes, operations) of B3 on one image: read x, the offsets and the
    mask once, write the columns once."""
    ho, wo, _, k, _ = offset.shape
    n_cols = ho * wo * k * x.shape[-1]
    moved = nbytes(x, offset, mask) + n_cols * x.element_size()
    return moved, B3_OPS_PER_COL * n_cols


def _b3_library(check, x, offset, mask, label):
    """F.grid_sample computes B3's bilinear samples with the same zero
    padding, one batch entry per group (coordinates mapped to [-1, 1] with
    align_corners); checks that against the kernel's columns and returns
    the time of the grid_sample call alone."""
    from c2matching_tpu_torch.ops import deform_im2col
    h, w, c = x.shape
    ho, wo, g, k, _ = offset.shape
    base_y = torch.arange(ho, device=x.device, dtype=torch.float32) - 1
    base_x = torch.arange(wo, device=x.device, dtype=torch.float32) - 1
    tap = torch.arange(k, device=x.device)
    sy = base_y[:, None, None, None] + (tap // 3).float() + offset[..., 0]
    sx = base_x[None, :, None, None] + (tap % 3).float() + offset[..., 1]
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    grid = grid.reshape(ho * wo, g, k, 2).permute(1, 0, 2, 3).contiguous()
    inp = x.reshape(h, w, g, c // g).permute(2, 3, 0, 1).contiguous()

    def call():
        return F.grid_sample(inp, grid, mode='bilinear', padding_mode='zeros',
                             align_corners=True)

    samples = call() * mask.reshape(ho * wo, g, k).permute(1, 0, 2)[:, None]
    cols = samples.permute(2, 3, 0, 1).reshape(ho * wo, k * c)
    err = (cols - deform_im2col(x, offset, mask)).abs().max().item()
    check(err <= B3_LIB_TOL, f'b3 {label}: grid_sample yardstick within '
          f'{err:.3g} <= {B3_LIB_TOL:g} of the kernel columns')
    del samples, cols
    return cuda_ms(call)


def _b3_wide_probe(check, gen, dev, dtype, h=1536, w=1536, c=128):
    """An image whose columns pass 2^31 elements, which the kernel serves
    with 64-bit index math: its first and last output rows against the
    plain version on those rows alone (their offsets moved by the rows
    skipped, so the sample points stay the same)."""
    from c2matching_tpu_torch.ops import deform_im2col, deform_im2col_plain
    name = str(dtype).replace('torch.', '')
    x, offset, mask = _dcn_inputs(gen, dev, h, w, c, dtype)
    cols = deform_im2col(x, offset, mask)
    n = cols.numel()
    worst = 0.0
    for r0 in (0, h - 4):
        sub = offset[r0:r0 + 4].clone()
        sub[..., 0] += r0
        want = deform_im2col_plain(x, sub, mask[r0:r0 + 4]).float()
        got = cols[r0 * w:(r0 + 4) * w].float()
        exact = deform_im2col_plain(x.float(), sub, mask[r0:r0 + 4])
        check(bool(((got - exact).abs()
                    <= B3_BF16_REL * exact.abs() + B3_F32_TOL).all()),
              f'b3 wide {h}x{w}x{c} {name} ({n / 2 ** 31:.2f} x 2^31 column '
              f'elements), rows {r0}-{r0 + 3}: within {B3_BF16_REL:g}|v| + '
              f'{B3_F32_TOL:g} of the f32 columns')
        worst = max(worst, (got - want).abs().max().item())
    print(f'b3 wide {h}x{w}x{c} {name}: max |cols diff| {worst:.3g} against '
          'the plain version', flush=True)
    del x, offset, mask, cols
    torch.cuda.empty_cache()


def phase_b3(check, dev):
    from c2matching_tpu_torch.ops import deform_im2col, modulated_deform_conv
    gen = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        for layer, h, w, c in DCN_SHAPES:
            x, offset, mask = _dcn_inputs(gen, dev, h, w, c, dtype)
            label = f'{layer} {h}x{w}x{c} {name}'
            _b3_compare(check, x, offset, mask, label)
            _b3_time(x, offset, mask, label)

        # odd shapes: Cg = 1, 3 and 6 (the scalar channel loop), stride 2,
        # dilation 2
        for h, w, c, stride, pad, dil in ((37, 29, 8, 1, 1, 1),
                                          (37, 29, 24, 1, 1, 1),
                                          (37, 29, 48, 1, 1, 1),
                                          (64, 48, 64, 2, 1, 1),
                                          (64, 48, 128, 1, 2, 2)):
            ho = (h + 2 * pad - 2 * dil - 1) // stride + 1
            wo = (w + 2 * pad - 2 * dil - 1) // stride + 1
            x = torch.randn(h, w, c, generator=gen, device=dev).to(dtype)
            _, offset, mask = _dcn_inputs(gen, dev, ho, wo, 8, dtype)
            _b3_compare(check, x, offset, mask,
                        f'odd {h}x{w}x{c} Cg {c // 8} stride {stride} '
                        f'dilation {dil} {name}', stride=(stride, stride),
                        padding=(pad, pad), dilation=(dil, dil))

        if dtype == torch.bfloat16:
            _b3_wide_probe(check, gen, dev, dtype)

        # large offsets: the whole tap is out of the image -> exact zeros
        layer, h, w, c = DCN_SHAPES[0]
        x, offset, mask = _dcn_inputs(gen, dev, h, w, c, dtype)
        big = torch.tensor([1e4, -1e4, 1e6, -3e7], device=dev)
        offset = big[torch.randint(0, 4, offset.shape, generator=gen,
                                   device=dev)]
        cols = deform_im2col(x, offset, mask)
        check(bool((cols == 0).all()),
              f'b3 large-offset probe {name}: columns exactly zero')
        weight = torch.randn(9, c, c, generator=gen, device=dev)
        bias = torch.randn(c, generator=gen, device=dev)
        out = modulated_deform_conv(x[None], offset[None], mask[None],
                                    weight, bias)
        check(torch.equal(out, bias.expand_as(out)),
              f'b3 large-offset probe {name}: output equals the bias')


# ----------------------------------------------------------------- B2
def _b2_window(x, offset, mask, blk, win):
    """The windowed op's own prep for one image: the image-mode arguments
    of B2 (x, origins, ry, rx, mm), whether every tap lies in its window,
    and the block counts."""
    dw = importlib.import_module('c2matching_tpu_torch.ops.dcn_window')
    origins, ry, rx, mm, ok = dw._window_prep(x, offset, mask, blk, win)
    h, w, _ = x.shape
    return (x, origins, ry, rx, mm), bool(ok), h // blk, w // blk


def _b2_tol(dtype):
    return B2_F32_TOL if dtype == torch.float32 else B2_BF16_TOL


def _b2_compare(check, args, label):
    """B2 in image mode (``window_conv``, args = x, origins, ry, rx, mm,
    weight, blk, win, nby, nbx) against its plain version, and against
    rows mode on the gathered windows, which must give the same bits.
    Returns the max |difference| from the plain version."""
    from c2matching_tpu_torch.ops import (window_contract, window_conv,
                                          window_conv_plain)
    dk = importlib.import_module('c2matching_tpu_torch.ops.'
                                 'dcn_window_kernel')
    x, origins = args[:2]
    out_k = window_conv(*args)
    err = (out_k - window_conv_plain(*args)).abs().max().item()
    tol = _b2_tol(x.dtype)
    check(err <= tol, f'b2 {label}: max |out diff| {err:.3g} <= {tol:g}')
    rows = dk._window_gather(x, origins, args[7])
    check(torch.equal(out_k, window_contract(rows, *args[2:])),
          f'b2 {label}: image mode and rows mode equal bit for bit')
    del out_k, rows
    torch.cuda.empty_cache()
    return err


def _b2_time(args, label):
    """Times of B2 in image mode, of its plain version (the gather and the
    dense contraction) and of rows mode on the gathered windows."""
    from c2matching_tpu_torch.ops import (window_contract, window_conv,
                                          window_conv_plain)
    dk = importlib.import_module('c2matching_tpu_torch.ops.'
                                 'dcn_window_kernel')
    ms = cuda_ms(lambda: window_conv(*args))
    plain_ms = cuda_ms(lambda: window_conv_plain(*args))
    rows = dk._window_gather(args[0], args[1], args[7])
    rows_ms = cuda_ms(lambda: window_contract(rows, *args[2:]))
    print(f'b2 {label}: image mode {ms:.3f} ms, plain {plain_ms:.3f} ms, '
          f'rows mode {rows_ms:.3f} ms (on {nbytes(rows) / 1e9:.2f} GB of '
          'gathered windows)', flush=True)
    del rows
    torch.cuda.empty_cache()
    return ms, plain_ms, rows_ms


def _b2_needed_cells(ry, rx, mm, blk, win, nbx):
    """Per (block, tap, group, window cell), whether a non-zero tent weight
    needs it (a tent is non-zero on at most 2 x 2 cells of a window; a
    cell is needed once however many pixels use it), and the number of
    (pixel, tap, group, cell) samples with a non-zero weight."""
    g, k, p = ry.shape
    dev = ry.device
    pix = torch.arange(p, device=dev)
    wo = nbx * blk
    block = (pix // wo // blk) * nbx + (pix % wo) // blk
    base = ((block[None, None] * k + torch.arange(k, device=dev)[:, None])
            * g + torch.arange(g, device=dev)[:, None, None]) * win * win
    need = torch.zeros(p // (blk * blk) * k * g * win * win,
                       dtype=torch.bool, device=dev)
    y0 = ry.floor().clamp(-2, win)
    x0 = rx.floor().clamp(-2, win)
    n_samples = 0
    for dy in (0, 1):
        cy = y0 + dy
        ty = (1 - (ry - cy).abs()).clamp_min(0) * ((cy >= 0) & (cy < win))
        for dx in (0, 1):
            cx = x0 + dx
            txm = ((1 - (rx - cx).abs()).clamp_min(0) * mm
                   * ((cx >= 0) & (cx < win)))
            used = (ty != 0) & (txm != 0)
            n_samples += int(used.sum())
            cell = (base + cy.clamp(0, win - 1).long() * win
                    + cx.clamp(0, win - 1).long())
            need[cell[used]] = True
    return need, n_samples


def _b2_work(x, origins, ry, rx, mm, weight, blk, win, nby, nbx):
    """(bytes, operations) of B2 in image mode: read x, the origins, the
    three (G, K, P) fields and the weight once, write the f32 output once;
    the contraction with the weight is dense (2 P K C Co), the tent
    sampling one multiply-add per (pixel, tap, group, cell) with a
    non-zero weight and channel of the group."""
    g, k, p = ry.shape
    c = x.shape[-1]
    co = weight.shape[-1]
    _, n_samples = _b2_needed_cells(ry, rx, mm, blk, win, nbx)
    moved = (nbytes(x, origins, ry, rx, mm) + 4 * weight.numel()
             + 4 * p * co)
    return moved, 2 * p * k * c * co + 2 * n_samples * (c // g)


def _b2_rows_work(x, ry, rx, mm, weight, blk, win, nby, nbx):
    """(bytes, operations) of B2 in rows mode: the gathered window cells
    that a non-zero tent needs, the fields, the weight and the output; the
    same operations as image mode."""
    g, k, p = ry.shape
    c = x.shape[-1]
    co = weight.shape[-1]
    need, n_samples = _b2_needed_cells(ry, rx, mm, blk, win, nbx)
    moved = (int(need.sum()) * (c // g) * x.element_size()
             + nbytes(ry, rx, mm) + 4 * weight.numel() + 4 * p * co)
    return moved, 2 * p * k * c * co + 2 * n_samples * (c // g)


def _b2_inputs(gen, dev, h, w, c, blk, g=8, k=9):
    """Random DynAgg-structured inputs of one image: x, the block-constant
    integer flow in +-16, a residual in +-0.4, the mask, a weight at the
    DCN's init scale and a bias."""
    x = torch.randn(1, h, w, c, generator=gen, device=dev)
    flow = torch.randint(-16, 17, (1, h // blk, w // blk, 1, k, 2),
                         generator=gen, device=dev).float()
    flow = flow.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
    resid = 0.4 * (2 * torch.rand(1, h, w, g, k, 2, generator=gen,
                                  device=dev) - 1)
    mask = torch.rand(1, h, w, g, k, generator=gen, device=dev)
    weight = torch.randn(k, c, c, generator=gen, device=dev) / math.sqrt(k * c)
    bias = torch.randn(c, generator=gen, device=dev)
    return x, flow, resid, mask, weight, bias


def _windowed_vs_exact(check, x, offset, mask, weight, bias, blk, win,
                       label, chunks=None):
    """The windowed op (or its row-chunked form) against the exact op:
    returns (launches of B2, windowed ms, exact ms)."""
    from c2matching_tpu_torch.ops import (
        modulated_deform_conv, modulated_deform_conv_windowed,
        modulated_deform_conv_windowed_chunked, window_contract)
    if chunks is None:
        def windowed():
            return modulated_deform_conv_windowed(x, offset, mask, weight,
                                                  bias, blk=blk, win=win)
    else:
        def windowed():
            return modulated_deform_conv_windowed_chunked(
                x, offset, mask, weight, bias, blk=blk, win=win,
                row_chunks=chunks)

    def exact():
        return modulated_deform_conv(x, offset, mask, weight, bias)

    window_contract.launches = 0
    out_w = windowed()
    torch.cuda.synchronize()
    launches = window_contract.launches
    out_e = exact()
    scale = out_e.abs().max().item()
    err = (out_w - out_e).abs().max().item()
    rel = WIN_F32_REL if x.dtype == torch.float32 else WIN_BF16_REL
    check(out_w.shape == out_e.shape and err <= rel * scale,
          f'{label}: max |windowed - exact| {err:.3g} <= {rel:g} x max|out| '
          f'{scale:.3g}')
    del out_w, out_e
    ms = cuda_ms(windowed)
    exact_ms = cuda_ms(exact)
    torch.cuda.empty_cache()
    return launches, ms, exact_ms


def _b2_coords(gen, dev, shape, win):
    """Window coordinates reaching 3 cells past the window on both sides,
    5% of them far outside it (huge ones too)."""
    r = (win + 5) * torch.rand(shape, generator=gen, device=dev) - 3
    far = torch.rand(shape, generator=gen, device=dev) < 0.05
    huge = torch.tensor([1e6, -1e6, 3e30, -3e30], device=dev)[
        torch.randint(0, 4, shape, generator=gen, device=dev)]
    return torch.where(far, huge, r)


def _b2_image_probe(check, gen, dev, h, w, c, g, co, blk, win, nby, nbx):
    """Image mode on random windows: origins drawn from the two clamps
    (-2 and H + 2 - win, and the same for x), so whole window rows and
    columns lie in the zero ring, and from in between; coordinates past
    the window, huge ones, and zero modulation; in f32 and bf16, against
    the plain version and rows mode."""
    nb, p = nby * nbx, nby * nbx * blk * blk

    def origin(n, top):
        pick = torch.randint(0, 3, (nb, 9), generator=gen, device=dev)
        mid = torch.randint(-2, top + 1, (nb, 9), generator=gen, device=dev)
        return torch.where(pick == 0, -2, torch.where(pick == 1, top, mid))

    origins = torch.stack([origin(nb, h + 2 - win), origin(nb, w + 2 - win)],
                          dim=-1).to(torch.int32)
    ry = _b2_coords(gen, dev, (g, 9, p), win)
    rx = _b2_coords(gen, dev, (g, 9, p), win)
    mm = torch.rand(g, 9, p, generator=gen, device=dev)
    mm = mm * (torch.rand(g, 9, p, generator=gen, device=dev) > 0.2)
    weight = torch.randn(9, c, co, generator=gen, device=dev) / 12
    x = torch.randn(h, w, c, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        _b2_compare(check, (x.to(dtype), origins, ry, rx, mm, weight, blk,
                            win, nby, nbx),
                    f'image probe {h}x{w}x{c} G {g} Co {co} blk {blk} '
                    f'win {win} {nby}x{nbx} blocks, origins at both clamps '
                    f'{name}')


def phase_b2(check, dev, card):
    from c2matching_tpu_torch.ops import (modulated_deform_conv,
                                          modulated_deform_conv_windowed,
                                          window_contract,
                                          window_contract_plain)
    gen = torch.Generator(device=dev).manual_seed(4)
    for (h, w, c), (layer, blk, win) in WINDOWED.items():
        x32, flow, resid, mask, weight, bias = _b2_inputs(gen, dev, h, w, c,
                                                          blk)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace('torch.', '')
            label = f'{layer} {h}x{w}x{c} blk {blk} win {win} {name}'
            x = x32.to(dtype)
            offset = flow + resid
            args, ok, nby, nbx = _b2_window(x[0], offset[0], mask[0], blk,
                                            win)
            check(ok, f'b2 {label}: every tap inside its window')
            args = (*args, weight, blk, win, nby, nbx)
            _b2_compare(check, args, label)
            _b2_time(args, label)
            del args
            launches, ms, exact_ms = _windowed_vs_exact(
                check, x, offset, mask, weight, bias, blk, win,
                f'b2 windowed op {label}')
            check(launches == 1, f'b2 windowed op {label}: window_contract '
                  f'launched {launches} time(s)')
            print(f'b2 windowed op {label}: {ms:.3f} ms, exact op '
                  f'{exact_ms:.3f} ms ({card})', flush=True)
            # row chunks: 8 sequential kernel launches, no fallback
            launches, ms, exact_ms = _windowed_vs_exact(
                check, x, offset, mask, weight, bias, blk, win,
                f'b2 chunked op {label}', chunks=8)
            check(launches == 8, f'b2 chunked op {label}: window_contract '
                  f'launched {launches} times')
            print(f'b2 chunked op (8 chunks) {label}: {ms:.3f} ms, exact op '
                  f'{exact_ms:.3f} ms ({card})', flush=True)
            # fallback: residuals past the window take the exact op
            offset = flow + 5 * resid
            window_contract.launches = 0
            out = modulated_deform_conv_windowed(x, offset, mask, weight,
                                                 bias, blk=blk, win=win)
            check(window_contract.launches == 0
                  and torch.equal(out, modulated_deform_conv(
                      x, offset, mask, weight, bias)),
                  f'b2 fallback probe {label}: no launch, output equals the '
                  'exact op bit for bit')
            del out, offset
            torch.cuda.empty_cache()

    # rows mode on odd shapes against the plain version: tiles that
    # straddle blocks and end ragged, C and Co off the kernel's tiles (a
    # group of 6 channels takes the scalar path; Co 200 two column tiles),
    # coordinates far outside the window (huge ones too), zero modulation
    for blk, win, nby, nbx, c, g, co in ((3, 7, 5, 7, 24, 4, 40),
                                         (1, 5, 9, 11, 16, 2, 200)):
        nb, p = nby * nbx, nby * nbx * blk * blk
        rows = torch.randn(nb, 9, win, win * c, generator=gen, device=dev)
        ry = _b2_coords(gen, dev, (g, 9, p), win)
        rx = _b2_coords(gen, dev, (g, 9, p), win)
        mm = torch.rand(g, 9, p, generator=gen, device=dev)
        mm = mm * (torch.rand(g, 9, p, generator=gen, device=dev) > 0.2)
        weight = torch.randn(9, c, co, generator=gen, device=dev) / 12
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace('torch.', '')
            args = (rows.to(dtype), ry, rx, mm, weight, blk, win, nby, nbx)
            err = (window_contract(*args)
                   - window_contract_plain(*args)).abs().max().item()
            tol = _b2_tol(dtype)
            check(err <= tol, f'b2 rows probe blk {blk} win {win} {nby}x{nbx}'
                  f' blocks C {c} G {g} Co {co} {name}: max |out diff| '
                  f'{err:.3g} <= {tol:g}')

    # image mode on odd shapes: the output grid smaller than the image (as
    # a row chunk's), C off the 16-channel ring slots with a group of 6
    # (scalar path) or of 4, Co off the 64-channel tiles, a 2-tile Co
    for h, w, c, g, co, blk, win, nby, nbx in (
            (37, 29, 24, 4, 40, 3, 7, 5, 7),
            (40, 44, 20, 5, 72, 2, 6, 20, 22),
            (16, 20, 48, 8, 200, 4, 8, 4, 5),
            (12, 9, 16, 2, 3, 1, 5, 12, 9)):
        _b2_image_probe(check, gen, dev, h, w, c, g, co, blk, win, nby, nbx)

    # a CUDA tensor the kernel cannot take raises: no fallback hides it
    from c2matching_tpu_torch.ops import window_conv
    x = torch.randn(16, 16, 8, device=dev)
    origins = torch.zeros(16, 9, 2, dtype=torch.int32, device=dev)
    fields = torch.zeros(2, 9, 256, device=dev)
    wide = torch.zeros(16, 16, 1024, device=dev)
    out = window_conv(x, origins, fields, fields, fields,
                      torch.zeros(9, 8, 8, device=dev), 4, 6, 4, 4)
    check(tuple(out.shape) == (16, 16, 8), 'b2 image mode takes the valid '
          'counterpart of the refused calls')
    for what, bad in (
            ('a float64 image', (x.double(), origins,
                                 torch.zeros(9, 8, 8, device=dev))),
            ('int64 origins', (x, origins.long(),
                               torch.zeros(9, 8, 8, device=dev))),
            ('C = 1024, past its shared memory',
             (wide, origins, torch.zeros(9, 1024, 8, device=dev)))):
        try:
            window_conv(*bad[:2], fields, fields, fields, bad[2], 4, 6, 4, 4)
            raised = False
        except (TypeError, ValueError, RuntimeError):
            raised = True
        check(raised, f'b2 image mode refuses {what} on the card')


# --------------------------------------------------------------- main path
def _request(gen, dev, hr_h, hr_w):
    """A smooth random HR image, its x4 LR, the LR upsampled back, and a
    shifted copy as the reference (NHWC, [0, 1])."""
    coarse = torch.rand(1, 3, hr_h // 8 + 1, hr_w // 8 + 1, generator=gen,
                        device=dev)
    gt = F.interpolate(coarse, size=(hr_h, hr_w), mode='bilinear',
                       align_corners=False)
    gt = (gt + 0.05 * torch.rand(gt.shape, generator=gen, device=dev))
    gt = gt.clamp(0, 1)
    lq = F.avg_pool2d(gt, 4)
    up = F.interpolate(lq, scale_factor=4, mode='bicubic',
                       align_corners=False).clamp(0, 1)
    ref = torch.roll(gt, shifts=(24, 16), dims=(2, 3))

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    return {'img_in_lq': nhwc(lq), 'img_in_up': nhwc(up),
            'img_ref': nhwc(ref)}


def _serve(model, batch):
    model.feed_data(batch)
    model.test()
    out = model.cropped_output()
    torch.cuda.synchronize()
    return out


def _stage_ms(model, batch):
    """Device time of each net for one request, by CUDA events around the
    calls RefRestorationModel.test makes."""
    model.feed_data(batch)
    vs_lr = model._valid_lr
    vs_hr = None if vs_lr is None else (4 * vs_lr[0], 4 * vs_lr[1])
    b = model.batch
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        events[0].record()
        feats = model.net_extractor(b['img_in_up'], b['img_ref'], vs_hr)
        events[1].record()
        pre, ref_feat = model.net_map(feats, b['img_ref'], vs_hr)
        events[2].record()
        model.net_g(b['img_in_lq'], pre, ref_feat, vs_lr)
        events[3].record()
    torch.cuda.synchronize()
    names = ('extractor', 'match+vgg19', 'restoration')
    return {n: events[i].elapsed_time(events[i + 1])
            for i, n in enumerate(names)}


@contextlib.contextmanager
def _record_kernel_inputs():
    """Record what the main path hands each kernel: (q, r, ref_bias) of
    every match and (x, offset, mask, weight, bias) of every DynAgg's DCN,
    image 0. Wraps the names the callers look up; the kernels and their
    launch counters stay as they are."""
    pm = importlib.import_module('c2matching_tpu_torch.ops.patch_match')
    ra = importlib.import_module(
        'c2matching_tpu_torch.models.archs.ref_restoration_arch')
    seen = {'b1': [], 'b3': []}
    match, mdc = pm.match_argmax, ra.modulated_deform_conv

    def match_rec(q, r, ref_bias=None):
        seen['b1'].append((q, r, ref_bias))
        return match(q, r, ref_bias)

    def mdc_rec(x, offset, mask, weight, bias=None):
        seen['b3'].append((x[0], offset[0], mask[0], weight, bias))
        return mdc(x, offset, mask, weight, bias)

    pm.match_argmax, ra.modulated_deform_conv = match_rec, mdc_rec
    try:
        yield seen
    finally:
        pm.match_argmax, ra.modulated_deform_conv = match, mdc


def phase_main(check, dev, report, card, recorded):
    from c2matching_tpu_torch.models import RefRestorationModel
    from c2matching_tpu_torch.ops import deform_im2col, match_argmax
    gen = torch.Generator(device=dev).manual_seed(3)
    requests = [_request(gen, dev, *hw) for hw in REQUESTS]
    for cfg, blocks in (('f32', F32_BLOCKS), ('serving', SERVING_BLOCKS)):
        model = RefRestorationModel(blocks, dev,
                                    torch.Generator().manual_seed(0))
        _serve(model, requests[0])   # warm-up: cuDNN plans, allocator
        match_argmax.launches = 0
        deform_im2col.launches = 0
        times = []
        outs = []
        for batch in requests:
            t0 = time.perf_counter()
            outs.append(_serve(model, batch))
            times.append(time.perf_counter() - t0)
        launches = {'match_argmax': match_argmax.launches,
                    'deform_im2col': deform_im2col.launches}
        for (hr_h, hr_w), out, dt in zip(REQUESTS, outs, times):
            check(tuple(out.shape) == (1, hr_h, hr_w, 3)
                  and bool(torch.isfinite(out).all()),
                  f'main {cfg} HR {hr_h}x{hr_w}: output {tuple(out.shape)} '
                  'finite')
            print(f'main {cfg} HR {hr_h}x{hr_w}: latency {1e3 * dt:.1f} ms '
                  f'({card})', flush=True)
        print(f'main {cfg}: {len(times) / sum(times):.3f} images/s over '
              f'{len(times)} requests at batch 1 ({card})', flush=True)
        for name, n in launches.items():
            check(n > 0, f'main {cfg}: {name} launched {n} times')
        stages = _stage_ms(model, requests[0])
        print(f'main {cfg} HR {REQUESTS[0][0]}x{REQUESTS[0][1]} device ms by '
              'net: ' + ', '.join(f'{k} {v:.2f}' for k, v in stages.items())
              + f' ({card})', flush=True)
        report[f'main_{cfg}_launches'] = launches
        if cfg == 'f32':
            # the same nets on the CPU, where the plain versions run
            small = _request(gen, dev, 96, 80)
            out = _serve(model, small).cpu()
            cpu = RefRestorationModel(blocks, 'cpu',
                                      torch.Generator().manual_seed(0))
            cpu.feed_data({k: v.cpu() for k, v in small.items()})
            cpu.test()
            err = (out - cpu.cropped_output()).abs().max().item()
            check(err <= MAIN_CPU_TOL, f'main f32: card vs CPU on HR 96x80, '
                  f'max |diff| {err:.3g} <= {MAIN_CPU_TOL:g}')
        # one more request, outside the counted run, for phase path
        with _record_kernel_inputs() as seen:
            _serve(model, requests[0])
        recorded[cfg] = seen
        del model
        torch.cuda.empty_cache()


def phase_path(check, report, recorded, card):
    """Each kernel against its plain version on the tensors the main path
    gave it for the HR 512x336 request, in both configs; then the windowed
    op on the relu1 and relu2 DynAggs' tensors."""
    for cfg, dtype in (('f32', torch.float32), ('serving', torch.bfloat16)):
        name = str(dtype).replace('torch.', '')
        seen = recorded.pop(cfg)
        check(len(seen['b1']) == 1, f'path {cfg}: one match call '
              f'({len(seen["b1"])})')
        q, r, bias = seen['b1'][0]
        excluded = -1 if bias is None else int((bias < 0).sum())
        check(tuple(q.shape) == PATH_B1 and tuple(r.shape) == PATH_B1
              and q.dtype == dtype and excluded == PATH_B1_EXCLUDED,
              f'path {cfg}: B1 gets q {tuple(q.shape)}, r {tuple(r.shape)} '
              f'{q.dtype}, ref_bias excluding {excluded} rows')
        label = f'main path {q.shape[1]}x{r.shape[1]}x{q.shape[2]} {name}'
        idx, err = _b1_compare(check, q, r, bias, label)
        check(bool((bias[idx.long()] == 0).all()),
              f'b1 {label}: no excluded row wins')
        ms, plain_ms = _b1_time(q, r, bias, label)
        moved, ops = _b1_work(q, r, bias)
        if dtype == torch.float32:
            # the kernel's pipe: three TF32 products per f32 product
            simt_ms, _ = bound(moved, ops, torch.float32)
            bound_ms, bound_by = bound(moved, B1_TF32_PRODUCTS * ops, 'tf32')
            pipe = (f'3xTF32 at {PEAK_FLOPS["tf32"] / 1e12:g} TFLOP/s; '
                    f'SIMT f32 at {PEAK_FLOPS[torch.float32] / 1e12:g} '
                    f'TFLOP/s: {simt_ms:.3f} ms')
        else:
            bound_ms, bound_by = bound(moved, ops, dtype)
            pipe = f'bf16 at {PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s'
        library_ms = _b1_library_ms(q, r, bias)
        print(f'b1 {label}: bound {bound_ms:.3f} ms by {bound_by} ({pipe}), '
              f'torch.matmul + max {library_ms:.3f} ms ({card})', flush=True)
        report[f'b1_{name}'] = {'ms': ms, 'plain_ms': plain_ms,
                                'max_abs_err': err, 'bound_ms': bound_ms,
                                'bound_by': bound_by,
                                'library_ms': library_ms}
        del q, r, bias, idx
        seen['b1'].clear()
        torch.cuda.empty_cache()

        shapes = sorted(tuple(d[0].shape) for d in seen['b3'])
        check(shapes == sorted(PATH_B3)
              and all(d[0].dtype == dtype for d in seen['b3']),
              f'path {cfg}: B3 gets x {shapes} {dtype}')
        total_ms = total_plain = worst = 0.0
        total_lib = 0.0 if dtype == torch.float32 else None
        moved = ops = 0
        for x, offset, mask, _, _ in seen['b3']:
            label = 'main path {}x{}x{} {}'.format(*x.shape, name)
            worst = max(worst, _b3_compare(check, x, offset, mask, label))
            ms, plain_ms = _b3_time(x, offset, mask, label)
            total_ms += ms
            total_plain += plain_ms
            work = _b3_work(x, offset, mask)
            moved, ops = moved + work[0], ops + work[1]
            if total_lib is not None:
                lib_ms = _b3_library(check, x, offset, mask, label)
                print(f'b3 {label}: grid_sample {lib_ms:.3f} ms ({card})',
                      flush=True)
                total_lib += lib_ms
        bound_ms, bound_by = bound(moved, ops, torch.float32)
        print(f'b3 main path {name}: kernel {total_ms:.3f} ms over the three '
              f'DynAggs, bound {bound_ms:.3f} ms by {bound_by} ({card})',
              flush=True)
        report[f'b3_{name}'] = {'ms': total_ms, 'plain_ms': total_plain,
                                'max_abs_err': worst, 'bound_ms': bound_ms,
                                'bound_by': bound_by,
                                'library_ms': total_lib}
        report[f'b2_{name}'] = _path_windowed(check, seen['b3'], cfg, name,
                                              card)
        del seen
        torch.cuda.empty_cache()


def _path_windowed(check, dcns, cfg, name, card):
    """The windowed op on the DynAggs it serves (relu1 blk 4, relu2 blk
    2), with B2 in image mode against its plain version and rows mode on
    the same inputs whichever branch the op takes. Returns the kernels-line
    entry of this config: B2's launches in the windowed op's run, counted
    from 0 before each call, and the sums over the two DynAggs."""
    dw = importlib.import_module('c2matching_tpu_torch.ops.dcn_window')
    total = {'launches': 0, 'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}
    moved = ops = rows_moved = 0
    rows_ms = 0.0
    served = 0
    for x, offset, mask, weight, bias in dcns:
        if tuple(x.shape) not in WINDOWED:
            continue
        served += 1
        layer, blk, win = WINDOWED[tuple(x.shape)]
        label = 'main path {} {}x{}x{} blk {} win {} {}'.format(
            layer, *x.shape, blk, win, name)
        args, ok, nby, nbx = _b2_window(x, offset, mask, blk, win)
        args = (*args, weight, blk, win, nby, nbx)
        total['max_abs_err'] = max(total['max_abs_err'],
                                   _b2_compare(check, args, label))
        ms, plain_ms, r_ms = _b2_time(args, label)
        prep_ms = cuda_ms(lambda: dw._window_prep(x, offset, mask, blk, win))
        print(f'path windowed op {label}: prep {prep_ms:.3f} ms, B2 '
              f'{ms:.3f} ms ({card})', flush=True)
        work = _b2_work(*args)
        moved, ops = moved + work[0], ops + work[1]
        rows_moved += _b2_rows_work(x, *args[2:])[0]
        total['ms'] += ms
        total['plain_ms'] += plain_ms
        rows_ms += r_ms
        del args
        launches, ms, exact_ms = _windowed_vs_exact(
            check, x[None], offset[None], mask[None], weight, bias, blk, win,
            f'path windowed op {label}')
        check(launches == int(ok), f'path windowed op {label}: branch '
              f'{"windowed" if ok else "exact"}, window_contract launched '
              f'{launches} time(s)')
        print(f'path windowed op {label}: branch '
              f'{"windowed" if ok else "exact (fallback)"}, {ms:.3f} ms, '
              f'exact op {exact_ms:.3f} ms ({card})', flush=True)
        total['launches'] += launches
    check(served == len(WINDOWED), f'path {cfg}: {served} DynAggs of the '
          f'windowed op\'s shapes')
    check(total['launches'] > 0, f'path {cfg}: window_contract launched '
          f'{total["launches"]} times by the windowed op')
    # the kernel's pipe: three TF32 products per f32 product
    total['bound_ms'], total['bound_by'] = bound(
        moved, B1_TF32_PRODUCTS * ops, 'tf32')
    simt_ms, _ = bound(moved, ops, torch.float32)
    rows_bound, rows_by = bound(rows_moved, B1_TF32_PRODUCTS * ops, 'tf32')
    total['library_ms'] = None
    print(f'b2 main path {name}: image mode {total["ms"]:.3f} ms over the two '
          f'DynAggs, bound {total["bound_ms"]:.3f} ms by {total["bound_by"]} '
          f'({moved / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP; 3xTF32 at '
          f'{PEAK_FLOPS["tf32"] / 1e12:g} TFLOP/s; SIMT f32 at '
          f'{PEAK_FLOPS[torch.float32] / 1e12:g} TFLOP/s: {simt_ms:.3f} ms); '
          f'rows mode {rows_ms:.3f} ms, bound {rows_bound:.3f} ms by '
          f'{rows_by} ({rows_moved / 1e9:.3f} GB) ({card})', flush=True)
    return total


def main():
    if len(sys.argv) > 1:
        sys.exit(f'chip_smoke.py takes no arguments, got {sys.argv[1:]}')
    if not torch.cuda.is_available():
        sys.exit('chip_smoke.py: torch.cuda.is_available() is False; this '
                 'script needs a CUDA card')
    from c2matching_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('TF32 off: torch.backends.cudnn.allow_tf32 = False, '
          'torch.backends.cuda.matmul.allow_tf32 = False')
    dev = torch.device('cuda', 0)
    card = card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}', flush=True)

    check = Checks()
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f'kernels built in {time.perf_counter() - t0:.1f} s '
          f'({", ".join(logs) or "cached"})', flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')

    report = {}
    recorded = {}
    for name, fn in (
            ('b1', lambda: phase_b1(check, dev)),
            ('b3', lambda: phase_b3(check, dev)),
            ('b2', lambda: phase_b2(check, dev, card)),
            ('main', lambda: phase_main(check, dev, report, card, recorded)),
            ('path', lambda: phase_path(check, report, recorded, card))):
        try:
            fn()
        except Exception as exc:  # a phase fails; the others still run
            check(False, f'{name} raised {type(exc).__name__}: {exc}')

    if check.failed:
        print(f'{len(check.failed)} check(s) failed:', *check.failed,
              sep='\n  ')
        sys.exit(1)

    # f32 numbers; B1 and B3 launch on the main path, B2 in the windowed
    # op's run on the main path's DynAgg tensors (phase path)
    launches = dict(report['main_f32_launches'],
                    window_contract=report['b2_float32'].pop('launches'))
    kernels = []
    for name, key, source, replaces in (
            ('match_argmax', 'b1', 'c2matching_tpu_torch/csrc/patch_match.cu',
             'c2matching_tpu/ops/pallas/patch_match_kernel.py:81'),
            ('deform_im2col', 'b3', 'c2matching_tpu_torch/csrc/deform_conv.cu',
             'c2matching_tpu/ops/deform_conv.py:214'),
            ('window_contract', 'b2', 'c2matching_tpu_torch/csrc/dcn_window.cu',
             'c2matching_tpu/ops/pallas/dcn_window_kernel.py:125')):
        kernels.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': launches[name],
                        **report[f'{key}_float32']})
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
