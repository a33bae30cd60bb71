#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. card: name and power limit; build the kernels from csrc/ (nvcc).
  2. b1: the patch-match argmax kernel against its plain version on
     random descriptors at the unpadded CUFED5 shape (10332 x 10332,
     D = 2304) in f32 and bf16, plus ragged shapes, exact ties across tile
     boundaries and the ref_bias exclusion.
  3. b3: the deformable im2col kernel against its plain version on random
     inputs at the three unpadded DynAgg shapes of CUFED5 in f32 and bf16,
     plus the large-offset probe, which must give exact zeros.
  4. main: RefRestorationModel.feed_data / test at full width (ngf 64,
     16 blocks, 8 groups; random weights from a seeded generator) in the
     f32 config and the serving config (bf16 gathers and match operands),
     over requests of CUFED5 size, one of them off the bucket; the launch
     counters must rise on this path; a small request must agree with the
     same nets run on the CPU, where the plain versions run. One more
     HR 512x336 request per config records every kernel's inputs.
  5. path: each kernel against its plain version on exactly the tensors
     the main path gave it (B1 at 11844 x 11844 x 2304 with the valid-shape
     ref_bias; B3 at the padded 128x96, 256x192 and 512x384 DynAggs), in
     both configs; these are the times of the kernels line.
  6. one JSON line of kernels, the card's line, and last the JSON result.

Exits non-zero, printing no result, when a phase fails or no CUDA card
is present. TF32 is off for convolutions and matmuls throughout.
"""
import contextlib
import importlib
import json
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


def cuda_ms(fn, reps=3):
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ----------------------------------------------------------------- B1
def _b1_compare(check, q, r, bias, label):
    from c2matching_tpu_torch.ops import match_argmax, match_argmax_plain
    idx_k, val_k = match_argmax(q, r, bias)
    idx_p, val_p = match_argmax_plain(q, r, bias)
    scores = torch.matmul(q.float(), r.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    top2 = scores.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > B1_GAP_TOL
    same = (idx_k == idx_p) | ~clear
    picked = scores.gather(-1, idx_k.long()[..., None])[..., 0]
    err = (val_k - val_p).abs().max().item()
    check(bool(same.all()), f'b1 {label}: indices equal on the '
          f'{int(clear.sum())} of {clear.numel()} rows with top-2 gap > '
          f'{B1_GAP_TOL:g}')
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
        # ragged shapes, batched
        _b1_compare(check, randn(2, 300, 72).to(dtype),
                    randn(2, 470, 72).to(dtype), None,
                    f'ragged 2x300x470x72 {name}')
        try:
            match_argmax(randn(300, 27).to(dtype), randn(470, 27).to(dtype))
            raised = False
        except ValueError:
            raised = True
        check(raised, f'b1 D = 27 {name}: the wrapper refuses D % 4 != 0')
        # exact ties: duplicated ref rows far apart (across 64-row tiles)
        # and adjacent (inside one thread's 4 columns); the lowest wins
        base = randn(50, 64)
        for r_tie, want in ((torch.cat([base] * 3), torch.arange(50)),
                            (base.repeat_interleave(3, dim=0),
                             3 * torch.arange(50))):
            idx, _ = match_argmax((2 * base).to(dtype), r_tie.to(dtype))
            check(torch.equal(idx.long().cpu(), want),
                  f'b1 ties {name}: the lowest duplicate index wins')
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


def _b3_compare(check, x, offset, mask, label):
    """Kernel columns against the plain version's on the same inputs;
    returns the max |difference|."""
    from c2matching_tpu_torch.ops import deform_im2col, deform_im2col_plain
    cols_k = deform_im2col(x, offset, mask).float()
    err = (cols_k - deform_im2col_plain(x, offset, mask).float()).abs()
    err = err.max().item()
    if x.dtype == torch.float32:
        ok = err <= B3_F32_TOL
        bound = f'{B3_F32_TOL:g}'
    else:
        # against the unrounded f32 columns of the same bf16 input: one
        # rounding to bf16 plus f32 arithmetic error
        exact = deform_im2col_plain(x.float(), offset, mask)
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
    every match and (x, offset, mask) of every DynAgg's DCN, image 0.
    Wraps the names the callers look up; the kernels and their launch
    counters stay as they are."""
    pm = importlib.import_module('c2matching_tpu_torch.ops.patch_match')
    ra = importlib.import_module(
        'c2matching_tpu_torch.models.archs.ref_restoration_arch')
    seen = {'b1': [], 'b3': []}
    match, mdc = pm.match_argmax, ra.modulated_deform_conv

    def match_rec(q, r, ref_bias=None):
        seen['b1'].append((q, r, ref_bias))
        return match(q, r, ref_bias)

    def mdc_rec(x, offset, mask, *args, **kwargs):
        seen['b3'].append((x[0], offset[0], mask[0]))
        return mdc(x, offset, mask, *args, **kwargs)

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


def phase_path(check, report, recorded):
    """Each kernel against its plain version on the tensors the main path
    gave it for the HR 512x336 request, in both configs."""
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
        report[f'b1_{name}'] = {'ms': ms, 'plain_ms': plain_ms,
                                'max_abs_err': err}
        del q, r, bias, idx
        seen['b1'].clear()
        torch.cuda.empty_cache()

        shapes = sorted(tuple(x.shape) for x, _, _ in seen['b3'])
        check(shapes == sorted(PATH_B3)
              and all(x.dtype == dtype for x, _, _ in seen['b3']),
              f'path {cfg}: B3 gets x {shapes} {dtype}')
        total_ms = total_plain = worst = 0.0
        for x, offset, mask in seen['b3']:
            label = 'main path {}x{}x{} {}'.format(*x.shape, name)
            worst = max(worst, _b3_compare(check, x, offset, mask, label))
            ms, plain_ms = _b3_time(x, offset, mask, label)
            total_ms += ms
            total_plain += plain_ms
        report[f'b3_{name}'] = {'ms': total_ms, 'plain_ms': total_plain,
                                'max_abs_err': worst}
        del seen
        torch.cuda.empty_cache()


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
            ('main', lambda: phase_main(check, dev, report, card, recorded)),
            ('path', lambda: phase_path(check, report, recorded))):
        try:
            fn()
        except Exception as exc:  # a phase fails; the others still run
            check(False, f'{name} raised {type(exc).__name__}: {exc}')

    if check.failed:
        print(f'{len(check.failed)} check(s) failed:', *check.failed,
              sep='\n  ')
        sys.exit(1)

    kernels = []
    for name, key, source, replaces in (
            ('match_argmax', 'b1', 'c2matching_tpu_torch/csrc/patch_match.cu',
             'c2matching_tpu/ops/pallas/patch_match_kernel.py:81'),
            ('deform_im2col', 'b3', 'c2matching_tpu_torch/csrc/deform_conv.cu',
             'c2matching_tpu/ops/deform_conv.py:214')):
        kernels.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces,
                        'launches': report['main_f32_launches'][name],
                        **report[f'{key}_float32']})
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
