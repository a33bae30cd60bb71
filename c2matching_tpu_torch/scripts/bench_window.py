"""Time kernel B2 (``csrc/dcn_window.cu``) in image mode at the main path's
two windowed DynAggs, against its variants and against an earlier tree's
kernel.

Builds, each timed on the same inputs (one image, f32 and bf16 x;
DynAgg-structured: a block-constant integer flow in +-16 and a residual in
+-0.4, so every tap lies in its window, prepared by the windowed op's own
``_window_prep``):

- this tree's source as it is;
- with ``--roles``, the source with ``C2M_B2_ROLE=1`` (without the
  columns: the products, and the tents their warps write) and ``=2``
  (without the products: the tents and the columns): a measurement's
  switch that the default build never sets, which says which role sets
  the pace (the output is then wrong);
- with ``--define A=1,B=2`` (repeatable), the source built with those
  macros, a variant to try;
- with ``--parent DIR``, the kernel of the checkout at DIR (an earlier
  tree, unpacked with ``git archive``), through the same C entry points.

The builds run in the order parent, this tree, its variants, then the same
in reverse (parent, change, change, parent), so that the two passes show
the run-to-run spread. Each time is a mean over ``--reps`` calls by CUDA
events, and by ``torch.profiler`` as the summed device time of every
kernel of a call (the weight's split pass included). Each build's output
is held against this tree's default build's (max |diff|).

``--device cpu`` runs the same plan on the CPU at a size cut by
``--shrink`` with the plain version (``window_conv_plain``) in place of
every build: a dry run of the arguments and the output, no kernel, no
device number (the profiler's is null).

Usage: python -m c2matching_tpu_torch.scripts.bench_window
       [--reps 40] [--roles] [--parent DIR] [--define A=1,B=2 ...]
       [--out FILE] [--device cuda|cpu] [--shrink N]
Needs a CUDA card of compute capability 9.0 and nvcc. Prints a line per
DynAgg and dtype, the sums over the two DynAggs beside the products'
bound, the card's name and power limit, and one JSON line of every number
(also written to --out).
"""
import argparse
import ctypes
import json
import math
import subprocess
import time
from pathlib import Path

import torch

from ..ops import _build
from ..ops.dcn_window import _window_prep
from ..ops.dcn_window_kernel import _ARGTYPES, _ENTRY, window_conv_plain

SOURCE = 'dcn_window'
ROLES = (('without columns', 'C2M_B2_ROLE=1'),
         ('without products', 'C2M_B2_ROLE=2'))
# the windowed op's DynAggs on the main path (the CUFED5 bucket, HR
# 512x384): (name, h, w, C = Co, blk, win), 8 groups
SHAPES = (('relu1_1', 512, 384, 64, 4, 8), ('relu2_1', 256, 192, 128, 2, 6))
TF32_FLOPS = 495e12   # H100 SXM, dense TF32 (at the 700 W limit)
TF32_PRODUCTS = 3     # 3xTF32: three TF32 products per f32 product


def builds(parent=None, roles=False, defines=()):
    """(label, defines, src) of every build, the parent's first."""
    plan = [('this tree', (), None)]
    if parent:
        src = Path(parent) / 'c2matching_tpu_torch' / 'csrc' / f'{SOURCE}.cu'
        if not src.exists():
            raise SystemExit(f'--parent {parent}: no {src}')
        plan.insert(0, ('parent', (), str(src.resolve())))
    if roles:
        plan += [(label, (define,), None) for label, define in ROLES]
    plan += [(d, tuple(d.split(',')), None) for d in defines]
    return plan


def inputs(gen, dev, h, w, c, blk, win, dtype, g=8, k=9):
    """One DynAgg's image-mode arguments of ``window_conv``: (x, origins,
    ry, rx, mm, weight, blk, win, nby, nbx), the weight at the DCN's init
    scale."""
    x = torch.randn(h, w, c, generator=gen, device=dev)
    flow = torch.randint(-16, 17, (h // blk, w // blk, 1, k, 2),
                         generator=gen, device=dev).float()
    flow = flow.repeat_interleave(blk, 0).repeat_interleave(blk, 1)
    resid = 0.4 * (2 * torch.rand(h, w, g, k, 2, generator=gen, device=dev)
                   - 1)
    mask = torch.rand(h, w, g, k, generator=gen, device=dev)
    weight = torch.randn(k, c, c, generator=gen, device=dev) / math.sqrt(k * c)
    x = x.to(dtype)
    origins, ry, rx, mm, ok = _window_prep(x, flow + resid, mask, blk, win)
    if not bool(ok):
        raise RuntimeError('bench_window: a tap left its window')
    return x, origins, ry, rx, mm, weight, blk, win, h // blk, w // blk


def entry(build, dtype):
    """The C entry of ``build`` (label, defines, src), its argument types
    set."""
    _, defines, src = build
    fn = getattr(_build.load(SOURCE, defines, src), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(fn, x, origins, ry, rx, mm, weight, blk, win, nby, nbx):
    """One image-mode call of a build's C entry, as ``window_conv`` makes
    it (the weight contiguous f32, its rows a multiple of 4 wide)."""
    h, w, c = x.shape
    g, k = ry.shape[:2]
    co = weight.shape[-1]
    out = torch.empty((nby * blk, nbx * blk, co), dtype=torch.float32,
                      device=x.device)
    err = fn(x.data_ptr(), origins.data_ptr(), ry.data_ptr(), rx.data_ptr(),
             mm.data_ptr(), weight.data_ptr(), out.data_ptr(), nby * nbx, k,
             blk, win, c, g, co, co, nbx, h, w,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'{SOURCE}: CUDA error {err}')
    return out


def time_ms(call, reps, cuda):
    """Mean time per call over ``reps`` calls in one queue, after one, by
    CUDA events (by the host clock on the CPU)."""
    call()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(call, reps):
    """Summed device time of every kernel of a call, by torch.profiler,
    mean over ``reps`` calls after one."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def card():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def products_bound_ms(h, w, c):
    """The dense contraction's least time: 2 P K C Co operations (Co = C)
    as 3xTF32 at the card's TF32 rate."""
    return TF32_PRODUCTS * 2 * h * w * 9 * c * c / TF32_FLOPS * 1e3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--reps', type=int, default=40)
    parser.add_argument('--roles', action='store_true',
                        help='also time the kernel without the columns '
                             'and without the products (C2M_B2_ROLE)')
    parser.add_argument('--parent', default=None,
                        help='a checkout of an earlier tree whose kernel '
                             'is timed beside this one')
    parser.add_argument('--define', action='append', default=[],
                        help='also time the source built with these '
                             'macros, comma-separated (repeatable)')
    parser.add_argument('--out', default=None, help='write the JSON here')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                        help='cpu: a dry run with the plain version')
    parser.add_argument('--shrink', type=int, default=1,
                        help='divide each DynAgg\'s height and width by this')
    args = parser.parse_args(argv)
    cuda = args.device == 'cuda'
    if cuda and not torch.cuda.is_available():
        raise SystemExit('bench_window needs a CUDA card')
    device = card() if cuda else 'cpu'
    plan = builds(args.parent, args.roles, args.define)
    if cuda:
        logs = _build.build([(SOURCE, d, s) for _, d, s in plan],
                            verbose=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if 'registers' in line or 'spill' in line:
                    print(f'  {name}: {line.strip()}')
    gen = torch.Generator(device=args.device).manual_seed(0)
    order = plan + plan[::-1]
    this = plan[1] if args.parent else plan[0]
    result = {'card': device, 'shrink': args.shrink, 'shapes': {}}
    sums = {}
    bound = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace('torch.', '')
        for name, h, w, c, blk, win in SHAPES:
            h, w = h // args.shrink, w // args.shrink
            if dtype == torch.float32:
                bound += products_bound_ms(h, w, c)
            data = inputs(gen, args.device, h, w, c, blk, win, dtype)

            def call_of(build):
                if not cuda:
                    return lambda: window_conv_plain(*data)
                fn = entry(build, dtype)
                return lambda: launch(fn, *data)

            want = call_of(this)()
            cell = {label: {'ms': [], 'prof_ms': []} for label, _, _ in plan}
            for build in order:
                call = call_of(build)
                t = cell[build[0]]
                t['ms'].append(time_ms(call, args.reps, cuda))
                t['prof_ms'].append(
                    profiled_ms(call, max(args.reps // 4, 3)) if cuda
                    else None)
                t['max_abs_diff'] = (call() - want).abs().max().item()
            key = f'{name} {h}x{w}x{c} blk {blk} win {win} {dname}'
            result['shapes'][key] = cell

            def prof(t):
                if t['prof_ms'][0] is None:
                    return 'profiler not measured'
                return (f'profiler {t["prof_ms"][0]:.4f}/'
                        f'{t["prof_ms"][1]:.4f}')

            print(f'{key}: ' + '; '.join(
                f'{label} {t["ms"][0]:.4f}/{t["ms"][1]:.4f} ms ({prof(t)}; '
                f'max |diff| {t["max_abs_diff"]:.3g})'
                for label, t in cell.items()) + f' ({device})', flush=True)
            for label, t in cell.items():
                s = sums.setdefault(dname, {}).setdefault(
                    label, {'ms': 0.0, 'prof_ms': 0.0 if cuda else None})
                s['ms'] += sum(t['ms']) / 2
                if cuda:
                    s['prof_ms'] += sum(t['prof_ms']) / 2
            del data, want
            if cuda:
                torch.cuda.empty_cache()
    result['sums'] = sums
    result['products_bound_ms'] = bound
    for dname, by_build in sums.items():
        for label, s in by_build.items():
            prof = ('not measured' if s['prof_ms'] is None
                    else f'{s["prof_ms"]:.4f}')
            print(f'sum over the two DynAggs, {dname}, {label}: '
                  f'{s["ms"]:.4f} ms by events, {prof} by the profiler '
                  f'(means of the two passes; the products\' bound '
                  f'{bound:.4f} ms; {device})')
    print(device)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
