"""Time the deformable conv's backward kernel (``csrc/deform_conv_backward.cu``)
at the stage-3 training DynAggs' shapes, against its variants and against
an earlier tree's kernel.

Builds, each timed on the same inputs (batch 9, f32 and bf16 images; the
offset and mask gradients, as training asks, and once more with grad_x):

- this tree's source as it is;
- with ``--roles``, the source with ``C2M_DCB_ROLE=1`` (the products
  alone) and ``=2`` (the corner dots alone): a measurement's switch that
  the default build never sets, which says which role sets the pace (the
  gradients are then wrong);
- with ``--define A=1,B=2`` (repeatable), the source built with those
  macros, a variant to try;
- with ``--parent DIR``, the kernel of the checkout at DIR (an earlier
  tree, unpacked with ``git archive``), through the same C entry points.

The builds run in the order parent, this tree, its variants, then the same
in reverse (parent, change, change, parent), so that the two passes show
the run-to-run spread. Each time is a mean over ``--reps`` calls by CUDA
events, and by ``torch.profiler`` as the summed device time of every
kernel of a call (the w_kc pre-split included). Each build's gradients are
held against this tree's default build's (max |diff| of the largest).

Usage: python -m c2matching_tpu_torch.scripts.bench_dcn_backward
       [--batch 9] [--reps 40] [--roles] [--parent DIR]
       [--define A=1,B=2 ...] [--out FILE]
Needs a CUDA card of compute capability 9.0 and nvcc. Prints a line per
DynAgg and dtype, the sums over the three DynAggs, the card's name and
power limit, and one JSON line of every number (also written to --out).
"""
import argparse
import json
import math
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops.deform_conv import _BACKWARD_ARGTYPES, _BACKWARD_ENTRY

SOURCE = 'deform_conv_backward'
ROLES = (('products alone', 'C2M_DCB_ROLE=1'),
         ('dots alone', 'C2M_DCB_ROLE=2'))
# stage-3 training at gt 160: the DynAggs' (name, h, w, C = Co), 8 groups
SHAPES = (('relu3_1', 40, 40, 256), ('relu2_1', 80, 80, 128),
          ('relu1_1', 160, 160, 64))


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


def inputs(gen, h, w, c, dtype, batch, g=8, k=9):
    """One DynAgg's backward inputs: integer shifts of up to 4 plus a
    random residual (taps across the edges), a random mask, grad_out and
    w_kc at the DCN's init scale (bf16-rounded for a bf16 image)."""
    dev = 'cuda'
    x = torch.randn(batch, h, w, c, generator=gen, device=dev).to(dtype)
    shift = torch.randint(-4, 5, (batch, h, w, 1, k, 2), generator=gen,
                          device=dev).float()
    offset = shift + torch.randn(batch, h, w, g, k, 2, generator=gen,
                                 device=dev)
    mask = torch.rand(batch, h, w, g, k, generator=gen, device=dev)
    grad_out = torch.randn(batch, h, w, c, generator=gen, device=dev)
    w_kc = torch.randn(k * c, c, generator=gen, device=dev) / math.sqrt(k * c)
    return x, offset, mask, grad_out, w_kc.to(dtype).float()


def entry(build, dtype):
    """The C entry of ``build`` (label, defines, src), its argument types
    set."""
    _, defines, src = build
    fn = getattr(_build.load(SOURCE, defines, src), _BACKWARD_ENTRY[dtype])
    fn.argtypes = _BACKWARD_ARGTYPES
    return fn


def backward(fn, x, offset, mask, grad_out, w_kc, grad_x=False):
    """The offset and mask gradients of a 3x3, stride-1, padding-1 conv,
    and with ``grad_x`` also x's (f32)."""
    b, h, w, c = x.shape
    _, ho, wo, g, _, _ = offset.shape
    g_offset = torch.empty_like(offset)
    g_mask = torch.empty_like(mask)
    g_x = (torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
           if grad_x else None)
    err = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
             grad_out.data_ptr(), w_kc.data_ptr(), g_offset.data_ptr(),
             g_mask.data_ptr(), None if g_x is None else g_x.data_ptr(), b,
             h, w, c, ho, wo, g, 3, 3, 1, 1, 1, 1, 1, 1, w_kc.shape[1],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'{SOURCE}: CUDA error {err}')
    return g_offset, g_mask


def time_ms(call, reps):
    """Mean time per call over ``reps`` calls in one queue, after one, by
    CUDA events."""
    call()
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--batch', type=int, default=9)
    parser.add_argument('--reps', type=int, default=40)
    parser.add_argument('--roles', action='store_true',
                        help='also time the products alone and the corner '
                             'dots alone (C2M_DCB_ROLE)')
    parser.add_argument('--parent', default=None,
                        help='a checkout of an earlier tree whose kernel '
                             'is timed beside this one')
    parser.add_argument('--define', action='append', default=[],
                        help='also time the source built with these '
                             'macros, comma-separated (repeatable)')
    parser.add_argument('--out', default=None, help='write the JSON here')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('bench_dcn_backward needs a CUDA card')
    device = card()
    plan = builds(args.parent, args.roles, args.define)
    logs = _build.build([(SOURCE, d, s) for _, d, s in plan], verbose=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')
    gen = torch.Generator(device='cuda').manual_seed(0)
    order = plan + plan[::-1]
    this = plan[1] if args.parent else plan[0]
    result = {'card': device, 'batch': args.batch, 'shapes': {}}
    sums = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace('torch.', '')
        for name, h, w, c in SHAPES:
            data = inputs(gen, h, w, c, dtype, args.batch)
            want = backward(entry(this, dtype), *data)
            scale = max(t.abs().max().item() for t in want)
            cell = {label: {'ms': [], 'prof_ms': [], 'x_ms': []}
                    for label, _, _ in plan}
            for build in order:
                fn = entry(build, dtype)
                t = cell[build[0]]
                t['ms'].append(time_ms(lambda: backward(fn, *data),
                                       args.reps))
                t['prof_ms'].append(profiled_ms(
                    lambda: backward(fn, *data), max(args.reps // 4, 3)))
                t['x_ms'].append(time_ms(
                    lambda: backward(fn, *data, grad_x=True), args.reps))
                got = backward(fn, *data)
                t['rel_diff'] = max((a - b).abs().max().item()
                                    for a, b in zip(got, want)) / scale
            key = f'{name} {args.batch}x{h}x{w}x{c} {dname}'
            result['shapes'][key] = cell
            print(f'{key}: ' + '; '.join(
                f'{label} {t["ms"][0]:.4f}/{t["ms"][1]:.4f} ms (profiler '
                f'{t["prof_ms"][0]:.4f}/{t["prof_ms"][1]:.4f}; with grad_x '
                f'{t["x_ms"][0]:.4f}/{t["x_ms"][1]:.4f}; |diff| '
                f'{t["rel_diff"]:.2g} of the largest)'
                for label, t in cell.items()) + f' ({device})', flush=True)
            for label, t in cell.items():
                s = sums.setdefault(dname, {}).setdefault(
                    label, {'ms': 0.0, 'prof_ms': 0.0, 'x_ms': 0.0})
                for k in s:
                    s[k] += sum(t[k]) / len(t[k])
            del data, want
            torch.cuda.empty_cache()
    result['sums'] = sums
    for dname, by_build in sums.items():
        for label, s in by_build.items():
            print(f'sum over the three DynAggs, {dname}, {label}: '
                  f'{s["ms"]:.4f} ms by events, {s["prof_ms"]:.4f} by the '
                  f'profiler, with grad_x {s["x_ms"]:.4f} (means of the two '
                  f'passes; {device})')
    print(device)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
