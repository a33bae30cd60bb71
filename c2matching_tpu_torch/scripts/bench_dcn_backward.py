"""Time each shape-driven variant of the deformable conv's backward kernel
(``csrc/deform_conv_backward.cu``) against its absence.

The kernel chooses by shape: its own instantiation for the group widths 8,
16 and 32 (CGT), 128-pixel tiles where 64-pixel ones would fill fewer than
two waves of the card (WIDE), grad_out split into its TF32 parts once a
64-pixel tile (PRESPLIT), and the corners gathered by cp.async at 8-channel
groups without grad_x (GATHER). This script builds the source as it is and
once more with each switch ``C2M_DCB_<NAME>=0``, and times every build on
the stage-3 training DynAggs' shapes (batch 9, f32 and bf16 images; the
offset and mask gradients, as training asks) by CUDA events. The builds run
in the order default, each switch, then the same in reverse, so that the
two passes show the run-to-run spread; each build's gradients are held
against the default build's.

Usage: python -m c2matching_tpu_torch.scripts.bench_dcn_backward
       [--batch 9] [--reps 40]
Needs a CUDA card of compute capability 9.0 and nvcc.
"""
import argparse
import math
import subprocess

import torch

from ..ops import _build
from ..ops.deform_conv import _BACKWARD_ARGTYPES, _BACKWARD_ENTRY

SOURCE = 'deform_conv_backward'
SWITCHES = ('CGT', 'WIDE', 'PRESPLIT', 'GATHER')
# stage-3 training at gt 160: the DynAggs' (name, h, w, C = Co), 8 groups
SHAPES = (('relu3_1', 40, 40, 256), ('relu2_1', 80, 80, 128),
          ('relu1_1', 160, 160, 64))


def builds():
    """(label, defines) of the default build and of each switch off."""
    return [('default', ())] + [(f'no {s}', (f'C2M_DCB_{s}=0',))
                                for s in SWITCHES]


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


def entry(defines, dtype):
    """The C entry of the build with ``defines``, its argument types set."""
    fn = getattr(_build.load(SOURCE, defines), _BACKWARD_ENTRY[dtype])
    fn.argtypes = _BACKWARD_ARGTYPES
    return fn


def backward(fn, x, offset, mask, grad_out, w_kc):
    """The offset and mask gradients of a 3x3, stride-1, padding-1 conv."""
    b, h, w, c = x.shape
    _, ho, wo, g, _, _ = offset.shape
    g_offset = torch.empty_like(offset)
    g_mask = torch.empty_like(mask)
    err = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
             grad_out.data_ptr(), w_kc.data_ptr(), g_offset.data_ptr(),
             g_mask.data_ptr(), None, b, h, w, c, ho, wo, g, 3, 3, 1, 1, 1,
             1, 1, 1, w_kc.shape[1], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'{SOURCE}: CUDA error {err}')
    return g_offset, g_mask


def time_ms(fn, args, reps):
    """Mean time per call over ``reps`` calls in one queue, after one."""
    backward(fn, *args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        backward(fn, *args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--batch', type=int, default=9)
    parser.add_argument('--reps', type=int, default=40)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('bench_dcn_backward needs a CUDA card')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    plan = builds()
    _build.build([(SOURCE, defines) for _, defines in plan])
    gen = torch.Generator(device='cuda').manual_seed(0)
    order = plan + plan[::-1]
    totals = {label: [0.0, 0.0] for label, _ in plan}
    for dtype in (torch.float32, torch.bfloat16):
        for name, h, w, c in SHAPES:
            data = inputs(gen, h, w, c, dtype, args.batch)
            want = backward(entry((), dtype), *data)
            times = {label: [] for label, _ in plan}
            worst = {}
            for label, defines in order:
                fn = entry(defines, dtype)
                times[label].append(time_ms(fn, data, args.reps))
                got = backward(fn, *data)
                worst[label] = max((a - b).abs().max().item()
                                   for a, b in zip(got, want))
            cells = ', '.join(
                f'{label} {t[0]:.4f}/{t[1]:.4f} ms (|diff| '
                f'{worst[label]:.2g})' for label, t in times.items())
            print(f'{name} {args.batch}x{h}x{w}x{c} {dtype}: {cells}',
                  flush=True)
            for label, t in times.items():
                if dtype == torch.float32:
                    totals[label][0] += sum(t) / 2
                else:
                    totals[label][1] += sum(t) / 2
            del data, want
            torch.cuda.empty_cache()
    for label, (f32, bf16) in totals.items():
        print(f'sum over the three DynAggs, {label}: f32 {f32:.4f} ms, '
              f'bf16 {bf16:.4f} ms (mean of the two passes)')
    print(card)


if __name__ == '__main__':
    main()
