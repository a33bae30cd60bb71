"""Time kernel B1 (``csrc/patch_match.cu``, behind ``match_argmax``) at
the main path's shapes, beside its plain version, ``torch.matmul`` + max
and its bound.

The main path hands B1 a request's exact descriptor grid, with no bias:
an HR 512x336 CUFED5 request gives 126 x 82 = 10332 query and 10332 ref
descriptors of depth 2304 per image. This script times ``match_argmax``
there, at each batch and in f32 and bf16 (random rows normalised as the
main path's; made on the card from a seed), holds each result against
``match_argmax_plain`` on the same inputs (indices equal wherever the
plain top-2 gap exceeds 1e-4, values within 1e-4, as chip_smoke.py's
phase b1), and prints one JSON line. It calls nothing but
``match_argmax`` and ``match_argmax_plain``, so it times a checkout of an
earlier tree as well: run it with that checkout first on ``PYTHONPATH``.

Usage: python -m c2matching_tpu_torch.scripts.bench_match
       [--batches 1 16] [--dtypes float32 bfloat16] [--out FILE]
   or: PYTHONPATH=<checkout> python <path of this file> ...
Needs a CUDA card; times are CUDA events over repeated calls.
"""
import argparse
import json
import math
import subprocess

import torch

from c2matching_tpu_torch.ops import match_argmax, match_argmax_plain

N, D = 126 * 82, 9 * 256               # descriptors of a request, depth
GAP_TOL = VAL_TOL = 1e-4               # chip_smoke.py's B1 gates
PEAK_BYTES_S = 3.35e12                 # H100 SXM: memory, and the tensor
PEAK_OPS = {torch.float32: 495e12 / 3,  # cores' dense rates (3xTF32: three
            torch.bfloat16: 989e12}     # TF32 products an f32 product)


def card():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, min_ms=50.0):
    """Mean device time of ``fn`` over enough calls to fill ``min_ms`` (at
    least 3), after one timed warm-up call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(100, math.ceil(min_ms / max(start.elapsed_time(end),
                                                  1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(batch, gen):
    """q (B, N, D) of 9 unit pixels each (norm 3, as the main path's
    unnormalised queries) and r (B, N, D) of unit rows."""
    q = torch.randn(batch, N, 9, D // 9, generator=gen, device='cuda')
    q = (q / q.norm(dim=-1, keepdim=True)).reshape(batch, N, D)
    r = torch.randn(batch, N, D, generator=gen, device='cuda')
    return q, r / r.norm(dim=-1, keepdim=True)


def check(q, r, idx, val):
    """Image by image against the plain version: (rows whose index differs
    where the plain top-2 gap exceeds GAP_TOL, max |value difference|)."""
    bad, err = 0, 0.0
    for i in range(q.shape[0]):
        scores = torch.matmul(q[i].float(), r[i].float().mT)
        top2 = scores.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > GAP_TOL
        p_idx, p_val = match_argmax_plain(q[i:i + 1], r[i:i + 1])
        bad += int(((idx[i] != p_idx[0]) & clear).sum())
        err = max(err, (val[i] - p_val[0]).abs().max().item())
        del scores, top2
    return bad, err


def measure(q, r):
    """Kernel, plain and library ms, the check, and the peak memory the
    call adds (outputs and scratch)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    idx, val = match_argmax(q, r)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    bad, err = check(q, r, idx, val)
    return {'ms': cuda_ms(lambda: match_argmax(q, r)),
            'library_ms': cuda_ms(
                lambda: torch.matmul(q, r.mT).max(dim=-1)),
            'plain_ms': cuda_ms(lambda: match_argmax_plain(q, r)),
            'bad_idx': bad, 'max_abs_err': err, 'call_peak_gib': added / 2**30}


def bound_ms(q, r, dtype):
    """The least time for the function: q and r read once, the index and
    value written; 2 operations per (query, ref row, channel) at the
    tensor cores' rate for the type."""
    b, nq, d = q.shape
    nbytes = (q.numel() + r.numel()) * q.element_size() + 8 * b * nq
    ops = 2 * b * nq * r.shape[1] * d
    return max(1e3 * nbytes / PEAK_BYTES_S, 1e3 * ops / PEAK_OPS[dtype])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--batches', type=int, nargs='+', default=[1, 16])
    parser.add_argument('--dtypes', nargs='+',
                        default=['float32', 'bfloat16'])
    parser.add_argument('--label', default='')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('bench_match: no CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    print(f'card: {name}; torch {torch.__version__}', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    for batch in args.batches:
        q32, r32 = inputs(batch, gen)
        for dname in args.dtypes:
            dtype = getattr(torch, dname)
            q, r = q32.to(dtype), r32.to(dtype)
            row = {'label': args.label, 'dtype': dname, 'batch': batch,
                   **measure(q, r), 'bound_ms': bound_ms(q, r, dtype),
                   'card': name}
            rows.append(row)
            print(f'{args.label} {dname} batch {batch} {N}x{N}x{D}: '
                  f'{row["ms"]:.3f} ms (plain {row["plain_ms"]:.3f}, '
                  f'matmul + max {row["library_ms"]:.3f}, bound '
                  f'{row["bound_ms"]:.3f}); call peak '
                  f'{row["call_peak_gib"]:.3f} GiB; checks: '
                  f'{row["bad_idx"]} indices off, |val| '
                  f'{row["max_abs_err"]:.3g} ({name})', flush=True)
            del q, r
            torch.cuda.empty_cache()
        del q32, r32
        torch.cuda.empty_cache()
    line = json.dumps({'bench_match': rows})
    print(line)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')


if __name__ == '__main__':
    main()
