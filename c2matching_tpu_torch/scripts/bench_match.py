"""Time kernel B1 (``csrc/patch_match.cu``, behind ``match_argmax``) at
the main path's shapes, beside its plain version, ``torch.matmul`` + max
and its bound.

One HR 512x336 request (the CUFED5 bucket) hands B1 126 x 94 = 11844
query descriptors of depth 2304 per image. Its ref descriptors come in two
forms: all 11844 rows with a -1e30 bias on the 1512 that lie past the
valid region (the form of the JAX package and of earlier trees), or the
126 x 82 = 10332 rows that can win, with no bias (``batched_patch_match``
now). This script times ``match_argmax`` on both forms, at each batch and
in f32 and bf16 (random rows normalised as the main path's; made on the
card from a seed), holds each result against ``match_argmax_plain`` on the
same inputs (indices equal wherever the plain top-2 gap exceeds 1e-4,
values within 1e-4, as chip_smoke.py's phase b1), and prints one JSON line.
It calls nothing but ``match_argmax`` and ``match_argmax_plain``, so it
times a checkout of an earlier tree as well: run it with that checkout
first on ``PYTHONPATH``.

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

HR, WR, VW, D = 126, 94, 82, 9 * 256   # descriptors of the bucket, depth
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
    """q (B, 11844, D) of 9 unit pixels each (norm 3, as the main path's
    unnormalised queries), the whole ref (B, 11844, D) of unit rows, the
    bias that excludes its columns past VW, and the kept block (B, 10332,
    D)."""
    q = torch.randn(batch, HR * WR, 9, D // 9, generator=gen, device='cuda')
    q = (q / q.norm(dim=-1, keepdim=True)).reshape(batch, HR * WR, D)
    r = torch.randn(batch, HR * WR, D, generator=gen, device='cuda')
    r = r / r.norm(dim=-1, keepdim=True)
    col = torch.arange(HR * WR, device='cuda') % WR
    bias = torch.where(col < VW, 0.0, -1e30).float()
    kept = r.reshape(batch, HR, WR, D)[:, :, :VW].reshape(batch, -1, D)
    return q, r, bias, kept.contiguous()


def check(q, r, bias, idx, val):
    """Image by image against the plain version: (rows whose index differs
    where the plain top-2 gap exceeds GAP_TOL, max |value difference|)."""
    bad, err = 0, 0.0
    for i in range(q.shape[0]):
        scores = torch.matmul(q[i].float(), r[i].float().mT)
        if bias is not None:
            scores = scores + bias
        top2 = scores.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > GAP_TOL
        p_idx, p_val = match_argmax_plain(q[i:i + 1], r[i:i + 1], bias)
        bad += int(((idx[i] != p_idx[0]) & clear).sum())
        err = max(err, (val[i] - p_val[0]).abs().max().item())
        del scores, top2
    return bad, err


def measure(q, r, bias):
    """Kernel, plain and library ms, the check, and the peak memory the
    call adds (outputs and scratch)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    idx, val = match_argmax(q, r, bias)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    bad, err = check(q, r, bias, idx, val)

    def library():
        scores = torch.matmul(q, r.mT)
        return (scores if bias is None else scores + bias).max(dim=-1)

    out = {'ms': cuda_ms(lambda: match_argmax(q, r, bias)),
           'library_ms': cuda_ms(library),
           'plain_ms': cuda_ms(lambda: match_argmax_plain(q, r, bias)),
           'bad_idx': bad, 'max_abs_err': err, 'call_peak_gib': added / 2**30}
    return out, idx, val


def bound_ms(q, kept, dtype):
    """The least time for the function: q and the kept ref rows read once,
    the index and value written; 2 operations per (query, kept ref row,
    channel) at the tensor cores' rate for the type."""
    b, nq, d = q.shape
    nbytes = (q.numel() + kept.numel()) * q.element_size() + 8 * b * nq
    ops = 2 * b * nq * kept.shape[1] * d
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
        q32, r32, bias, kept32 = inputs(batch, gen)
        for dname in args.dtypes:
            dtype = getattr(torch, dname)
            q, r, kept = q32.to(dtype), r32.to(dtype), kept32.to(dtype)
            full, f_idx, f_val = measure(q, r, bias)
            comp, c_idx, c_val = measure(q, kept, None)
            mapped = (c_idx // VW) * WR + c_idx % VW
            row = {'label': args.label, 'dtype': dname, 'batch': batch,
                   'full_bias': full, 'kept': comp,
                   'bound_ms': bound_ms(q, kept, dtype),
                   'kept_vs_full_idx_differ': int((mapped != f_idx).sum()),
                   'kept_vs_full_max_val_diff':
                       (c_val - f_val).abs().max().item(),
                   'card': name}
            rows.append(row)
            print(f'{args.label} {dname} batch {batch}: kept rows '
                  f'{comp["ms"]:.3f} ms (plain {comp["plain_ms"]:.3f}, '
                  f'matmul + max {comp["library_ms"]:.3f}), all rows + '
                  f'bias {full["ms"]:.3f} ms (matmul + max '
                  f'{full["library_ms"]:.3f}), bound {row["bound_ms"]:.3f} '
                  f'ms; call peak {comp["call_peak_gib"]:.3f} GiB kept, '
                  f'{full["call_peak_gib"]:.3f} all; checks: '
                  f'{comp["bad_idx"]} + {full["bad_idx"]} indices off, '
                  f'|val| {comp["max_abs_err"]:.3g} / '
                  f'{full["max_abs_err"]:.3g}; kept vs all '
                  f'{row["kept_vs_full_idx_differ"]} indices differ '
                  f'({name})', flush=True)
            del q, r, kept, f_idx, f_val, c_idx, c_val, mapped
            torch.cuda.empty_cache()
        del q32, r32, kept32
        torch.cuda.empty_cache()
    line = json.dumps({'bench_match': rows})
    print(line)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')


if __name__ == '__main__':
    main()
