"""Readings that the limits of ``correct`` are set from, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 8] [--trace-seeds 2]

For each of ``--seeds`` a whole run of the cell (``--trace-seeds`` of
them traced) prints its compared numbers and ``correct`` as one JSON line;
for each of ``--control-seeds`` the control, the plain reference in the
precision one step below the configuration's (its ``control_precision``)
put in the program's place on that seed's inputs, prints the same
numbers, which the limits must reject. The benchmark's own runs never run
the control. Needs a CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control(workload, seed, device='cuda', cell=None):
    """The control's numbers on ``seed``: set-up as a run makes it (the
    same weights, inputs and sample), no window, then the reference in the
    control precision answers in the program's place."""
    from perfbench.harness import bench
    from perfbench.reference import nets
    cell = cell or bench.load_cell(workload)
    run = bench.Run(cell, seed, 1.0, False, device, time.perf_counter())
    drv = bench.driver(run.traffic['driver'])
    drv.setup(run)
    drv.release(run)
    prec = nets.Precision(**run.config['control_precision'])
    with nets.exact_float32():
        if run.traffic['driver'] == 'serve':
            import torch
            with torch.no_grad():
                numbers = drv.judge(run, drv.control_samples(run, prec))
        else:
            numbers = drv.judge(run, drv.control_result(run, prec))
    return numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--trace-seeds', type=int, default=0)
    ap.add_argument('--seconds', type=float, default=8.0)
    ap.add_argument('--fault', default=None,
                    help='plant this fault of harness/faults.py in the '
                    'program runs (a reading of the fault)')
    ap.add_argument('--no-tf32', action='store_true',
                    help='cuDNN without TF32 in the program runs (a second '
                    'witness of what TF32 rounding moves)')
    args = ap.parse_args(argv)
    import contextlib

    import torch
    from perfbench.harness import bench, faults
    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(',') if s]
    kind = 'program' if args.fault is None else f'fault {args.fault}'
    if args.no_tf32:
        kind += ' no-tf32'
    for i, seed in enumerate(seeds):
        traced = int(i < args.trace_seeds)
        t = time.perf_counter()
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            result, numbers = bench.run_cell(args.workload, seed,
                                             args.seconds, traced, 'cuda', t)
        print(json.dumps({'kind': kind, 'seed': seed, 'trace': traced,
                          'correct': result['correct'],
                          'checks': numbers.table(), 'at': numbers.at,
                          'notes': numbers.notes, 'detail': numbers.detail,
                          'metrics': result['metrics']}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(',') if s]:
        numbers = control(args.workload, seed)
        print(json.dumps({'kind': 'control', 'seed': seed,
                          'correct': numbers.correct(),
                          'checks': numbers.table(), 'at': numbers.at,
                          'notes': numbers.notes,
                          'detail': numbers.detail}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
