"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, ``perfbench/``
and the PyTorch/CUDA package under test. Needs as many CUDA cards as the
cell asks for, and exits non-zero with no result line without them. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1``
``breakdown`` too; ``checks`` last, each compared number beside its
limit), and the last lines of standard error repeat the compared numbers.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the program's kernel caches, at fixed paths inside the checkout
for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                 ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
    os.environ[var] = str(CHECKOUT / 'build' / 'perfbench' / sub)
sys.path.insert(0, str(CHECKOUT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench.harness import bench

    cell = bench.load_cell(args.workload)
    chips = cell['entry']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'{args.workload} needs {chips} CUDA card(s); this host has '
              f'{have}', file=sys.stderr)
        return 2
    result, numbers = bench.run_cell(args.workload, args.seed, args.seconds,
                                     args.trace, 'cuda', T0, cell)
    found = bench.forbidden_modules()
    if found:
        print(f'modules that must not load in a run: {found}',
              file=sys.stderr)
        return 3
    for line in numbers.notes + numbers.lines():
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
