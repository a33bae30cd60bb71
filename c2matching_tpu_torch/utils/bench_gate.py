"""Regression gate: a measured number against its pinned value.

Counterpart of ``c2matching_tpu/utils/bench_gate.py``, with the same
``gate`` and a pin of the card's own. The JAX package's pins are a TPU's
and are not carried over; the serving pin waits for the port's serving
bench.

``PINNED_GAN_STEP_MS``: the stage-3 GAN step with the batch already on
the card, as ``python -m c2matching_tpu_torch.scripts.bench_train --stage
3 --decompose --iters 10`` measures it in a process of its own (batch 9
at gt 160, bf16 DCN gathers, torch's default TF32 settings: cuDNN
convolutions in TF32, matmuls in float32; host clock around a
synchronised ``optimize_parameters`` plus one loss read, the median of
its iterations): the median of three such runs, 163.1, 131.5 and
144.1 ms, on an NVIDIA H100 80GB HBM3 at a 700 W power limit. With TF32
off (as chip_smoke.py runs its phases) the same step takes about twice
as long.
"""
import sys

PINNED_GAN_STEP_MS = 144.1        # ms/iter on the card, lower is better
PINNED_CARD = 'NVIDIA H100 80GB HBM3, 700 W'   # the card it was taken on


def gate(value, pinned, higher_is_better=True, tolerance=0.10):
    """Compare ``value`` to ``pinned``; return JSON-mergeable gate fields.

    Args:
        value: the fresh measurement.
        pinned: the pinned value.
        higher_is_better: metric direction (images/s True, ms False).
        tolerance: allowed fractional regression before flagging.

    Returns:
        dict with ``vs_pinned`` (value / pinned, rounded to 3 places) and,
        only when the regression exceeds ``tolerance``, ``regression:
        True`` plus a warning on stderr.
    """
    if pinned <= 0:
        raise ValueError('pinned must be positive')
    ratio = value / pinned
    out = {'vs_pinned': round(ratio, 3)}
    regressed = (ratio < 1.0 - tolerance) if higher_is_better \
        else (ratio > 1.0 + tolerance)
    if regressed:
        out['regression'] = True
        print(f'WARNING: benchmark regression: measured {value:g} vs '
              f'pinned {pinned:g} '
              f'({"-" if higher_is_better else "+"}{abs(1 - ratio):.1%}, '
              f'tolerance {tolerance:.0%}) — see '
              f'c2matching_tpu_torch/utils/bench_gate.py for the pin',
              file=sys.stderr)
    return out
