"""A run with the timed path broken underneath must come out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at the tiny size, with one fault of ``harness/faults.py`` planted in
the package under test, once for each fault the cell can have: a step
that returns its state unchanged, half of the batch left out (the mean
over the rest), an answer altered where it is produced. (No cell spans
chips, so none can leave an exchange out.) The same run unbroken comes
out correct against the committed limits.
"""
import pytest

from perfbench.harness import bench, faults
from perfbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 7
FAULTS = {
    'serve_b16_cufed5': ('answer_altered', 'half_batch'),
    'train_gan_b9': ('state_unchanged', 'half_batch'),
    'train_pretrain_b9': ('state_unchanged', 'half_batch'),
}
CASES = [(w, f) for w, names in FAULTS.items() for f in names]


def _run(workload):
    return bench.run_cell(workload, SEED, 1.0, 0, 'cpu',
                          cell=tiny_cell(workload))


@pytest.mark.parametrize('workload', sorted(FAULTS))
def test_unbroken_run_is_correct(workload):
    result, numbers = _run(workload)
    assert result['correct'], numbers.table()


@pytest.mark.parametrize('workload,fault', CASES)
def test_fault_is_caught(workload, fault):
    with faults.planted(fault):
        result, numbers = _run(workload)
    assert not result['correct'], numbers.table()
