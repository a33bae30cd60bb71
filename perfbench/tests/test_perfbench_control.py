"""The control, the plain reference one precision step below each
configuration's put in the package's place, must come out not correct
at the cell's own size. On the card only."""
import pytest

from perfbench import calibrate
from perfbench.harness import bench

WORKLOADS = [w['name'] for w in bench.load_benchmark()['workloads']]


@pytest.mark.card
@pytest.mark.parametrize('workload', WORKLOADS)
def test_control_fails(workload, card):
    numbers = calibrate.control(workload, 1000003)
    assert not numbers.correct(), numbers.table()
