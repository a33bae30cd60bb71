"""The work functions against the figures the port's own kernel bounds
gave (PERF.md's kernel table, from chip_smoke's ``_b1_work``)."""
from perfbench.harness import work


def test_b1_work_reproduces_the_kernel_tables_figure():
    # one HR 512x336 request: 11844 query rows against the 10332 kept
    # reference rows, 9 x 256 deep: 563.9 GFLOP, 3.42 ms as 3xTF32
    nbytes, ops, seconds = work.b1_work(11844, 10332, 2304, 'float32')
    assert round(ops / 1e9, 1) == 563.9
    assert round(seconds * 1e3, 2) == 3.42
    assert seconds == 3 * ops / work.PEAK_FLOPS['tfloat32']
