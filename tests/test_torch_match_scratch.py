"""The scratch that kernel B1's operator allocates, and its counter
``match_argmax.scratch_bytes`` (read by the benchmark's
``b1_scratch_gib``): f32 operands take their TF32 split, two f32 copies of
q and of r; a launch split over partitions takes each partition's
(max, argmax) of every query."""
import importlib

import pytest
import torch

pmk = importlib.import_module('c2matching_tpu_torch.ops.patch_match_kernel')

# a batch of 16 HR 512x336 requests: 126 x 94 query patches on the padded
# relu3 grid, 126 x 82 kept reference rows, 9 x 256 deep
CELL = dict(batch=16, nq=11844, nr=10332, d=2304)


def test_the_f32_split_at_batch_16():
    got = pmk.scratch_bytes(**CELL, dtype=torch.float32, parts=1)
    assert got == 6_539_968_512
    assert got == 2 * 16 * 22_176 * 2_304 * 4


def test_bf16_has_no_split():
    assert pmk.scratch_bytes(**CELL, dtype=torch.bfloat16, parts=1) == 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('parts', [2, 3, 7])
def test_partitions_add_a_value_and_index_a_query(dtype, parts):
    one = pmk.scratch_bytes(**CELL, dtype=dtype, parts=1)
    got = pmk.scratch_bytes(**CELL, dtype=dtype, parts=parts)
    assert got - one == CELL['batch'] * parts * CELL['nq'] * 8


def test_the_counter_keeps_the_largest_call(monkeypatch):
    monkeypatch.setattr(pmk.match_argmax, 'scratch_bytes', 0)
    for nbytes in (100, 5_000, 40, 5_000, 0):
        pmk._count_scratch(nbytes)
    assert pmk.match_argmax.scratch_bytes == 5_000
    pmk._count_scratch(6_539_968_512)
    pmk._count_scratch(1)
    assert pmk.match_argmax.scratch_bytes == 6_539_968_512


def test_a_cpu_call_allocates_no_scratch(monkeypatch):
    """The plain version on a CPU tensor neither allocates nor counts."""
    monkeypatch.setattr(pmk.match_argmax, 'scratch_bytes', 0)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 16, generator=gen)
    r = torch.randn(2, 4, 16, generator=gen)
    pmk.match_argmax(q, r)
    assert pmk.match_argmax.scratch_bytes == 0
