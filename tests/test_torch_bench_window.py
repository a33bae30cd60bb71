"""``scripts/bench_window.py`` on the CPU: its plan of builds, its
arguments and its JSON line, through ``main`` with ``--device cpu`` at the
DynAggs cut by ``--shrink 16`` (relu1 32x24x64, relu2 16x12x128), where
the plain version stands in for every build. The times are CPU times: the
tests check the plan, the keys and finite values only."""
import json
import math
from pathlib import Path

import pytest
import torch

from c2matching_tpu_torch.scripts import bench_window

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_plan_of_builds():
    """The parent first, then this tree, the role builds and the variants,
    each with its macros."""
    plan = bench_window.builds(ROOT, roles=True, defines=['A=1,B=2'])
    assert [label for label, _, _ in plan] == [
        'parent', 'this tree', 'without columns', 'without products',
        'A=1,B=2']
    assert plan[0][2] == str(ROOT / 'c2matching_tpu_torch' / 'csrc'
                             / 'dcn_window.cu')
    assert [d for _, d, _ in plan[1:]] == [
        (), ('C2M_B2_ROLE=1',), ('C2M_B2_ROLE=2',), ('A=1', 'B=2')]
    assert bench_window.builds() == [('this tree', (), None)]
    with pytest.raises(SystemExit, match='no .*dcn_window.cu'):
        bench_window.builds(ROOT / 'tests')


def test_products_bound_is_the_two_dynaggs_contraction():
    """2 P K C Co operations at each DynAgg, three TF32 products each, at
    495 TFLOP/s: 0.176 ms over the two."""
    got = sum(bench_window.products_bound_ms(h, w, c)
              for _, h, w, c, _, _ in bench_window.SHAPES)
    want = sum(3 * 2 * h * w * 9 * c * c
               for _, h, w, c, _, _ in bench_window.SHAPES) / 495e12 * 1e3
    assert got == pytest.approx(want) and 0.17 < got < 0.18


def test_cpu_dry_run_keys(tmp_path, capsys):
    """Every build of the plan at each DynAgg and dtype, two passes each,
    the sums, and one JSON line, also written to ``--out``; the
    profiler's device time is null on the CPU."""
    out_file = tmp_path / 'bench.json'
    bench_window.main(['--device', 'cpu', '--shrink', '16', '--reps', '1',
                       '--roles', '--parent', str(ROOT), '--define', 'A=1',
                       '--out', str(out_file)])
    lines = capsys.readouterr().out.splitlines()
    json_lines = [line for line in lines if line.startswith('{')]
    assert len(json_lines) == 1 and lines[-1] == json_lines[0]
    assert lines[-2] == 'cpu'
    result = json.loads(json_lines[0])
    assert json.loads(out_file.read_text()) == result
    labels = ['parent', 'this tree', 'without columns', 'without products',
              'A=1']
    assert result['card'] == 'cpu' and result['shrink'] == 16
    assert sorted(result['shapes']) == sorted(
        f'{name} {h // 16}x{w // 16}x{c} blk {blk} win {win} {dtype}'
        for name, h, w, c, blk, win in bench_window.SHAPES
        for dtype in ('float32', 'bfloat16'))
    for cell in result['shapes'].values():
        assert list(cell) == labels
        for t in cell.values():
            assert len(t['ms']) == 2 and all(math.isfinite(v) and v > 0
                                             for v in t['ms'])
            assert t['prof_ms'] == [None, None]
            assert t['max_abs_diff'] == 0.0
    assert sorted(result['sums']) == ['bfloat16', 'float32']
    for by_build in result['sums'].values():
        assert list(by_build) == labels
        for s in by_build.values():
            assert math.isfinite(s['ms']) and s['prof_ms'] is None
    assert result['products_bound_ms'] == pytest.approx(sum(
        bench_window.products_bound_ms(h // 16, w // 16, c)
        for _, h, w, c, _, _ in bench_window.SHAPES))
    sums = [line for line in lines if line.startswith('sum over the two')]
    assert len(sums) == 2 * len(labels)


def test_the_card_is_the_default():
    """Without ``--device cpu`` the bench needs a card and says so."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(SystemExit, match='needs a CUDA card'):
        bench_window.main([])
