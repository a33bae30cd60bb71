"""The port's YAML reader and option parsing against yaml and the JAX
package.

``c2matching_tpu_torch.utils.options.safe_load`` must equal
``yaml.safe_load`` on every file under ``options/`` and on PyYAML 1.1's
plain-scalar quirks, refuse what lies outside its subset with the line
number, and ``parse`` must equal ``c2matching_tpu.utils.options.parse``.
"""
import glob
import math
import os.path as osp

import pytest
import yaml

from c2matching_tpu.utils import options as jax_options
from c2matching_tpu_torch.utils import options

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
OPTION_FILES = sorted(glob.glob(osp.join(REPO, 'options', '**', '*.yml'),
                                recursive=True))
TEST_FILES = [f for f in OPTION_FILES if '/options/test/' in f]


def _rel(path):
    return osp.relpath(path, REPO)


def test_every_options_file_is_covered():
    assert len(OPTION_FILES) >= 13 and len(TEST_FILES) >= 6


@pytest.mark.parametrize('path', OPTION_FILES, ids=_rel)
def test_reader_equals_yaml_on_options_files(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert options.load(path) == want


@pytest.mark.parametrize('text', [
    'a: 1e-3', 'a: !!float 1e-3', 'a: !!float 5e3', "a: !!float '2'",
    'a: ~', 'a:', 'a: null', 'a: 1.0e-3', 'a: 1.0e3', 'a: 3.', 'a: .5',
    'a: -1', 'a: +7', 'a: 0', 'a: 017', 'a: 08', 'a: 0x1F', 'a: 0b101',
    'a: 1_000', 'a: 1:30', 'a: 1.5:1', 'a: .inf', 'a: -.Inf',
    'a: yes', 'a: Off', 'a: TRUE', "a: 'it''s'", 'a: "tab\\there"',
    "a: '1e-3'", 'a: x#y', 'a: x # comment', "'relu5_1': 1", '"k k": v',
    "a: [1, 2.5, ~, true, x y, 'q', \"r\"]", 'a: []', 'a: [1, ]',
    'b:\n  c: 1\n  d:\n    e: [a, b]\nf: g', '# only a comment', '',
    'a:\n\n  # inside\n  b: 1\nc: 2',
])
def test_reader_quirks_equal_yaml(text):
    got, want = options.safe_load(text), yaml.safe_load(text)
    assert repr(got) == repr(want), (got, want)


def test_nan():
    assert math.isnan(options.safe_load('a: .NaN')['a'])


@pytest.mark.parametrize('text,line', [
    ('a: &x 1', 1), ('a: 1\nb: *x', 2), ('a: |\n  t', 1), ('- a', 1),
    ('a: {b: 1}', 1), ('a: !!str 1', 1), ('a: 2001-12-14', 1),
    ('---\na: 1', 1), ('a: b\n  c', 2), ('a: [1,\n 2]', 1),
    ('a: b: c', 1), ('a: [[1]]', 1), ('a:\n\tb: 1', 2), ('a: !!float x', 1),
])
def test_reader_refuses_outside_the_subset(text, line):
    with pytest.raises(options.YAMLSubsetError, match=f'<string>:{line}:'):
        options.safe_load(text)


@pytest.mark.parametrize('path', TEST_FILES, ids=_rel)
def test_parse_equals_jax_parse(path, tmp_path, monkeypatch):
    monkeypatch.setenv('C2MATCHING_ROOT', str(tmp_path))
    got = options.parse(path, is_train=False)
    want = jax_options.parse(path, is_train=False)
    assert got == want
    assert got['crop_border'] == got['scale']
    assert got['path']['results_root'] == osp.join(str(tmp_path), 'results',
                                                   got['name'])
    for ds in got['datasets'].values():
        assert ds['phase'] == 'test' and ds['scale'] == got['scale']
    nd = options.dict_to_nonedict(got)
    assert nd['no_such_key'] is None and nd['path']['nope'] is None
    assert options.dict2str(got) == jax_options.dict2str(want)


@pytest.mark.parametrize('path', [f for f in OPTION_FILES
                                  if '/options/train/' in f], ids=_rel)
def test_parse_train_files_equals_jax_parse(path, tmp_path, monkeypatch):
    monkeypatch.setenv('C2MATCHING_ROOT', str(tmp_path))
    assert options.parse(path) == jax_options.parse(path)


def test_port_imports_no_cv2_pil_yaml():
    """The card's machine has no cv2, PIL or yaml: neither the port nor
    chip_smoke.py imports them, at any level."""
    import ast
    files = sorted(glob.glob(osp.join(REPO, 'c2matching_tpu_torch', '**',
                                      '*.py'), recursive=True))
    files.append(osp.join(REPO, 'chip_smoke.py'))
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            for name in names:
                assert name.split('.')[0] not in ('cv2', 'PIL', 'yaml'), \
                    f'{_rel(path)} imports {name}'
