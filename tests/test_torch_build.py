"""The port's kernel build (``c2matching_tpu_torch/ops/_build.py``): what
the library hash covers. Nothing is compiled here; the hash decides
whether a cached library is reused, so an edited header must change it."""
import importlib

import pytest

_build = importlib.import_module('c2matching_tpu_torch.ops._build')


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of two sources, one including a header that includes
    another; the build directory beside it."""
    (tmp_path / 'a.cu').write_text('#include "one.cuh"\nint a;\n')
    (tmp_path / 'b.cu').write_text('#include <cuda_runtime.h>\nint b;\n')
    (tmp_path / 'one.cuh').write_text(' #  include "two.cuh"\n')
    (tmp_path / 'two.cuh').write_text('#pragma once\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    return tmp_path


def test_local_headers_follow_includes(csrc):
    assert _build.local_headers(csrc / 'a.cu') == [csrc / 'one.cuh',
                                                   csrc / 'two.cuh']
    assert _build.local_headers(csrc / 'b.cu') == []


def test_every_source_of_the_port_finds_its_headers():
    for name in _build.SOURCES:
        for header in _build.local_headers(_build.CSRC / f'{name}.cu'):
            assert header.exists() and header.suffix == '.cuh'
    assert (_build.CSRC / 'common.cuh') in _build.local_headers(
        _build.CSRC / 'patch_match.cu')


@pytest.mark.parametrize('name', ['patch_match', 'dcn_window',
                                  'deform_conv_backward'])
def test_tensor_core_kernels_share_their_helpers(name):
    """B1, B2 and B3's backward take their tensor-core helpers from one
    header (the 3xTF32 split and shared-memory addresses; B2 also
    ldmatrix), so an edit there rebuilds all three."""
    assert (_build.CSRC / 'mma.cuh') in _build.local_headers(
        _build.CSRC / f'{name}.cu')
    assert _build.library_path(name).name.startswith(f'{name}-')


@pytest.mark.parametrize('name', ['patch_match', 'deform_conv_backward',
                                  'dcn_window'])
def test_hopper_kernels_share_their_header(name):
    """B1, B2 and B3's backward feed wgmma from TMA through one header (the
    mbarrier, TMA, descriptor and wgmma helpers, the tensor-map encoder and
    the scratch pool), so an edit there rebuilds all three."""
    header = _build.CSRC / 'hopper.cuh'
    assert header in _build.local_headers(_build.CSRC / f'{name}.cu')
    before = _build.library_path(name)
    assert before.name.startswith(f'{name}-')


def test_an_earlier_trees_source_builds_apart(csrc, tmp_path_factory):
    """A source of another checkout (``src``) hashes its own headers, so it
    builds into a library of its own beside this tree's."""
    other = tmp_path_factory.mktemp('other')
    (other / 'a.cu').write_text('#include "one.cuh"\nint a;\n')
    (other / 'one.cuh').write_text('// older\n')
    here = _build.library_path('a')
    there = _build.library_path('a', (), other / 'a.cu')
    assert _build.local_headers(other / 'a.cu') == [other / 'one.cuh']
    assert there != here and there.parent == here.parent
    assert there.name.startswith('a-')


@pytest.mark.parametrize('edited', ['a.cu', 'one.cuh', 'two.cuh'])
def test_an_edited_source_or_header_changes_the_library(csrc, edited):
    before = _build.library_path('a')
    with open(csrc / edited, 'a') as f:
        f.write('// edited\n')
    assert _build.library_path('a') != before


def test_flags_change_the_library_and_other_sources_do_not(csrc,
                                                           monkeypatch):
    before = _build.library_path('a')
    (csrc / 'b.cu').write_text('int b2;\n')
    assert _build.library_path('a') == before
    monkeypatch.setattr(_build, 'NVCC_FLAGS', _build.NVCC_FLAGS + ('-g',))
    assert _build.library_path('a') != before


def test_defines_change_the_library(csrc):
    """A measurement's variant (a source built with its macros) gets a
    library of its own, and the plain build keeps its path."""
    plain = _build.library_path('a')
    assert _build.library_path('a', ()) == plain
    one = _build.library_path('a', ('C2M_DCB_ROLE=1',))
    other = _build.library_path('a', ('C2M_DCB_ROLE=2',))
    assert len({plain, one, other}) == 3
    assert one.name.startswith('a-')
