"""B1 and the B3 forward as registered operators, and the serving export
(``c2matching_tpu_torch/scripts/export_serving.py``).

``torch.library.opcheck`` holds both operators' schemas, fake
implementations and dispatch on the CPU (B1 in f32 and bf16 with a
padded ``ref_bias``; B3 in f32 and bf16). ``export_serving`` at batch 2,
HR 64x64 and a small width (ngf 16, 2 blocks; f32) is saved as a
``.pt2`` and loaded in a fresh process that imports
``c2matching_tpu_torch.ops`` and cannot import
``c2matching_tpu_torch.models``: its output equals the in-process forward
within 1e-6 (the same CPU ops in the same order; measured 0), and the
JAX package's exported artifact (``scripts/export_serving.py``,
``export_serving(...).call``) on the same bridged weights within 1e-5
(measured here: 1.2e-7; the two frameworks sum convolutions and the
correlation in other orders, and 1e-5 leaves room for other thread
counts; a flipped near-tie match would exceed it).
"""
import os
import os.path as osp
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2matching_tpu_torch.models import create_model
from c2matching_tpu_torch.ops import deform_im2col, match_argmax
from c2matching_tpu_torch.scripts.export_serving import (build_serving_fn,
                                                         export_serving)
from c2matching_tpu_torch.utils import dict_to_nonedict
from c2matching_tpu_torch.utils.options import parse
from test_torch_serve import REPO, bridged_options

sys.path.insert(0, osp.join(REPO, 'scripts'))

import export_serving as jax_export  # noqa: E402

JAX_TOL = 1e-5
# loads the artifact in a fresh interpreter that cannot import the model
# code (nor JAX), and runs it on the saved inputs
LOADER = '''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if (name.startswith('c2matching_tpu_torch.models')
                or name.split('.')[0] in ('jax', 'c2matching_tpu')):
            raise ImportError(f'{name} is blocked for this run')
        return None
sys.meta_path.insert(0, Block())
import torch
import c2matching_tpu_torch.ops
artifact, inputs, out = sys.argv[1:]
program = torch.export.load(artifact)
with torch.no_grad():
    torch.save(program.module()(*torch.load(inputs)), out)
assert not any(m.startswith('c2matching_tpu_torch.models')
               for m in sys.modules)
'''


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _b1_inputs(dtype):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 30, 24, generator=g).to(dtype)
    r = torch.randn(2, 40, 24, generator=g).to(dtype)
    bias = torch.zeros(40)
    bias[-7:] = -1e30          # padded ref rows, as a bucket gives them
    return q, r, bias


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_opcheck_match_argmax(dtype):
    q, r, bias = _b1_inputs(dtype)
    torch.library.opcheck(torch.ops.c2matching.match_argmax, (q, r, bias))
    torch.library.opcheck(torch.ops.c2matching.match_argmax, (q, r, None))
    idx, _ = match_argmax(q, r, bias)
    assert int(idx.max()) < 33     # no padded row wins


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_opcheck_deform_im2col(dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(7, 6, 16, generator=g).to(dtype)
    offset = 3 * torch.randn(7, 6, 2, 9, 2, generator=g)
    mask = torch.rand(7, 6, 2, 9, generator=g)
    for conv in (([3, 3], [1, 1], [1, 1], [1, 1]),
                 ([3, 3], [2, 2], [2, 2], [2, 2])):
        if conv[1] == [2, 2]:
            offset, mask = offset[:4, :3], mask[:4, :3]
        torch.library.opcheck(torch.ops.c2matching.deform_im2col,
                              (x, offset.contiguous(), mask.contiguous(),
                               *conv))


def test_wrappers_count_no_launch_on_cpu():
    """The wrappers go through the operators; on CPU tensors the plain
    versions run and no kernel launch is counted."""
    n = (match_argmax.launches, deform_im2col.launches)
    match_argmax(*_b1_inputs(torch.float32))
    deform_im2col(torch.rand(4, 4, 16), torch.zeros(4, 4, 2, 9, 2),
                  torch.ones(4, 4, 2, 9))
    assert (match_argmax.launches, deform_im2col.launches) == n


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """The small model (port and JAX, bridged weights), its artifact at
    batch 2 and HR 64x64 written by ``torch.export.save``, and inputs."""
    root = tmp_path_factory.mktemp('export')
    jax_model, opt_path = bridged_options(str(root))
    model = create_model(dict_to_nonedict(parse(opt_path, is_train=False)),
                         'cpu')
    program = export_serving(model, 2, 64, 64)
    artifact = str(root / 'serving_b2_64x64.pt2')
    torch.export.save(program, artifact)
    rng = np.random.RandomState(5)
    inputs = [rng.rand(2, 64, 64, 3).astype(np.float32),
              rng.rand(2, 64, 64, 3).astype(np.float32),
              rng.rand(2, 16, 16, 3).astype(np.float32)]
    return root, model, jax_model, artifact, inputs


def test_exported_graph_calls_the_operators(exported):
    _, model, _, _, _ = exported
    program = export_serving(model, 2, 64, 64)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == 'call_function']
    assert targets.count('c2matching.match_argmax.default') == 1
    # one fused call a DynAgg for the batch, no columns and no
    # autograd.Function in the graph
    assert targets.count('c2matching.deform_conv_fused.default') == 3
    assert targets.count('c2matching.deform_im2col.default') == 0


def test_artifact_loads_without_model_code(exported):
    root, model, _, artifact, inputs = exported
    tensors = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        direct = build_serving_fn(model)(*tensors)
    torch.save(tensors, str(root / 'inputs.pt'))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2')
    proc = subprocess.run(
        [sys.executable, '-c', LOADER, artifact, str(root / 'inputs.pt'),
         str(root / 'loaded.pt')], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    loaded = torch.load(str(root / 'loaded.pt'))
    assert loaded.shape == (2, 64, 64, 3)
    assert (loaded - direct).abs().max().item() <= 1e-6


def test_artifact_agrees_with_jax_export(exported):
    _, model, jax_model, artifact, inputs = exported
    exp = jax_export.export_serving(jax_model, 2, 64, 64, platforms=['cpu'])
    want = np.asarray(exp.call(*[jnp.asarray(a) for a in inputs]))
    program = torch.export.load(artifact)
    with torch.no_grad():
        got = program.module()(*[torch.from_numpy(a) for a in inputs])
    assert got.shape == want.shape == (2, 64, 64, 3)
    err = np.abs(got.numpy() - want).max()
    assert err <= JAX_TOL, err


def test_export_refuses_hr_off_the_scale(exported):
    _, model, _, _, _ = exported
    with pytest.raises(ValueError):
        export_serving(model, 2, 66, 64)
