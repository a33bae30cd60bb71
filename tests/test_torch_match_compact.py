"""The port's ``batched_patch_match`` on the exact-shape features against
the JAX package's on the bucket-padded ones, which scores every patch and
gives those past the valid region a -1e30 bias.

The port matches a request's exact descriptor grid, so kernel B1 gets
(vh-2)(vw-2) query and reference rows and no bias; the JAX package's
contract is that its padded match, cut to the valid query region and its
indices read on the valid grid, is the exact-shape match. Both run here on
the CPU (the port's plain version, JAX's XLA matmul) on the same seeded
numpy features, in f32 and with bf16 operands: the indices must be equal
and the values within 1e-5 (the same f32 formulas; bf16 products are exact
in f32, so only the order of the f32 sums differs). Exact ties keep the
lowest index, and a banded run at world size 2 (``val_spatial_shard``,
two gloo processes) gives the whole image's rows.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_dist_child as child

jax_pm = import_module('c2matching_tpu.ops.patch_match')
patch_match = import_module('c2matching_tpu_torch.ops.patch_match')

TOL = 1e-5        # |port - JAX| of the values: f32 sums in other orders
DTYPES = (None, 'bfloat16')
# valid feature sizes of 12 x 12 padded features (10 x 10 descriptors):
# columns off the grid, rows, both, none (the whole grid, and past it),
# one descriptor, none, and on the bucket (no valid_shape)
VALID = {'columns': (12, 9), 'rows': (9, 12), 'both': (9, 10),
         'nothing': (12, 12), 'past': (20, 20), 'one': (3, 3),
         'none_kept': (2, 5), 'on_bucket': None}


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _feats(seed, shape=(2, 12, 12, 8)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _exact_hw(feat, valid):
    h, w = feat.shape[1:3]
    return (h, w) if valid is None else (min(h, valid[0]), min(w, valid[1]))


def _jax(fi, fr, dtype, valid):
    """The JAX package's padded match, cut to the valid query region, its
    indices read on the valid (vh-2) x (vw-2) grid."""
    idx, val = jax_pm.batched_patch_match(jnp.asarray(fi), jnp.asarray(fr),
                                          compute_dtype=dtype,
                                          valid_shape=valid)
    idx, val = np.asarray(idx), np.asarray(val)
    vh, vw = (v - 2 for v in _exact_hw(fi, valid))
    vh, vw = max(vh, 0), max(vw, 0)
    w = idx.shape[2]
    idx = idx[:, :vh, :vw]
    return (idx // w) * vw + idx % w, val[:, :vh, :vw]


def _port(fi, fr, dtype, valid):
    """The port's match of the exact-shape features."""
    h, w = _exact_hw(fi, valid)
    idx, val = patch_match.batched_patch_match(
        torch.from_numpy(fi[:, :h, :w]), torch.from_numpy(fr[:, :h, :w]),
        compute_dtype=dtype)
    return idx.numpy(), val.numpy()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', VALID)
def test_exact_match_equals_jax_padded(case, dtype):
    valid = VALID[case]
    fi, fr = _feats(11)
    want_i, want_v = _jax(fi, fr, dtype, valid)
    got_i, got_v = _port(fi, fr, dtype, valid)
    assert got_i.shape == want_i.shape
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=TOL)


@pytest.mark.parametrize('case', VALID)
def test_b1_gets_exactly_the_request_grid(case, monkeypatch):
    """What B1 receives: (vh-2)(vw-2) query and reference rows and no
    bias; nothing where the request holds no 3x3 patch."""
    seen = []
    real = patch_match.match_argmax

    def record(q, r, ref_bias=None):
        seen.append((q.shape[1], r.shape[1], ref_bias))
        return real(q, r, ref_bias)

    monkeypatch.setattr(patch_match, 'match_argmax', record)
    fi, fr = _feats(12)
    _port(fi, fr, None, VALID[case])
    vh, vw = _exact_hw(fi, VALID[case])
    rows = max(vh - 2, 0) * max(vw - 2, 0)
    assert seen == ([(rows, rows, None)] if rows else [])


def _tie_feats(h=10, w=10, c=8):
    """One-hot pixels whose channel is the column mod c, the same in every
    row: every ref patch of a column is the same patch, its scores exact
    sums of one value."""
    x = np.zeros((1, h, w, c), np.float32)
    for col in range(w):
        x[0, :, col, col % c] = 1.0
    return x, x.copy()


@pytest.mark.parametrize('dtype', DTYPES)
def test_exact_ties_keep_the_lowest_index(dtype):
    """Patch (0, x) ties with (1, x), (2, x) ... on the exact 6 x 5 grid:
    the lowest index, x, wins, as in the JAX package's padded run."""
    fi, fr = _tie_feats()
    valid = (8, 7)            # 8 x 8 descriptors padded, 6 x 5 exact
    want_i, want_v = _jax(fi, fr, dtype, valid)
    got_i, got_v = _port(fi, fr, dtype, valid)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=TOL)
    assert np.array_equal(got_i[0], np.broadcast_to(np.arange(5), (6, 5)))


def test_banded_exact_match_equals_jax_padded(tmp_path):
    """Two ranks, each its band of the exact query rows against the whole
    exact reference, f32 and bf16: the bands' rows together are the JAX
    package's padded match (10 exact rows, which split into bands of 5)."""
    fi, fr = _feats(13)
    valid = (10, 9)
    h, w = valid
    jobs = []
    for dtype in DTYPES:
        path = tmp_path / f'in_{dtype}.pt'
        torch.save({'feat_in': torch.from_numpy(fi[:, :h, :w].copy()),
                    'feat_ref': torch.from_numpy(fr[:, :h, :w].copy()),
                    'compute_dtype': dtype}, path)
        jobs.append((['match_band', str(path), str(tmp_path / f'{dtype}')],
                     2))
    results = child.spawn(jobs, timeout=100)
    for out in results:
        for rc, text in out:
            assert rc == 0, text[-4000:]
    for dtype in DTYPES:
        want_i, want_v = _jax(fi, fr, dtype, valid)
        ranks = [torch.load(tmp_path / f'{dtype}.rank{r}', weights_only=False)
                 for r in range(2)]
        assert [r['band'] for r in ranks] == [(0, 5), (5, 5)]
        got_i = torch.cat([r['idx'] for r in ranks], dim=1).numpy()
        got_v = torch.cat([r['val'] for r in ranks], dim=1).numpy()
        assert ranks[1]['idx'].shape[1] == 3   # query rows 5-7 of 8
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=TOL)
