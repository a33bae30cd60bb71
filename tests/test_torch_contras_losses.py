"""The port's contrastive losses against the JAX package's, on the CPU.

``c2matching_tpu_torch/models/contras_losses.py`` against
``c2matching_tpu/models/contras_losses.py`` on the same numpy inputs: the
pinned values of ``tests/test_golden.py``, random features on random
homography grids (24 x 24 x 16 and 40 x 40 x 32, the grids from the
dataset's own homography draw), and the gradients with respect to every
feature tensor against ``jax.grad`` within 1e-5 of the largest.

Ties, which split the gradient evenly on both sides (``amin`` /
``jnp.min`` over a row, ``minimum`` between the two negatives), are built
on purpose: descriptors with four entries of +-1 (norm 2, so every
normalised dot product is a multiple of 1/4 and exact in any summation
order) repeat across positions, and feat1 == feat2 on an identity grid
makes neg1 == neg2. Every case but the gate's asserts that each sample
passed the 128-correspondence gate, so no test passes on a zero loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2matching_tpu.models import contras_losses as jl
from c2matching_tpu_torch.data.contras_dataset import (
    image_pair_generation, transformed_coordinate_grid)
from c2matching_tpu_torch.models import contras_losses as tl

RTOL = 1e-5


def identity_coords(h, w, batch=2):
    gx, gy = np.meshgrid(np.arange(4 * w), np.arange(4 * h))
    c = np.stack([gx, gy, np.ones_like(gx)], -1).astype(np.float32)
    return np.stack([c] * batch)


def homography_coords(h, w, batch, seed):
    rng = np.random.RandomState(seed)
    return np.stack([
        transformed_coordinate_grid(
            image_pair_generation(None, (0, 10), 160, rng=rng), 4 * h, 4 * w)
        for _ in range(batch)])


def sparse_sign_features(rng, batch, h, w, c, palette=None):
    """Features whose vectors have four entries of +-1: drawn per position,
    or from a palette of ``palette`` vectors, so that whole rows of the
    distance matrices repeat."""
    n = palette or batch * h * w
    out = np.zeros((n, c), np.float32)
    for v in out:
        v[rng.choice(c, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    if palette:
        out = out[rng.randint(0, palette, batch * h * w)]
    return out.reshape(batch, h, w, c)


def port_run(fn, feats, coords, **kw):
    ts = [torch.tensor(f, requires_grad=True) for f in feats]
    out = fn(*ts, torch.tensor(coords), **kw)
    out[0].backward()
    return [float(v.detach()) for v in out], [t.grad.numpy() for t in ts]


def jax_run(fn, feats, coords, **kw):
    args = [jnp.asarray(f) for f in feats]
    c = jnp.asarray(coords)
    out = fn(*args, c, **kw)

    def loss(*a):
        return fn(*a, c, **kw)[0]

    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return [float(v) for v in out], [np.asarray(g) for g in grads]


def assert_match(feats, coords, distill, n_ok, **kw):
    fn_t = tl.distillation_loss_batch if distill else tl.triplet_loss_batch
    fn_j = jl.distillation_loss_batch if distill else jl.triplet_loss_batch
    vals_t, grads_t = port_run(fn_t, feats, coords, **kw)
    vals_j, grads_j = jax_run(fn_j, feats, coords, **kw)
    assert vals_t[-1] == vals_j[-1] == n_ok
    np.testing.assert_allclose(vals_t, vals_j, rtol=RTOL, atol=0)
    for i, (gt, gj) in enumerate(zip(grads_t, grads_j)):
        top = np.abs(gj).max()
        assert top > 0, f'feature {i}: zero gradient'
        err = np.abs(gt - gj).max()
        assert err <= RTOL * top, (f'feature {i}: max |d grad| {err:.3g} > '
                                   f'{RTOL:g} x {top:.3g}')
    return vals_t, grads_t


def golden_inputs():
    rng = np.random.RandomState(42)
    return [rng.randn(2, 24, 24, 16).astype(np.float32) for _ in range(4)]


def test_golden_values():
    """The pinned values of tests/test_golden.py, and JAX's gradients."""
    f1, f2, t1, t2 = golden_inputs()
    vals, _ = assert_match([f1, f2], identity_coords(24, 24), False, 2)
    np.testing.assert_allclose(vals[:3], [2.3959751, 1.9925020, 0.5965269],
                               rtol=RTOL)
    vals, _ = assert_match([f1, f2, t1, t2], identity_coords(24, 24), True,
                           2)
    np.testing.assert_allclose([vals[0], vals[3]], [38.373493, 2.3985012],
                               rtol=RTOL)


@pytest.mark.parametrize('distill', [False, True])
@pytest.mark.parametrize('h,c,seed', [(24, 16, 0), (40, 32, 1)])
def test_random_homography(h, c, seed, distill):
    rng = np.random.RandomState(100 + seed)
    n_feats = 4 if distill else 2
    feats = [rng.randn(2, h, h, c).astype(np.float32)
             for _ in range(n_feats)]
    assert_match(feats, homography_coords(h, h, 2, seed), distill, 2,
                 safe_radius=4)


@pytest.mark.parametrize('distill', [False, True])
def test_ties_repeated_descriptors(distill):
    """feat2's vectors come from a palette of six, so rows of dist1 and
    columns of dist2 repeat exactly: the hardest negative ties."""
    rng = np.random.RandomState(7)
    f1 = sparse_sign_features(rng, 2, 24, 24, 16)
    f2 = sparse_sign_features(rng, 2, 24, 24, 16, palette=6)
    feats = [f1, f2]
    if distill:
        feats += [sparse_sign_features(rng, 2, 24, 24, 16),
                  sparse_sign_features(rng, 2, 24, 24, 16, palette=6)]
    coords = homography_coords(24, 24, 2, 3)
    assert_match(feats, coords, distill, 2)
    # the ties are there: equal minima within rows of the port's terms
    terms = tl._terms(torch.tensor(f1), torch.tensor(f2),
                      torch.tensor(coords), 4, 2)
    dist1 = 2 - 2 * terms['d2'] @ terms['d1'].transpose(1, 2)
    assert int((dist1 == dist1.amin(2, keepdim=True)).sum(2).max()) > 1


@pytest.mark.parametrize('distill', [False, True])
def test_ties_identical_features(distill):
    """feat1 == feat2 on an identity grid: neg1 == neg2 wherever the
    hardest negative is a valid position."""
    rng = np.random.RandomState(11)
    f = sparse_sign_features(rng, 2, 24, 24, 16)
    feats = [f, f.copy()]
    if distill:
        t = sparse_sign_features(rng, 2, 24, 24, 16)
        feats += [t, t.copy()]
    coords = identity_coords(24, 24)
    assert_match(feats, coords, distill, 2)
    terms = tl._terms(torch.tensor(f), torch.tensor(f), torch.tensor(coords),
                      4, 2)
    ties = (terms['neg1'] == terms['neg2']) & (terms['valid'] > 0)
    assert int(ties.sum()) > 100


@pytest.mark.parametrize('distill', [False, True])
def test_sample_gate(distill):
    """A sample whose grid lies outside the image has no valid
    correspondence: it is left out of every mean (n_valid 1)."""
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, 24, 24, 16).astype(np.float32)
             for _ in range(4 if distill else 2)]
    coords = homography_coords(24, 24, 2, 4)
    coords[1, ..., 0] += 500.0
    vals, grads = assert_match(feats, coords, distill, 1)
    for g in grads:
        assert np.abs(g[1]).max() == 0


def test_out_of_range_coordinates():
    """Non-finite and huge warped coordinates (at the stride-4 positions
    the loss reads) give JAX's clipped index."""
    coords = identity_coords(24, 24, batch=1)
    coords[0, 0, 0:32:4, 0] = [np.nan, np.inf, -np.inf, 3e30, -3e30, 1e9,
                               -7, 400]
    rng = np.random.RandomState(9)
    f1, f2 = (rng.randn(1, 24, 24, 16).astype(np.float32) for _ in range(2))
    terms = tl._terms(torch.tensor(f1), torch.tensor(f2),
                      torch.tensor(coords), 4, 2)
    want = jax.vmap(lambda a, b, c: jl._per_sample_terms(a, b, c, 4, 2))(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords))
    np.testing.assert_array_equal(terms['flat2'].numpy(),
                                  np.asarray(want['flat2']))
    assert_match([f1, f2], coords, False, 1)
