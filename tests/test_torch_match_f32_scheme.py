"""The f32 scheme of kernel B1 (``csrc/patch_match.cu``), emulated in
torch on the CPU, against the JAX package's ``match_argmax``.

On the card B1 takes f32 operands as 3xTF32: each value x splits into
big = tf32(x) and small = tf32(x - big), both rounded as the kernel's
``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero), and the
scores are big.big + big.small + small.big summed in f32. The kernel's
tensor cores sum each chunk of depth (one 32-value stage of its ring) in a
fresh accumulator, and one rounded f32 add takes the chunk into the
running score. The emulation here does the same with bit operations and
three f32 products, over the whole depth at once or chunk by chunk at the
sizes the kernel may use. It is held against JAX's Pallas kernel in
interpret mode (true f32) with chip_smoke's criteria: indices equal
wherever the exact top-2 gap exceeds 1e-4, and values within 1e-4. A
single TF32 pass, the scheme the kernel refuses, is shown to flip near
ties that 3xTF32 keeps.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from c2matching_tpu.ops.pallas import match_argmax as jax_match_argmax

B1_VAL_TOL = 1e-4   # chip_smoke.py: |kernel - plain| of the max score
B1_GAP_TOL = 1e-4   # chip_smoke.py: indices must agree above this gap
D = 9 * 256         # the main path's depth: 3 x 3 patches of relu3_1
# depth summed in one fresh accumulator before the f32 add: None, the
# whole depth in one f32 matmul; 32, one stage of the kernel's ring; 8, a
# single wgmma step; 64 and 256, longer chunks the kernel may take
CHUNKS = (None, 8, 32, 64, 256)


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tf32_rna(x):
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of the 13
    dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def match_argmax_3xtf32(q, r, bias=None, chunk=None):
    """B1's f32 scheme: three TF32 products summed in f32, the bias,
    then the first maximum. With ``chunk``, each ``chunk`` values of
    depth sum their three products in a fresh f32 sum, which one f32 add
    takes into the running scores."""
    qb, qs = split_tf32(q)
    rb, rs = split_tf32(r)
    scores = torch.zeros(q.shape[0], r.shape[0])
    for k in range(0, q.shape[1], chunk or q.shape[1]):
        c = slice(k, k + (chunk or q.shape[1]))
        scores = scores + (qb[:, c] @ rs[:, c].T + qs[:, c] @ rb[:, c].T
                           + qb[:, c] @ rb[:, c].T)
    if bias is not None:
        scores = scores + bias
    return scores.argmax(-1), scores.amax(-1)


def match_argmax_tf32(q, r, bias=None):
    """One TF32 pass: the scheme the kernel does not use."""
    scores = tf32_rna(q) @ tf32_rna(r).T
    if bias is not None:
        scores = scores + bias
    return scores.argmax(-1), scores.amax(-1)


def patch_descriptors(rng, n, extra, excluded=0):
    """Patch-structured descriptors at depth D: q of 9 L2-normalised
    pixels, as the main path builds them (norm 3); for each query a
    normalised near copy and a second row scoring higher by a gap drawn
    log-uniformly from 1e-7 to 1e-3; normalised random rows besides; all
    ref rows shuffled. ``excluded`` random ref rows get a -1e30 bias.
    Returns (q, r, bias) as f32 numpy arrays (bias None when nothing is
    excluded)."""
    q = rng.randn(n, 9, D // 9)
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(n, D)
    first = q + 0.02 * rng.randn(n, D)
    first /= np.linalg.norm(first, axis=-1, keepdims=True)
    gap = 10.0 ** rng.uniform(-7, -3, (n, 1))
    second = first + gap * q / (q * q).sum(-1, keepdims=True)
    rest = rng.randn(extra, D)
    rest /= np.linalg.norm(rest, axis=-1, keepdims=True)
    r = np.concatenate([first, second, rest])[rng.permutation(2 * n + extra)]
    bias = None
    if excluded:
        bias = np.zeros(len(r), np.float32)
        bias[rng.choice(len(r), excluded, replace=False)] = -1e30
    return q.astype(np.float32), r.astype(np.float32), bias


def exact_top2_gap(q, r, bias):
    scores = q.astype(np.float64) @ r.astype(np.float64).T
    if bias is not None:
        scores = scores + bias
    top2 = np.sort(scores, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_tf32_rounding_is_cvt_rna():
    """Round to nearest on 10 mantissa bits, ties away from zero, and
    the low 13 bits cleared."""
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 2.0 ** -12,
                      one + 3 * 2.0 ** -11, -(one + 2.0 ** -11),
                      one + 2.0 ** -11 - 2.0 ** -23, 0.0, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, one, one + 2.0 ** -9,
                         -(one + 2.0 ** -10), one, 0.0, 3.0],
                        dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()


def test_split_keeps_f32_precision():
    """x - (big + small) is at most 2^-22 |x|: small's own rounding."""
    x = torch.from_numpy(np.random.RandomState(0).randn(100000)
                         .astype(np.float32))
    big, small = split_tf32(x)
    rest = (x.double() - big.double() - small.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x.double().abs()).all())
    assert not ((big.view(torch.int32) | small.view(torch.int32))
                & 0x1FFF).any()


@pytest.fixture(scope='module')
def jax_results():
    """JAX's Pallas kernel in interpret mode on each seed's inputs, once
    for every chunk size."""
    return {}


@pytest.mark.parametrize('seed,excluded,chunk', [
    pytest.param(seed, excluded, chunk, id=f'{seed}-{excluded}' + (
        '' if chunk is None else f'-chunk{chunk}'))
    for chunk in CHUNKS for seed, excluded in [(0, 0), (1, 0), (2, 150)]])
def test_3xtf32_matches_jax_interpret(seed, excluded, chunk, jax_results):
    """Near ties at the main path's depth, with and without ref rows
    excluded by the -1e30 bias, the depth summed at once or chunk by
    chunk: chip_smoke's criteria against JAX's Pallas kernel in interpret
    mode."""
    rng = np.random.RandomState(seed)
    q, r, bias = patch_descriptors(rng, 200, 180, excluded)
    if seed not in jax_results:
        jax_results[seed] = jax_match_argmax(
            jnp.asarray(q), jnp.asarray(r),
            ref_bias=None if bias is None else jnp.asarray(bias),
            tile_q=128, tile_r=128, interpret=True)
    want_i, want_v = jax_results[seed]
    got_i, got_v = match_argmax_3xtf32(
        torch.from_numpy(q), torch.from_numpy(r),
        None if bias is None else torch.from_numpy(bias), chunk)
    gap = exact_top2_gap(q, r, bias)
    clear = gap > B1_GAP_TOL
    assert clear.sum() > 20
    np.testing.assert_array_equal(got_i.numpy()[clear],
                                  np.asarray(want_i)[clear])
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=B1_VAL_TOL)
    if bias is not None:
        assert np.all(bias[got_i.numpy()] == 0)


def test_3xtf32_keeps_near_ties_that_one_tf32_pass_flips():
    """On rows whose exact top-2 gap lies in [1e-6, 1e-4], below
    chip_smoke's criterion, 3xTF32 picks the exact winner on every row
    and its values stay within 1e-5 of the exact maxima (it measured
    ~1e-6), summed at once or chunk by chunk; a single TF32 pass flips
    some of those rows (7 of ~200 with this seed) and its values drift by
    ~9e-5, at the edge of B1_VAL_TOL."""
    rng = np.random.RandomState(3)
    q, r, _ = patch_descriptors(rng, 400, 100)
    scores = q.astype(np.float64) @ r.astype(np.float64).T
    exact = scores.argmax(-1)
    gap = exact_top2_gap(q, r, None)
    near = (gap >= 1e-6) & (gap <= 1e-4)
    assert near.sum() > 100
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    for chunk in CHUNKS:
        three, val3 = match_argmax_3xtf32(qt, rt, chunk=chunk)
        assert np.array_equal(three.numpy()[near], exact[near]), chunk
        assert np.abs(val3.numpy() - scores.max(-1)).max() < 1e-5, chunk
    one, val1 = match_argmax_tf32(qt, rt)
    assert (one.numpy()[near] != exact[near]).sum() >= 3
    assert np.abs(val1.numpy() - scores.max(-1)).max() > 3e-5
