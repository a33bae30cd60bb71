"""Contrastive triplet loss and distillation KL of stages 1 and 2.

Counterpart of ``c2matching_tpu/models/contras_losses.py``: the same
masks and constants, batched over the first axis.

- GT correspondences come from the homography coordinate grid sub-sampled
  at the feature stride; positions within 10 px of the border are
  invalid.
- Positive distance: 2 - 2 cos between matched descriptors.
- Negatives: the hardest (``amin``) over the dense distance matrix, with a
  +10 penalty inside the Chebyshev ``safe_radius`` and +1e4 on invalid
  columns. ``torch.amin`` and ``torch.minimum`` split the gradient evenly
  among ties, as ``jnp.min`` and ``jnp.minimum`` do.
- Per-sample loss: the valid mean of relu(margin + pos - min(neg1, neg2));
  a sample counts only with at least ``MIN_VALID_CORRS`` valid
  correspondences.
- Stage 2: the temperature-scaled row-softmax KL(teacher || student) over
  the matched pairs, batchmean over valid rows, in the JAX package's
  ``where(t > 0, t * (t_log - s), 0)`` form.

At world size > 1 (``world``), the count of samples over the gate is
summed over the ranks, and each returned mean is the rank's share of the
global one: world x the sum over its own samples / the global count, so
that the mean over the ranks of each value, and of the gradients, is the
global batch's. The returned count is the global count.

The Chebyshev test ``max(|dy|, |dx|) <= r`` is taken as ``|dy| <= r and
|dx| <= r`` on two broadcast differences, without the stacked
(n, n, 2) tensor: at a CUFED5 image's 10375 feature positions that tensor
alone is 861 MB.
"""
import torch
import torch.nn.functional as F

from ..parallel import sum_across_ranks

BIG = 1e4
MIN_VALID_CORRS = 128


def _normalize_cols(desc, eps=1e-12):
    """L2-normalize (..., C) descriptor vectors."""
    norm = torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True))
    return desc / torch.clamp_min(norm, eps)


def _near(pos, radius):
    """(B?, n, n) float: 1 where two (y, x) positions lie within Chebyshev
    distance ``radius``, else 0."""
    dy = (pos[..., :, None, 0] - pos[..., None, :, 0]).abs()
    dx = (pos[..., :, None, 1] - pos[..., None, :, 1]).abs()
    return ((dy <= radius) & (dx <= radius)).float()


def _terms(feat1, feat2, coords, safe_radius, scaling_steps):
    """Triplet-loss ingredients of a batch.

    Args:
        feat1: (B, h, w, C) dense features of image 1.
        feat2: (B, h, w, C) dense features of image 2 (the warped image).
        coords: (B, H, W, 3) homography-transformed coordinate grid at
            image resolution, last dim (x, y, 1); H = h * 2^scaling_steps.
    Returns a dict of (B, n) vectors, (B, n, C) descriptors and the
    (B, n) gather index into image 2.
    """
    b, h1, w1, c = feat1.shape
    n = h1 * w1
    scale = 2 ** scaling_steps
    dev = feat1.device

    d1 = _normalize_cols(feat1.reshape(b, n, c))
    gy, gx = torch.meshgrid(torch.arange(h1, dtype=torch.float32, device=dev),
                            torch.arange(w1, dtype=torch.float32, device=dev),
                            indexing='ij')
    pos1 = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=-1)  # (n, 2)

    pos2_xy = coords[:, ::scale, ::scale, :2].reshape(b, n, 2)
    x2, y2 = pos2_xy[..., 0], pos2_xy[..., 1]
    valid = ((x2 > 10) & (x2 < float(scale) * w1 - 10)
             & (y2 > 10) & (y2 < float(scale) * h1 - 10))

    # torch.round is half-to-even, as jnp.round
    pos2 = torch.stack([torch.round(y2 / scale), torch.round(x2 / scale)],
                       dim=-1)
    # the JAX package casts to int32 (saturating, NaN to 0) before its
    # clip; clamping in float first gives the same index for every input
    hi = torch.tensor([h1 - 1, w1 - 1], dtype=torch.float32, device=dev)
    idx = torch.minimum(torch.nan_to_num(pos2, nan=0.0).clamp_min(0), hi)
    idx = idx.long()
    flat2 = idx[..., 0] * w1 + idx[..., 1]                       # (B, n)
    d2 = _normalize_cols(torch.gather(feat2.reshape(b, n, c), 1,
                                      flat2[..., None].expand(b, n, c)))

    pos_dist = 2.0 - 2.0 * torch.sum(d1 * d2, dim=-1)             # (B, n)
    vmask = valid.float()

    # negative 2: d1_i against every matched d2_j, masked around pos2_i
    penal2 = (_near(pos2, safe_radius) * 10.0
              + (1.0 - vmask)[:, None, :] * BIG)
    dist2 = 2.0 - 2.0 * torch.matmul(d1, d2.transpose(1, 2))
    neg2 = torch.amin(dist2 + penal2, dim=2)

    # negative 1: d2_i against every image-1 descriptor, masked around
    # pos1_i
    penal1 = _near(pos1, safe_radius) * 10.0
    dist1 = 2.0 - 2.0 * torch.matmul(d2, d1.transpose(1, 2))
    neg1 = torch.amin(dist1 + penal1, dim=2)

    return {'d1': d1, 'd2': d2, 'pos_dist': pos_dist, 'neg1': neg1,
            'neg2': neg2, 'valid': vmask, 'flat2': flat2}


def _n_ok(sample_ok, world):
    """The count of samples over the gate, over the ranks at world > 1,
    at least 1."""
    n = torch.sum(sample_ok)
    if world > 1:
        n = sum_across_ranks(n)
    return torch.clamp_min(n, 1.0)


def _ok_mean(per_sample, ok, n_ok, world):
    """The gated mean's share of this rank (see the module docstring)."""
    return world * torch.sum(per_sample * ok) / n_ok


def _triplet_means(terms, margin, world=1):
    """(per-sample triplet loss, pos, neg, sample_ok, n_ok) of the terms;
    n_ok over the ranks at ``world`` > 1."""
    v = terms['valid']
    n_valid = torch.sum(v, dim=1)
    sample_ok = (n_valid >= MIN_VALID_CORRS).float()
    denom = torch.clamp_min(n_valid, 1.0)
    neg = torch.minimum(terms['neg1'], terms['neg2'])
    diff = terms['pos_dist'] - neg
    loss = torch.sum(F.relu(margin + diff) * v, dim=1) / denom
    pos = torch.sum(terms['pos_dist'] * v, dim=1) / denom
    negm = torch.sum(neg * v, dim=1) / denom
    return loss, pos, negm, sample_ok, _n_ok(sample_ok, world)


def triplet_loss_batch(feat1, feat2, coords, margin=1.0, safe_radius=4,
                       scaling_steps=2, world=1):
    """Batched triplet loss (stage 1). feat*: (B, h, w, C); coords:
    (B, H, W, 3). Returns (loss, pos_dist, neg_dist, n_valid_samples);
    at ``world`` > 1 the rank's shares and the global count."""
    terms = _terms(feat1, feat2, coords, safe_radius, scaling_steps)
    loss, pos, neg, ok, n_ok = _triplet_means(terms, margin, world)
    n_valid = n_ok if world > 1 else torch.sum(ok)
    return (_ok_mean(loss, ok, n_ok, world), _ok_mean(pos, ok, n_ok, world),
            _ok_mean(neg, ok, n_ok, world), n_valid)


def _kl_rows(student_logits, teacher_logits, valid):
    """Row-wise KL(teacher || student) over valid rows and columns,
    batchmean over valid rows. logits: (B, n, n); valid: (B, n)."""
    col_mask = torch.where(valid[:, None, :] > 0, 0.0, -1e9)
    s = F.log_softmax(student_logits + col_mask, dim=2)
    t = F.softmax(teacher_logits + col_mask, dim=2)
    t_log = F.log_softmax(teacher_logits + col_mask, dim=2)
    per_row = torch.sum(torch.where(t > 0, t * (t_log - s), 0.0), dim=2)
    n_rows = torch.clamp_min(torch.sum(valid, dim=1), 1.0)
    return torch.sum(per_row * valid, dim=1) / n_rows


def distillation_loss_batch(student_feat1, student_feat2, teacher_feat1,
                            teacher_feat2, coords, margin=1.0,
                            safe_radius=4, scaling_steps=2,
                            temperature=0.15, distill_weight=15.0, world=1):
    """Stage-2 loss: the student's triplet loss plus ``distill_weight``
    times the KL distillation from the teacher's correlation rows.

    Returns (loss, pos_dist, neg_dist, distill_loss, n_valid_samples); at
    ``world`` > 1 the rank's shares and the global count."""
    terms = _terms(student_feat1, student_feat2, coords, safe_radius,
                   scaling_steps)
    b, h1, w1, c = teacher_feat1.shape
    n = h1 * w1
    t_d1 = _normalize_cols(teacher_feat1.reshape(b, n, c))
    t_d2 = _normalize_cols(torch.gather(
        teacher_feat2.reshape(b, n, c), 1,
        terms['flat2'][..., None].expand(b, n, c)))
    s_logits = torch.matmul(terms['d1'],
                            terms['d2'].transpose(1, 2)) / temperature
    t_logits = torch.matmul(t_d1, t_d2.transpose(1, 2)) / temperature
    distill = _kl_rows(s_logits, t_logits, terms['valid'])

    triplet, pos, neg, ok, n_ok = _triplet_means(terms, margin, world)
    triplet = _ok_mean(triplet, ok, n_ok, world)
    distill_mean = _ok_mean(distill, ok, n_ok, world)
    n_valid = n_ok if world > 1 else torch.sum(ok)
    return (triplet + distill_weight * distill_mean,
            _ok_mean(pos, ok, n_ok, world), _ok_mean(neg, ok, n_ok, world),
            distill_mean, n_valid)
