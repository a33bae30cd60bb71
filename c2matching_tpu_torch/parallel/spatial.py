"""Horizontal image bands across ranks: the split of batch-1 evaluation.

Counterpart of the spatial branch of ``c2matching_tpu/parallel/mesh.py``'s
``shard_batch`` (``val_spatial_shard``). The JAX package places each image
as ``P(None, 'data')`` and lets XLA insert the halo exchanges and the
gathers; the port makes them by hand, one rank a band:

- ``Band``: rank ``rank``'s rows ``[row0, stop)`` of an axis that every
  rank's ``bounds`` split, at one scale; ``scaled(f)`` is the same split at
  ``f`` times the rows (x2, x4 and HR from LR; 1/2 at a pool).
- ``band_for(h, rank, world)``: the LR band of an LR height ``h``: rank r
  owns rows ``[floor(r h / world), floor((r + 1) h / world))``, so the
  bands differ by a row at most. None where every rank computes the whole
  image (world size 1, or bands under 2 rows, which the match's and the
  flow's 2-row halos need), logged once a shape, as the JAX package logs
  its replicate branch. The JAX package splits its bucket-padded height,
  which divides by 2, 4, 8 and 16, and replicates at any other world
  size; the port splits any height.
- ``exchange_halo(x, band, above, below)``: the band with ``above`` rows of
  the rank above and ``below`` rows of the rank below, zeros at the
  image's top and bottom; one all-gather of every rank's edge rows.
- ``gather_rows(x, band)``: the whole image, all-gathered along H.
- ``allreduce_sum(t)``: a sum over the ranks.

The collectives run on the default process group. Gloo moves CPU tensors
only (and two ranks sharing one card must use it), so there a CUDA tensor
goes through the host; NCCL takes it as it is. Every payload crosses as
bytes, whatever its dtype. ``stats`` counts the exchanges, the gathers
and the bytes each rank receives.
"""
import dataclasses
import logging

import torch
import torch.distributed as dist

logger = logging.getLogger('base')

# this process's collectives since the last reset_stats(): halo exchanges,
# gathers and all-reduces, and the bytes received through each
stats = {}


def reset_stats():
    stats.update(halo_exchanges=0, halo_bytes=0, gathers=0, gather_bytes=0,
                 allreduces=0)


reset_stats()


@dataclasses.dataclass(frozen=True)
class Band:
    """Rank ``rank``'s rows of an axis split at ``bounds``: rank k owns
    rows ``[bounds[k], bounds[k + 1])``, and ``bounds[-1]`` is the axis's
    length."""
    rank: int
    bounds: tuple

    @property
    def world(self):
        return len(self.bounds) - 1

    @property
    def row0(self):
        return self.bounds[self.rank]

    @property
    def stop(self):
        return self.bounds[self.rank + 1]

    @property
    def rows(self):
        return self.stop - self.row0

    @property
    def total(self):
        return self.bounds[-1]

    def sizes(self):
        """Every rank's rows, in rank order."""
        return [b - a for a, b in zip(self.bounds, self.bounds[1:])]

    def scaled(self, factor):
        """The band at ``factor`` times the rows; raises where a boundary
        would fall inside a row."""
        vals = [v * factor for v in self.bounds]
        if any(v != int(v) for v in vals):
            raise ValueError(f'{self} does not scale by {factor}')
        return dataclasses.replace(self, bounds=tuple(int(v) for v in vals))

    def take(self, x):
        """The band's rows of a whole NHWC tensor at this scale."""
        return x[:, self.row0:self.stop]


_logged_whole = set()


def band_for(h, rank, world):
    """The LR band of rank ``rank`` for an LR height ``h``: rank r owns
    rows ``[floor(r h / world), floor((r + 1) h / world))``. None (every
    rank computes the whole image) at world size 1, or where the bands
    would be under 2 rows; that is logged once a shape."""
    if world <= 1:
        return None
    if h // world < 2:
        if (h, world) not in _logged_whole:
            _logged_whole.add((h, world))
            logger.warning(f'val_spatial_shard: LR height {h} does not '
                           f'split into {world} bands of at least 2 rows; '
                           'every rank computes the whole image')
        return None
    return Band(rank, tuple(r * h // world for r in range(world + 1)))


def _comm_device(x):
    """Where ``x`` crosses: NCCL takes CUDA tensors, gloo host ones."""
    if dist.get_backend() == 'nccl':
        return x.device
    return torch.device('cpu')


def _all_gather(x):
    """[every rank's ``x``] in rank order, ``x``'s shape the same on all."""
    x = x.contiguous()
    payload = x.reshape(-1).view(torch.uint8).to(_comm_device(x))
    parts = [torch.empty_like(payload)
             for _ in range(dist.get_world_size())]
    dist.all_gather(parts, payload)
    return [p.to(x.device).view(x.dtype).view(x.shape) for p in parts]


def exchange_halo(x, band, above, below):
    """(B, above + rows + below, W, C): the band ``x`` (B, rows, W, C) with
    the last ``above`` rows of the band above it and the first ``below``
    rows of the band below it, zero rows past the image's top and bottom.
    One all-gather of every rank's edge rows."""
    if max(above, below) > min(band.sizes()):
        raise ValueError(f'a halo of {above} and {below} rows from bands of '
                         f'{band.sizes()}')
    edges = torch.cat([x[:, :below], x[:, x.shape[1] - above:]], dim=1)
    parts = _all_gather(edges)
    r, last = band.rank, band.world - 1
    rest = tuple(x.shape[2:])
    up = (parts[r - 1][:, below:] if r > 0
          else x.new_zeros((x.shape[0], above) + rest))
    down = (parts[r + 1][:, :below] if r < last
            else x.new_zeros((x.shape[0], below) + rest))
    stats['halo_exchanges'] += 1
    stats['halo_bytes'] += ((r > 0) * up.numel() + (r < last)
                            * down.numel()) * x.element_size()
    return torch.cat([up, x, down], dim=1)


def gather_rows(x, band):
    """The whole (B, H, W, C) image of the bands ``x`` (B, rows, W, C),
    all-gathered along H; ``x`` may hold the band at any whole multiple
    of its rows. Each rank sends its rows padded to the largest band's."""
    band = band.scaled(x.shape[1] // band.rows)
    sizes = band.sizes()
    pad = max(sizes) - band.rows
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
    parts = _all_gather(x)
    stats['gathers'] += 1
    stats['gather_bytes'] += (band.world - 1) * x.numel() * x.element_size()
    return torch.cat([p[:, :n] for p, n in zip(parts, sizes)], dim=1)


def allreduce_sum(t):
    """The sum over the ranks of ``t``; world size 1 or no process group:
    ``t``."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t
    out = t.detach().clone().to(_comm_device(t))
    dist.all_reduce(out)
    stats['allreduces'] += 1
    return out.to(t.device)
