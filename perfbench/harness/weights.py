"""Seeded weights, made on the device in one draw.

Every weight of a configuration is cut from one ``torch.randn`` of the
total count on the card, from a ``torch.Generator`` there seeded with the
run's seed, then scaled by the benchmark's own rule, which keeps
activations near unit scale through the published depths:

- VGG and extractor convs: normal(0, sqrt(2 / fan_in)) (He);
- the restoration net's convs, DCN weights and offset convs:
  normal(0, 0.5 / sqrt(fan_in)), so the learned offsets are a fraction of
  a pixel and the masks vary;
- D's convs: normal(0, sqrt(2 / fan_in)); its BatchNorm scales
  1 + normal(0, 0.1), shifts normal(0, 0.1);
- every bias: normal(0, 0.01).

The names are the upstream state-dict names, so the same dict loads into
the package under test and feeds the plain reference.
"""
import math

import torch


def _std(name, shape):
    if len(shape) == 1:
        if '.bias' in name:
            is_bn = name.startswith('net_d.') and name.split('.')[-2] in (
                '1', '4') and 'conv_block' in name
            return 0.1 if is_bn else 0.01
        return 0.1          # BatchNorm scale, around 1
    fan_in = math.prod(shape[1:])
    if name.startswith('net_g.'):
        return 0.5 / math.sqrt(fan_in)
    return math.sqrt(2.0 / fan_in)


def _offset(name, shape):
    is_bn_scale = (len(shape) == 1 and name.endswith('.weight'))
    return 1.0 if is_bn_scale else 0.0


def make_weights(shapes, seed, device):
    """{name: float32 tensor} for ``shapes`` ({name: shape}), drawn from
    ``seed`` on ``device``; the same seed gives the same weights."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for name, piece in zip(names, torch.split(flat, sizes)):
        shape = tuple(shapes[name])
        out[name] = piece.view(shape) * _std(name, shape) \
            + _offset(name, shape)
    return out


def load_into(module, weights, prefix):
    """Copy the ``prefix``-named weights into ``module``'s parameters of
    the same names (without the prefix); every parameter must be given."""
    params = dict(module.named_parameters())
    given = {k[len(prefix):]: v for k, v in weights.items()
             if k.startswith(prefix)}
    missing = sorted(set(params) - set(given))
    extra = sorted(set(given) - set(params))
    if missing or extra:
        raise KeyError(f'{prefix}: weights missing for {missing[:5]}, '
                       f'unknown {extra[:5]}')
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(given[name].shape):
                raise ValueError(f'{prefix}{name}: shape {tuple(p.shape)} '
                                 f'against {tuple(given[name].shape)}')
            p.copy_(given[name])
