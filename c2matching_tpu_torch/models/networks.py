"""Network constructor.

Counterpart of ``c2matching_tpu/models/networks.py``: instantiate the
class a YAML block names (``type``) with the block's other keys as
keyword arguments, None-valued keys dropped. ``dtype`` (e.g.
``bfloat16``) is every block's conv compute dtype, as in the JAX package;
parameters stay float32.
"""
from .archs import ARCHS

# network-block keys that only tune XLA compilation in the JAX package
_XLA_ONLY_KEYS = ('trunk_unroll',)


def define_network(opt_net, generator=None):
    """Instantiate the net a YAML-style block names: {'type': ..., kwargs}.
    ``generator`` draws the random init."""
    opt_net = dict(opt_net)
    kind = opt_net.pop('type')
    if kind not in ARCHS:
        raise ValueError(f'network type {kind!r} is not ported; the port has '
                         f'{sorted(ARCHS)}')
    kwargs = {k: v for k, v in opt_net.items()
              if v is not None and k not in _XLA_ONLY_KEYS}
    return ARCHS[kind](**kwargs, generator=generator)
