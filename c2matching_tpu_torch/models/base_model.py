"""Base model: device and weight loading.

Counterpart of the evaluation half of ``c2matching_tpu/models/
base_model.py``: ``load_network`` reads the reference's ``.pth`` state
dicts (a 'state_dict' wrapper and 'module.' prefixes are stripped) under
``path.strict_load``. The JAX package's flax ``.ckpt`` files wait for the
train checkpoints.
"""
import logging

import torch

logger = logging.getLogger('base')


def load_state_dict_file(path):
    """The state dict of a reference ``.pth`` file, on the CPU."""
    if not str(path).endswith('.pth'):
        raise ValueError(f'{path}: the port loads .pth state dicts only '
                         '(flax .ckpt files are not ported yet)')
    state = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(state, dict) and 'state_dict' in state:
        state = state['state_dict']
    return {k[7:] if k.startswith('module.') else k: v
            for k, v in state.items()}


class BaseModel:
    """Shared infrastructure of the port's models.

    ``device``: where the nets run. Raises when it names a CUDA device on
    a host without one: no silent fall-back to the CPU.
    """

    def __init__(self, opt, device='cuda'):
        self.opt = opt
        self.is_train = bool(opt.get('is_train'))
        if self.is_train:
            raise NotImplementedError('training is not ported yet')
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                f'device {self.device} asked for, but no CUDA card is '
                "available; pass device='cpu' to run on the CPU")

    def load_network(self, net, path, strict=True):
        """Load a ``.pth`` state dict into ``net``. With ``strict`` every key
        must match; otherwise the missing and unexpected keys are logged."""
        logger.info(f'Loading {net.__class__.__name__} model from {path}.')
        self.load_state(net, load_state_dict_file(path), strict)

    @staticmethod
    def load_state(net, state, strict=True):
        result = net.load_state_dict(state, strict=strict)
        for key in result.missing_keys:
            logger.warning(f'missing key in checkpoint: {key}')
        for key in result.unexpected_keys:
            logger.warning(f'unexpected key in checkpoint: {key}')
