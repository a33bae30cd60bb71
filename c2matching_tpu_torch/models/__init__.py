"""Models of the port.

``create_model`` is the counterpart of
``c2matching_tpu/models/__init__.py::create_model``: the YAML
``model_type`` names the class.
"""
import logging

from .networks import define_network
from .ref_restoration_model import RefRestorationModel
from .sr_model import SRModel
from .student_contras_distillation_model import \
    StudentContrasDistillationModel
from .teacher_contras_model import TeacherContrasModel

logger = logging.getLogger('base')

MODELS = {'RefRestorationModel': RefRestorationModel,
          'SRModel': SRModel,
          'TeacherContrasModel': TeacherContrasModel,
          'StudentContrasDistillationModel': StudentContrasDistillationModel}


def create_model(opt, device='cuda'):
    """The model ``opt['model_type']`` names, on ``device`` (the card unless
    the caller asks for another)."""
    kind = opt['model_type']
    if kind not in MODELS:
        raise ValueError(f'model type {kind!r} is not ported; the port has '
                         f'{sorted(MODELS)}')
    model = MODELS[kind](opt, device)
    logger.info(f'Model [{model.__class__.__name__}] is created.')
    return model


__all__ = ['MODELS', 'RefRestorationModel', 'SRModel',
           'StudentContrasDistillationModel', 'TeacherContrasModel',
           'create_model', 'define_network']
