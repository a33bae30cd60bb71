"""Models of the port."""
from .ref_restoration_model import RefRestorationModel, define_network

__all__ = ['RefRestorationModel', 'define_network']
