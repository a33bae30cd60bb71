"""Network architectures of the port (NHWC modules with the reference's
torch state-dict names)."""
from .corres_generation_arch import CorrespondenceGenerationArch
from .dcn_arch import DCN, DCNSep, DCNv2Module
from .discriminator_arch import ImageDiscriminator
from .ref_restoration_arch import (ContentExtractor, DynAgg,
                                   DynamicAggregationRestoration,
                                   RestorationNet)
from .vgg_arch import (ContrasExtractorLayer, ContrasExtractorSep,
                       VGGFeatureExtractor)

ARCHS = {cls.__name__: cls for cls in (
    ContrasExtractorSep, CorrespondenceGenerationArch, DCNSep,
    ImageDiscriminator, RestorationNet, VGGFeatureExtractor)}

__all__ = [
    'ARCHS', 'ContentExtractor', 'ContrasExtractorLayer',
    'ContrasExtractorSep', 'CorrespondenceGenerationArch', 'DCN', 'DCNSep',
    'DCNv2Module', 'DynAgg',
    'DynamicAggregationRestoration', 'ImageDiscriminator', 'RestorationNet',
    'VGGFeatureExtractor',
]
