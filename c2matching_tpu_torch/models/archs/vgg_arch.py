"""VGG feature extractors (NHWC).

Counterpart of ``c2matching_tpu/models/archs/vgg_arch.py``. Parameter and
buffer names follow the reference (``vgg_net.{name}.*`` and ``mean`` /
``std`` for VGGFeatureExtractor, ``model.{name}.*`` and ``mean`` / ``std``
for ContrasExtractorLayer), so its state dicts load with strict=True.
``dtype`` (None is float32) is the compute dtype of the convs, as in the JAX
package; the input normalisation stays in the input's dtype. ``band`` (a
``parallel.Band``): the input is one rank's horizontal band, whose
boundaries fall on multiples of 4 rows, so that the 2x2 pools of the
eval path's prefixes (to relu3_1) split at band boundaries.
"""
import torch
import torch.nn.functional as F
from torch import nn

from .arch_util import conv

# Layer name sequences per VGG variant.
NAMES = {
    'vgg11': [
        'conv1_1', 'relu1_1', 'pool1', 'conv2_1', 'relu2_1', 'pool2',
        'conv3_1', 'relu3_1', 'conv3_2', 'relu3_2', 'pool3', 'conv4_1',
        'relu4_1', 'conv4_2', 'relu4_2', 'pool4', 'conv5_1', 'relu5_1',
        'conv5_2', 'relu5_2', 'pool5'
    ],
    'vgg13': [
        'conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
        'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
        'conv3_2', 'relu3_2', 'pool3', 'conv4_1', 'relu4_1', 'conv4_2',
        'relu4_2', 'pool4', 'conv5_1', 'relu5_1', 'conv5_2', 'relu5_2',
        'pool5'
    ],
    'vgg16': [
        'conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
        'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
        'conv3_2', 'relu3_2', 'conv3_3', 'relu3_3', 'pool3', 'conv4_1',
        'relu4_1', 'conv4_2', 'relu4_2', 'conv4_3', 'relu4_3', 'pool4',
        'conv5_1', 'relu5_1', 'conv5_2', 'relu5_2', 'conv5_3', 'relu5_3',
        'pool5'
    ],
    'vgg19': [
        'conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
        'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
        'conv3_2', 'relu3_2', 'conv3_3', 'relu3_3', 'conv3_4', 'relu3_4',
        'pool3', 'conv4_1', 'relu4_1', 'conv4_2', 'relu4_2', 'conv4_3',
        'relu4_3', 'conv4_4', 'relu4_4', 'pool4', 'conv5_1', 'relu5_1',
        'conv5_2', 'relu5_2', 'conv5_3', 'relu5_3', 'conv5_4', 'relu5_4',
        'pool5'
    ],
}

_BLOCK_CHANNELS = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}

# ImageNet normalization for [0, 1] inputs.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_layer_prefix(vgg_type, last_layer):
    """The layer-name prefix up to and including ``last_layer``."""
    names = NAMES[vgg_type]
    return names[:names.index(last_layer) + 1]


def _vgg_convs(names, generator, dtype=None):
    """A ModuleDict of the convs among ``names``, He-normal initialized,
    computing in ``dtype``."""
    layers, cin = {}, 3
    for name in names:
        if name.startswith('conv'):
            cout = _BLOCK_CHANNELS[int(name[4])]
            layers[name] = conv(cin, cout, generator, std=None, dtype=dtype)
            cin = cout
    return nn.ModuleDict(layers)


def _imagenet_buffers(module):
    """The reference's persistent (1, 3, 1, 1) ``mean`` / ``std`` buffers."""
    module.register_buffer(
        'mean', torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1))
    module.register_buffer('std', torch.tensor(IMAGENET_STD).view(1, 3, 1, 1))


def _normalize(module, x):
    return (x - module.mean.view(1, 1, 1, 3).to(x.dtype)) \
        / module.std.view(1, 1, 1, 3).to(x.dtype)


def _run(convs, names, x, wanted=None, band=None, pooling_stride=2):
    """Run the layer sequence ``names``; ``band`` halves at every 2x2 pool.
    ``pooling_stride``: the stride of the 2x2 max pools (None: no pools).
    Returns the dict of ``wanted`` activations, or the last one when
    ``wanted`` is None."""
    if pooling_stride != 2 and band is not None:
        # a size-2 pool of another stride does not split at band
        # boundaries (its windows straddle them)
        raise NotImplementedError(
            'a band is only defined for pooling_stride=2, got '
            f'{pooling_stride}')
    output = {}
    for name in names:
        if name.startswith('conv'):
            x = convs[name](x, band)
        elif name.startswith('relu'):
            x = F.relu(x)
        elif name.startswith('pool'):
            if pooling_stride is None:
                continue
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2,
                             stride=pooling_stride).permute(0, 2, 3, 1)
            if band is not None:
                band = band.scaled(1 / 2)
        if wanted is not None and name in wanted:
            output[name] = x
    return x if wanted is None else output


class VGGFeatureExtractor(nn.Module):
    """Truncated VGG returning a dict of named activations; only the layers
    up to the deepest requested one exist. ``use_input_norm``: inputs are
    ImageNet-normalized (the ``mean`` / ``std`` buffers exist only then,
    as in the reference); ``remove_pooling`` drops the max pools;
    ``pooling_stride`` is their stride (a band takes only 2)."""

    def __init__(self, layer_name_list, vgg_type='vgg19', use_input_norm=True,
                 remove_pooling=False, pooling_stride=2, generator=None,
                 dtype=None):
        super().__init__()
        self.layer_name_list = list(layer_name_list)
        self.use_input_norm = use_input_norm
        self.pooling_stride = None if remove_pooling else pooling_stride
        names = NAMES[vgg_type]
        last = max(names.index(v) for v in self.layer_name_list)
        self.names = names[:last + 1]
        self.vgg_net = _vgg_convs(self.names, generator, dtype)
        if use_input_norm:
            _imagenet_buffers(self)

    def forward(self, x, band=None):
        """x: (B, H, W, 3) RGB in [0, 1]. Returns {layer_name: feature}.
        ``band``: x is that band of the image, and so is each feature."""
        if self.use_input_norm:
            x = _normalize(self, x)
        return _run(self.vgg_net, self.names, x,
                    wanted=set(self.layer_name_list), band=band,
                    pooling_stride=self.pooling_stride)


class ContrasExtractorLayer(nn.Module):
    """VGG16 prefix up to and including conv3_1 (pre-activation output),
    with ImageNet input normalization."""

    def __init__(self, generator=None, dtype=None):
        super().__init__()
        self.names = vgg_layer_prefix('vgg16', 'conv3_1')
        self.model = _vgg_convs(self.names, generator, dtype)
        _imagenet_buffers(self)

    def forward(self, x, band=None):
        return _run(self.model, self.names, _normalize(self, x), band=band)


class ContrasExtractorSep(nn.Module):
    """Two separate (non-shared) contrastive extractors, for the input and
    for the reference."""

    def __init__(self, generator=None, dtype=None):
        super().__init__()
        self.feature_extraction_image1 = ContrasExtractorLayer(generator,
                                                               dtype)
        self.feature_extraction_image2 = ContrasExtractorLayer(generator,
                                                               dtype)

    def forward(self, image1, image2, band=None):
        """``band``: both images are that band, and so are the features."""
        return {
            'dense_features1': self.feature_extraction_image1(image1, band),
            'dense_features2': self.feature_extraction_image2(image2, band),
        }
