"""Convert the JAX package's flax parameters into the port's state dicts.

The exact inverse of ``c2matching_tpu/utils/pth_import.py``: flax HWIO
conv kernels become torch OIHW; the scan-stacked ``blocks/block/conv{j}``
(n, ...) leaves of a residual trunk become ``{prefix}.{i}.conv{j}``; the
DCN weight (K, Ci, Co) becomes (Co, Ci, 3, 3). The keys are the
reference's torch state-dict names, which the port's modules carry, so
the result loads with ``load_state_dict(strict=True)``; saved with
``torch.save`` it is also a reference-format ``.pth`` that ``pth_import``
reads back bit for bit.

Inputs are flax parameter trees (nested dicts) whose leaves are numpy
arrays or anything ``np.asarray`` takes; a variables dict with a
'params' entry is accepted too.
"""
import numpy as np
import torch

from ..models.archs.vgg_arch import IMAGENET_MEAN, IMAGENET_STD, NAMES


def _params(tree):
    return tree['params'] if 'params' in tree else tree


def _tensor(a):
    return torch.from_numpy(np.array(a))


def _conv(out, key, leaf):
    """A flax conv {'kernel' (kh, kw, Ci, Co), 'bias'} -> key.weight/.bias."""
    out[f'{key}.weight'] = _tensor(np.transpose(np.asarray(leaf['kernel']),
                                                (3, 2, 0, 1)))
    out[f'{key}.bias'] = _tensor(leaf['bias'])


def _res_stack(out, prefix, stack):
    """Scan-stacked {'blocks': {'block': {'conv{j}': (n, ...)}}} ->
    {prefix}.{i}.conv{j}.*"""
    block = stack['blocks']['block']
    n = np.asarray(block['conv1']['kernel']).shape[0]
    for i in range(n):
        for name in ('conv1', 'conv2'):
            leaf = block[name]
            _conv(out, f'{prefix}.{i}.{name}',
                  {'kernel': np.asarray(leaf['kernel'])[i],
                   'bias': np.asarray(leaf['bias'])[i]})


def _imagenet(out, prefix):
    out[f'{prefix}.mean'] = torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    out[f'{prefix}.std'] = torch.tensor(IMAGENET_STD).view(1, 3, 1, 1)


def restoration_net_state_dict(tree):
    """RestorationNet flax params -> the port's (and the reference's) state
    dict."""
    p = _params(tree)
    out = {}
    ce = p['content_extractor']
    _conv(out, 'content_extractor.conv_first', ce['conv_first'])
    _res_stack(out, 'content_extractor.body', ce['body'])
    dyn = p['dyn_agg_restore']
    for scale in ('small', 'medium', 'large'):
        pre = f'dyn_agg_restore.{scale}'
        _conv(out, f'{pre}_offset_conv1', dyn[f'{scale}_offset_conv1'])
        _conv(out, f'{pre}_offset_conv2', dyn[f'{scale}_offset_conv2'])
        agg = dyn[f'{scale}_dyn_agg']
        weight = np.asarray(agg['weight'])                 # (K, Ci, Co)
        k, ci, co = weight.shape
        kh = int(round(k ** 0.5))
        out[f'{pre}_dyn_agg.weight'] = _tensor(
            np.transpose(weight.reshape(kh, k // kh, ci, co), (3, 2, 0, 1)))
        out[f'{pre}_dyn_agg.bias'] = _tensor(agg['bias'])
        _conv(out, f'{pre}_dyn_agg.conv_offset_mask', agg['conv_offset_mask'])
        _conv(out, f'dyn_agg_restore.head_{scale}.0', dyn[f'head_{scale}'])
        _res_stack(out, f'dyn_agg_restore.body_{scale}', dyn[f'body_{scale}'])
        if scale != 'large':
            _conv(out, f'dyn_agg_restore.tail_{scale}.0',
                  dyn[f'tail_{scale}'])
    _conv(out, 'dyn_agg_restore.tail_large.0', dyn['tail_large_conv1'])
    _conv(out, 'dyn_agg_restore.tail_large.2', dyn['tail_large_conv2'])
    return out


def contras_extractor_state_dict(tree):
    """ContrasExtractorSep flax params -> state dict."""
    p = _params(tree)
    out = {}
    for branch in ('feature_extraction_image1', 'feature_extraction_image2'):
        _imagenet(out, branch)
        for name, leaf in p[branch].items():
            _conv(out, f'{branch}.model.{name}', leaf)
    return out


def corres_generation_state_dict(tree):
    """CorrespondenceGenerationArch flax params (its VGG19) -> state dict."""
    p = _params(tree)
    out = {}
    _imagenet(out, 'vgg')
    for name, leaf in p['vgg'].items():
        _conv(out, f'vgg.vgg_net.{name}', leaf)
    return out


def torchvision_vgg_state_dict(tree, vgg_type='vgg19'):
    """VGGFeatureExtractor flax params (or CorrespondenceGenerationArch's,
    whose VGG sits under 'vgg') -> a torchvision VGG state dict,
    ``features.{i}.weight`` / ``.bias`` with i the layer's index in
    NAMES[vgg_type]: the file ``path.pretrain_model_vgg`` names."""
    p = _params(tree)
    p = p.get('vgg', p)
    out = {}
    for idx, name in enumerate(NAMES[vgg_type]):
        if name in p:
            _conv(out, f'features.{idx}', p[name])
    return out


def discriminator_state_dict(variables):
    """ImageDiscriminator flax variables ('params' and 'batch_stats') ->
    the reference's state dict: ``conv_block{i}.{0,3}`` convs and
    ``conv_block{i}.{1,4}`` BatchNorms with their running statistics, and
    the ``out_block.{1,3}`` 1x1 convs."""
    p = variables['params']
    stats = variables['batch_stats']
    out = {}
    for i in range(1, 6):
        for j, (conv_idx, bn_idx) in enumerate(((0, 1), (3, 4)), start=1):
            _conv(out, f'conv_block{i}.{conv_idx}', p[f'block{i}_conv{j}'])
            bn = f'conv_block{i}.{bn_idx}'
            leaf = p[f'block{i}_bn{j}']
            out[f'{bn}.weight'] = _tensor(leaf['scale'])
            out[f'{bn}.bias'] = _tensor(leaf['bias'])
            out[f'{bn}.running_mean'] = _tensor(
                stats[f'block{i}_bn{j}']['mean'])
            out[f'{bn}.running_var'] = _tensor(stats[f'block{i}_bn{j}']['var'])
            out[f'{bn}.num_batches_tracked'] = torch.tensor(0)
    _conv(out, 'out_block.1', p['out_conv1'])
    _conv(out, 'out_block.3', p['out_conv2'])
    return out


def dcn_state_dict(tree):
    """DCNv2Module / DCN / DCNSep flax params -> state dict: the weight
    (9, Cin, Cout) as (Cout, Cin, 3, 3), the bias and, where the module has
    one, ``conv_offset_mask``."""
    p = _params(tree)
    weight = np.asarray(p['weight'])
    k, ci, co = weight.shape
    out = {'weight': _tensor(np.transpose(weight.reshape(3, k // 3, ci, co),
                                          (3, 2, 0, 1))),
           'bias': _tensor(p['bias'])}
    if 'conv_offset_mask' in p:
        _conv(out, 'conv_offset_mask', p['conv_offset_mask'])
    return out


def _spectral_conv(out, key, leaf, stats):
    """A SpectralNormConv's kernel and bias (``weight_orig``, ``bias``) and
    its power-iteration pair (``weight_u``, ``weight_v``): flax's v runs
    over the kernel's (ky, kx, Cin) flattening, torch's over (Cin, ky,
    kx)."""
    kernel = np.asarray(leaf['kernel'])
    kh, kw, ci, _ = kernel.shape
    out[f'{key}.weight_orig'] = _tensor(np.transpose(kernel, (3, 2, 0, 1)))
    out[f'{key}.bias'] = _tensor(leaf['bias'])
    out[f'{key}.weight_u'] = _tensor(stats['u'])
    out[f'{key}.weight_v'] = _tensor(np.transpose(
        np.asarray(stats['v']).reshape(kh, kw, ci), (2, 0, 1)).reshape(-1))


def residual_block_state_dict(variables):
    """A standalone ResidualBlockNoBN's flax variables -> state dict; with
    ``sn`` ('spectral_stats' present) each conv is a SpectralNormConv."""
    p = _params(variables)
    stats = variables.get('spectral_stats') if 'params' in variables \
        else None
    out = {}
    for name in ('conv1', 'conv2'):
        if stats is not None:
            _spectral_conv(out, name, p[name], stats[name])
        else:
            _conv(out, name, p[name])
    return out


def residual_block_bn_state_dict(variables):
    """ResidualBlockWithBN flax variables ('params' and 'batch_stats') ->
    state dict, the running statistics into ``running_mean`` /
    ``running_var``."""
    p = variables['params']
    stats = variables['batch_stats']
    out = {}
    for conv_name, bn in (('conv1', 'bn1'), ('conv2', 'bn2')):
        _conv(out, conv_name, p[conv_name])
        out[f'{bn}.weight'] = _tensor(p[bn]['scale'])
        out[f'{bn}.bias'] = _tensor(p[bn]['bias'])
        out[f'{bn}.running_mean'] = _tensor(stats[bn]['mean'])
        out[f'{bn}.running_var'] = _tensor(stats[bn]['var'])
        out[f'{bn}.num_batches_tracked'] = torch.tensor(0)
    return out


def upsample_state_dict(tree):
    """Upsample flax params (``conv{i}``) -> state dict (the convs at the
    even indices of its ``nn.Sequential``)."""
    p = _params(tree)
    out = {}
    for i in range(len(p)):
        _conv(out, str(2 * i), p[f'conv{i}'])
    return out


def upsample_shuffle_state_dict(tree):
    """UpsampleShuffle flax params -> state dict."""
    out = {}
    _conv(out, 'conv', _params(tree)['conv'])
    return out
