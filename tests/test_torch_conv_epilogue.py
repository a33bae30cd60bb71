"""The conv epilogue (``ops/conv_epilogue.py``, ``csrc/conv_epilogue.cu``)
and the convs that run it (``archs/arch_util.py::Conv2d``).

On the CPU:

- the operator, which takes the plain version there, equals the unfused
  sequence bit for bit (the bias add, ``F.relu`` or ``arch_util.lrelu``,
  then ``residual + out``), in float32 and bfloat16, for each activation,
  with and without a residual, at C 3, 32, 64, 216 and 256, with a NaN
  and a -0.0 among the inputs; it refuses operands the kernel does not
  take, and ``opcheck`` holds its schema, fake and mutation;
- ``ResidualBlockNoBN`` (res_scale 1 and 0.5; a 1 x 2 image, whose 3x3
  taps read the zero padding almost alone),
  ``ContentExtractor`` and ``RestorationNet`` at reduced widths, biases
  drawn, give equal outputs under ``inference_mode`` (the fused path) and
  under autograd (the graph path); a serving forward counts no
  ``Conv2d.graph_epilogues`` and a training forward no
  ``Conv2d.fused_epilogues``.

On a CUDA card (marker ``card``: ``python -m pytest --noconftest
tests/test_torch_conv_epilogue.py -m card``): the kernel equals the plain
version at the serving shapes (16 x 84 x 128, 16 x 168 x 256 and
16 x 336 x 512 pixels at C 64, 128, 216, 256 and 3), on unaligned
operands, and the two paths of a full-width net agree bit for bit in
float32 and bfloat16; a batch-16 serving request launches the kernel once
a conv, with no refusal.
"""
import copy
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.models.archs import RestorationNet
from c2matching_tpu_torch.models.archs.arch_util import (Conv2d,
                                                         ResidualBlockNoBN,
                                                         lrelu)
from c2matching_tpu_torch.models.archs.ref_restoration_arch import \
    ContentExtractor
from c2matching_tpu_torch.ops import conv_epilogue, conv_epilogue_plain
from c2matching_tpu_torch.utils import options

REPO = Path(__file__).resolve().parents[1]
SERVING = REPO / 'options' / 'test' / 'test_C2_matching_serving.yml'
DTYPES = [torch.float32, torch.bfloat16]
ACTS = [None, 'relu', 'lrelu']
CHANNELS = [3, 32, 64, 216, 256]
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def unfused(y, bias, act, residual):
    """The sequence the epilogue replaces, out of place."""
    out = y + bias
    if act == 'relu':
        out = F.relu(out)
    elif act == 'lrelu':
        out = lrelu(out)
    return out if residual is None else residual + out


def _operands(shape, dtype, residual, device='cpu', seed=0):
    """y, bias and residual (or None) with a NaN, a -0.0 that meets a
    -0.0 bias, and values of both signs and many scales."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    y = torch.randn(shape, generator=gen, device=device) * torch.exp2(
        torch.randint(-8, 8, shape, generator=gen, device=device,
                      dtype=torch.float32))
    bias = torch.randn(c, generator=gen, device=device)
    flat = y.view(-1)
    flat[0] = -0.0
    bias[0] = -0.0
    flat[flat.numel() // 2] = float('nan')
    res = None
    if residual:
        res = torch.randn(shape, generator=gen, device=device).to(dtype)
    return y.to(dtype), bias.to(dtype), res


def same_bits(a, b):
    """Equal bit for bit, NaNs included where both compute them alike;
    else equal as values with NaN in the same places (a kernel's NaN may
    carry another payload)."""
    if torch.equal(a.view(_BITS[a.dtype]), b.view(_BITS[b.dtype])):
        return True
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.masked_fill(nan, 0), b.masked_fill(nan, 0)))


@pytest.mark.parametrize('c', CHANNELS)
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('act', ACTS)
@pytest.mark.parametrize('dtype', DTYPES)
def test_operator_equals_unfused_sequence(dtype, act, residual, c):
    y, bias, res = _operands((2, 5, 7, c), dtype, residual)
    want = unfused(y, bias, act, res)
    launches = conv_epilogue.launches
    got = y.clone()
    assert conv_epilogue(got, bias, act, res) is got
    assert torch.equal(got.view(_BITS[dtype]), want.view(_BITS[dtype]))
    assert torch.isnan(got).sum() == 1
    assert conv_epilogue.launches == launches    # no kernel on the CPU
    plain = conv_epilogue_plain(y.clone(), bias, act, res)
    assert torch.equal(plain.view(_BITS[dtype]), want.view(_BITS[dtype]))


def _refusals():
    y = torch.zeros(2, 4, 4, 8)
    b = torch.zeros(8)
    return {
        'float64 y': (y.double(), b.double(), 0, None),
        'bias dtype': (y, b.bfloat16(), 0, None),
        'bias shape': (y, torch.zeros(4), 0, None),
        'residual shape': (y, b, 0, torch.zeros(2, 4, 4, 1)),
        'residual dtype': (y, b, 1, y.bfloat16()),
        'act code': (y, b, 3, None),
        'non-contiguous y': (y.transpose(1, 2), b, 0, None),
        'non-contiguous residual': (y, b, 2, y.transpose(1, 2)),
    }


@pytest.mark.parametrize('case', list(_refusals()))
def test_operator_refuses(case):
    y, b, act, res = _refusals()[case]
    with pytest.raises((TypeError, ValueError)):
        torch.ops.c2matching.conv_epilogue(y, b, act, 0.1, res)


def test_wrapper_refuses_unknown_activation():
    with pytest.raises(ValueError):
        conv_epilogue(torch.zeros(1, 2, 2, 4), torch.zeros(4), 'gelu')


@pytest.mark.parametrize('dtype', DTYPES)
def test_opcheck(dtype):
    y, bias, res = _operands((2, 3, 4, 8), dtype, True)
    y = torch.nan_to_num(y)
    for act in range(3):
        torch.library.opcheck(torch.ops.c2matching.conv_epilogue,
                              (y.clone(), bias, act, 0.1, res))
    torch.library.opcheck(torch.ops.c2matching.conv_epilogue,
                          (y.clone(), bias, 2, 0.2, None))


def _draw_biases(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    return module


def _both_paths(module, *args, **kwargs):
    """The module's output without a graph and with one, and the
    counters' moves in each."""
    out = {}
    for path in ('fused', 'graph'):
        fused, graph = Conv2d.fused_epilogues, Conv2d.graph_epilogues
        if path == 'fused':
            with torch.inference_mode():
                y = module(*args, **kwargs)
        else:
            y = module(*args, **kwargs)
            assert y.requires_grad
        out[path] = (y.detach(), Conv2d.fused_epilogues - fused,
                     Conv2d.graph_epilogues - graph)
    return out


@pytest.mark.parametrize('hw,res_scale', [((9, 11), 1.0), ((1, 2), 1.0),
                                          ((9, 11), 0.5)])
def test_residual_block_paths_agree(hw, res_scale):
    gen = torch.Generator().manual_seed(3)
    block = _draw_biases(ResidualBlockNoBN(16, gen, res_scale=res_scale), 4)
    x = torch.randn(2, *hw, 16, generator=gen)
    out = _both_paths(block, x)
    assert torch.equal(out['fused'][0], out['graph'][0])
    assert out['fused'][1:] == (2, 0) and out['graph'][1:] == (0, 2)


def _odd_views():
    """NHWC inputs that are not plainly contiguous: an NCHW tensor's
    permuted view, and a batch of one whose batch stride is not the
    canonical one (as a NumPy array can hand over)."""
    gen = torch.Generator().manual_seed(11)
    nchw = torch.rand(2, 16, 9, 7, generator=gen)
    one = torch.rand(9, 7, 16, generator=gen)
    return {'permuted': nchw.permute(0, 2, 3, 1),
            'batch of one': one.as_strided((1, 9, 7, 16), (1, 112, 16, 1))}


@pytest.mark.parametrize('view', list(_odd_views()))
def test_conv_of_any_view_is_contiguous_nhwc(view):
    """The conv's output is contiguous NHWC whatever view its input is, so
    the fused path takes it; the paths agree."""
    x = _odd_views()[view]
    conv = _draw_biases(Conv2d(16, 8), 12)
    out = _both_paths(conv, x, act='lrelu', residual=None)
    assert out['fused'][0].is_contiguous()
    assert torch.equal(out['fused'][0], out['graph'][0])
    assert out['fused'][1:] == (1, 0)


def test_content_extractor_paths_agree():
    gen = torch.Generator().manual_seed(5)
    net = _draw_biases(ContentExtractor(16, 2, gen), 6)
    out = _both_paths(net, torch.rand(2, 12, 10, 3, generator=gen))
    assert torch.equal(out['fused'][0], out['graph'][0])
    assert out['fused'][1:] == (5, 0) and out['graph'][1:] == (0, 5)


def test_export_keeps_the_operator():
    """``torch.export`` of a residual block without a graph traces the
    operator, once a conv, and the program gives the eager output."""
    block = _draw_biases(ResidualBlockNoBN(8, torch.Generator().manual_seed(
        13)), 14).eval()
    x = torch.rand(2, 5, 6, 8, generator=torch.Generator().manual_seed(15))
    with torch.no_grad():
        program = torch.export.export(block, (x,))
        targets = [str(n.target) for n in program.graph.nodes
                   if n.op == 'call_function']
        assert targets.count('c2matching.conv_epilogue.default') == 2
        assert torch.equal(program.module()(x), block(x))


def _net_inputs(h, w, seed, device='cpu'):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(2, h, w, 3, generator=gen)
    pre, feat = {}, {}
    for key, s, c in (('relu3_1', 1, 256), ('relu2_1', 2, 128),
                      ('relu1_1', 4, 64)):
        pre[key] = torch.randint(-3, 4, (2, 9, h * s, w * s, 2),
                                 generator=gen).float().to(device)
        feat[key] = torch.randn(2, h * s, w * s, c,
                                generator=gen).to(device)
    return x.to(device), pre, feat


def _restoration_net(ngf, n_blocks, seed, dtype=None):
    gen = torch.Generator().manual_seed(seed)
    net = _draw_biases(RestorationNet(ngf=ngf, n_blocks=n_blocks, groups=8,
                                      generator=gen, dtype=dtype), seed + 1)
    with torch.no_grad():
        for scale in ('small', 'medium', 'large'):
            com = getattr(net.dyn_agg_restore,
                          f'{scale}_dyn_agg').conv_offset_mask
            com.weight.normal_(0.0, 0.05, generator=gen)
    return net.eval()


def test_restoration_net_paths_agree():
    """ngf 16, 2 blocks a scale: 1 + 2 * 2 convs in the extractor and
    4 + 2 * 2 + 1 a scale, one more at the last: 33 a forward."""
    net = _restoration_net(16, 2, 7)
    out = _both_paths(net, *_net_inputs(6, 5, 8))
    assert torch.equal(out['fused'][0], out['graph'][0])
    assert out['fused'][1:] == (33, 0) and out['graph'][1:] == (0, 33)


def test_serving_request_takes_the_fused_path_alone():
    """A request through a tiny serving model (the extractor's and the
    matcher's VGGs and the generator, on a padded bucket) counts no graph
    epilogue; every one of its convs is fused."""
    opt = options.load(SERVING)
    model_opt = {k: copy.deepcopy(opt[k]) for k in
                 ('network_g', 'network_map', 'network_extractor')}
    model_opt.update(manual_seed=0, crop_border=None, is_train=False)
    model_opt['network_g'].update(ngf=16, n_blocks=2)
    model = RefRestorationModel(model_opt, 'cpu')
    gen = torch.Generator().manual_seed(0)
    batch = {'img_in_lq': torch.rand(2, 16, 12, 3, generator=gen),
             'img_in_up': torch.rand(2, 64, 48, 3, generator=gen),
             'img_ref': torch.rand(2, 64, 48, 3, generator=gen)}
    fused, graph = Conv2d.fused_epilogues, Conv2d.graph_epilogues
    model.feed_data(batch)
    model.test()
    # generator 33, the two contrastive extractors 5 each, VGG19 to
    # relu3_1 5
    assert Conv2d.fused_epilogues - fused == 33 + 10 + 5
    assert Conv2d.graph_epilogues == graph


# --------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (on the card: python -m pytest '
                    '--noconftest tests/test_torch_conv_epilogue.py -m card)')
    return torch.device('cuda')


# the restoration net's pixels at batch 16 on the 128 x 84 valid crop
CARD_PIXELS = [(16, 84, 128), (16, 168, 256), (16, 336, 512)]
CARD_CHANNELS = [64, 128, 216, 256, 3]


@pytest.mark.card
@pytest.mark.parametrize('c', CARD_CHANNELS)
@pytest.mark.parametrize('pixels', CARD_PIXELS)
@pytest.mark.parametrize('dtype', DTYPES)
def test_card_kernel_equals_plain(card, dtype, pixels, c):
    y, bias, res = _operands(pixels + (c,), dtype, True, card, seed=c)
    for act in ACTS:
        for r in (None, res):
            want = conv_epilogue_plain(y.clone(), bias, act, r)
            launches = conv_epilogue.launches
            got = conv_epilogue(y.clone(), bias, act, r)
            torch.cuda.synchronize()
            assert conv_epilogue.launches == launches + 1
            assert same_bits(got, want), (act, r is not None)


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
def test_card_kernel_unaligned_and_small(card, dtype):
    """Operands off 16-byte alignment, and shapes smaller than a grid,
    take the element loop."""
    for shape in ((3, 5, 7, 64), (1, 1, 1, 8), (2, 3, 3, 216)):
        y, bias, res = _operands(shape, dtype, True, card, seed=1)
        n = y.numel()
        buf = torch.empty(n + 1, dtype=dtype, device=card)
        for act in ACTS:
            want = conv_epilogue_plain(y.clone(), bias, act, res)
            shifted = buf[1:].view(shape)
            shifted.copy_(y)
            conv_epilogue(shifted, bias, act, res)
            assert same_bits(shifted, want), (shape, act)


@pytest.mark.card
def test_card_kernel_refuses(card):
    y = torch.zeros(2, 4, 4, 8, device=card)
    b = torch.zeros(8, device=card)
    for args in ((y.transpose(1, 2), b, 0, None),
                 (y, b.cpu(), 0, None),
                 (y, b, 0, y)):
        with pytest.raises((TypeError, ValueError)):
            torch.ops.c2matching.conv_epilogue(args[0], args[1], args[2],
                                               0.1, args[3])


@pytest.mark.card
@pytest.mark.parametrize('dtype', [None, 'bfloat16'])
def test_card_net_paths_agree(card, dtype):
    """The full-width generator (ngf 64, 16 blocks) on a batch of 2 at LR
    32 x 24: the fused path equals the graph path bit for bit."""
    net = _restoration_net(64, 16, 9, dtype).to(card)
    out = _both_paths(net, *_net_inputs(32, 24, 10, card))
    assert torch.equal(out['fused'][0], out['graph'][0])
    assert out['fused'][1:] == (145, 0) and out['graph'][1:] == (0, 145)


@pytest.mark.card
def test_card_serving_batch_launches_once_a_conv(card):
    """A batch-16 request at HR 512 x 336 through the serving options at
    their widths: every conv takes the fused path, the kernel launches
    once for each, and nothing is refused (a refusal raises)."""
    opt = options.load(SERVING)
    model_opt = {k: copy.deepcopy(opt[k]) for k in
                 ('network_g', 'network_map', 'network_extractor')}
    model_opt.update(manual_seed=0, crop_border=None, is_train=False)
    model = RefRestorationModel(model_opt, card)
    gen = torch.Generator().manual_seed(0)
    batch = {'img_in_lq': torch.rand(16, 128, 84, 3, generator=gen),
             'img_in_up': torch.rand(16, 512, 336, 3, generator=gen),
             'img_ref': torch.rand(16, 512, 336, 3, generator=gen)}
    calls = []
    hooks = [m.register_forward_hook(lambda *_: calls.append(1))
             for m in model.net_g.modules() if isinstance(m, Conv2d)]
    hooks += [m.register_forward_hook(lambda *_: calls.append(0))
              for net in (model.net_extractor, model.net_map)
              for m in net.modules() if isinstance(m, Conv2d)]
    fused, graph = Conv2d.fused_epilogues, Conv2d.graph_epilogues
    launches = conv_epilogue.launches
    model.feed_data(batch)
    model.test()
    model.cropped_output()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert sum(calls) == 145 and len(calls) == 160
    assert Conv2d.fused_epilogues - fused == 160
    assert Conv2d.graph_epilogues == graph
    assert conv_epilogue.launches - launches == 160
