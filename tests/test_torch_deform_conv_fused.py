"""The fused forward of the modulated deformable conv
(``ops/deform_conv.py::deform_conv_fused``, ``csrc/deform_conv_fused.cu``)
and the shape predicate that sends a no-grad forward to it.

On the CPU:

- the operator, which takes its plain version there, equals the columns
  path it replaces (``_mdc_forward``: B3's columns per image, taken to f32,
  ``torch.matmul``, the stack, the bias) bit for bit, in float32 and
  bfloat16, at a band's negative top padding and with samples outside the
  image;
- ``fused_applicable`` sends the DynAgg shapes (3x3, stride 1, dilation 1,
  groups of whole 16-byte vectors) to the fused operator and other shapes
  (5x5 taps, stride 2, dilation 2, odd group widths, float64) to the
  columns; under ``no_grad`` exactly one operator runs a call;
- with grad enabled the fused operator never runs: the forward and every
  gradient equal ``_ModulatedDeformConv``'s bit for bit;
- ``torch.export`` traces ``c2matching::deform_conv_fused`` through its
  fake, and ``opcheck`` holds the operator's schema and fake.

On a CUDA card (marker ``card``: ``python -m pytest --noconftest
tests/test_torch_deform_conv_fused.py -m card``): the kernel against the
columns route on the card and against its plain version at the three DynAgg
shapes of the batch-16 serving request, at batch 1 and 16, in both dtypes, at a
band's padding, and on views of x and the offsets that start off the 16-byte
boundary (the operator copies them). Tolerance: 2e-5 of the output's largest
magnitude. Only the order of the sums differs from the columns route (the
kernel's columns are B3's to the bit; f32 products as 3xTF32, about 2^-22 of
each product); against the plain version a bf16 column may round the other way
where B3's fused multiply-add and the plain version's separate roundings
straddle a tie, which adds one bf16 ulp of the largest column times the largest
weight, twice.
"""
import importlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

dc = importlib.import_module('c2matching_tpu_torch.ops.deform_conv')

DTYPES = [torch.float32, torch.bfloat16]
# fused kernel vs the columns route on the card, of the output's largest
FUSED_REL = 2e-5


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(b, h, w, c, co, g, dtype, k=3, ho=None, wo=None, seed=0,
            spread=3.0, device='cpu'):
    """x, DynAgg-structured offsets (integer shifts plus a residual, some
    far outside the image), the mask, a (K, C, Co) weight and a bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ho = h if ho is None else ho
    wo = w if wo is None else wo
    taps = k * k
    x = torch.randn(b, h, w, c, generator=gen, device=device).to(dtype)
    shift = torch.randint(-4, 5, (b, ho, wo, 1, taps, 2), generator=gen,
                          device=device).float()
    offset = shift + spread * torch.randn(b, ho, wo, g, taps, 2,
                                          generator=gen, device=device)
    offset[:, 0, 0] = 1e4           # a whole pixel's taps outside the image
    mask = torch.rand(b, ho, wo, g, taps, generator=gen, device=device)
    weight = torch.randn(taps, c, co, generator=gen,
                         device=device) / (taps * c) ** 0.5
    bias = torch.randn(co, generator=gen, device=device)
    return x, offset.contiguous(), mask, weight, bias


def _w_kc(weight, dtype):
    """The weight as modulated_deform_conv hands it on: (K*C, Co), rounded
    to x's dtype, in f32."""
    k, c, co = weight.shape
    return weight.reshape(k * c, co).to(dtype).float()


class _Ops(TorchDispatchMode):
    """The names of the operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))

    def count(self, name):
        return self.names.count(name)


FUSED = 'c2matching.deform_conv_fused'
IM2COL = 'c2matching.deform_im2col'

# (B, H, W, C, Co, G, padding, Ho): the three DynAggs' group widths (8, 16
# and 32 channels), a band's rows at its negative top padding, Co off the
# 64-wide tiles
PLAIN_CASES = [(2, 9, 7, 64, 64, 8, (1, 1), None),
               (2, 6, 5, 128, 128, 8, (1, 1), None),
               (1, 5, 6, 256, 256, 8, (1, 1), None),
               (2, 10, 7, 64, 24, 8, (1 - 5, 1), 5),
               (3, 4, 9, 32, 40, 1, (2, 0), None)]


@pytest.mark.parametrize('case', PLAIN_CASES,
                         ids=['relu1', 'relu2', 'relu3', 'band', 'pad2x0'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_plain_equals_the_columns_path(dtype, case):
    b, h, w, c, co, g, padding, ho = case
    x, offset, mask, weight, bias = _inputs(b, h, w, c, co, g, dtype, ho=ho)
    w_kc = _w_kc(weight, dtype)
    conv = ((3, 3), (1, 1), padding, (1, 1))
    want = dc._mdc_forward(x, offset, mask, w_kc, bias, conv)
    got = dc.deform_conv_fused(x, offset, mask, w_kc, bias, *conv)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    # and the no-grad entry point takes it
    with torch.no_grad(), _Ops() as ops:
        out = dc.modulated_deform_conv(x, offset, mask, weight, bias,
                                       padding=padding)
    assert ops.count(FUSED) == 1 and ops.count(IM2COL) == 0
    assert torch.equal(out, want)
    # no bias
    assert torch.equal(
        dc.deform_conv_fused(x, offset, mask, w_kc, None, *conv),
        dc._mdc_forward(x, offset, mask, w_kc, None, conv))


def test_plain_outside_the_image_is_the_bias():
    x, offset, mask, weight, bias = _inputs(2, 6, 5, 64, 16, 8,
                                            torch.float32)
    offset = torch.full_like(offset, -1e4)
    offset[0, 1] = -3e7
    offset[1] = 1e6
    out = dc.deform_conv_fused(x, offset, mask, _w_kc(weight, x.dtype), bias)
    assert torch.equal(out, bias.expand_as(out))


# (what, B, H, W, C, G, dtype, conv kwargs, fused?)
ROUTES = [
    ('relu3 f32', 1, 6, 5, 256, 8, torch.float32, {}, True),
    ('relu2 bf16', 1, 6, 5, 128, 8, torch.bfloat16, {}, True),
    ('relu1 bf16 band', 1, 6, 5, 64, 8, torch.bfloat16,
     {'padding': (-2, 1)}, True),
    ('one-vector groups f32', 1, 6, 5, 32, 8, torch.float32, {}, True),
    ('5x5 taps', 1, 8, 8, 64, 8, torch.float32,
     {'kernel_size': (5, 5), 'padding': (2, 2)}, False),
    ('stride 2', 1, 8, 8, 64, 8, torch.float32, {'stride': (2, 2)}, False),
    ('dilation 2', 1, 8, 8, 64, 8, torch.float32,
     {'dilation': (2, 2), 'padding': (2, 2)}, False),
    ('groups of 3 f32', 1, 6, 5, 24, 8, torch.float32, {}, False),
    ('groups of 4 bf16', 1, 6, 5, 32, 8, torch.bfloat16, {}, False),
    ('float64', 1, 6, 5, 64, 8, torch.float64, {}, False),
]


@pytest.mark.parametrize('route', ROUTES, ids=[r[0] for r in ROUTES])
def test_predicate_routes_each_shape(route):
    _, b, h, w, c, g, dtype, conv, fused = route
    k = conv.get('kernel_size', (3, 3))[0]
    stride = conv.get('stride', (1, 1))[0]
    dil = conv.get('dilation', (1, 1))[0]
    pad = conv.get('padding', (1, 1))
    # a band's rows at its negative top padding: the rows it owns
    ho = (3 if pad[0] < 0 else
          (h + 2 * pad[0] - dil * (k - 1) - 1) // stride + 1)
    wo = (w + 2 * pad[1] - dil * (k - 1) - 1) // stride + 1
    x, offset, mask, weight, bias = _inputs(b, h, w, c, 16, g, dtype, k=k,
                                            ho=ho, wo=wo)
    assert dc.fused_applicable(x, offset, **{
        key: v for key, v in conv.items() if key != 'padding'}) == fused
    with torch.no_grad(), _Ops() as ops:
        out = dc.modulated_deform_conv(x, offset, mask, weight, bias, **conv)
    assert (ops.count(FUSED), ops.count(IM2COL)) == \
        ((1, 0) if fused else (0, b))
    assert out.shape == (b, ho, wo, 16)


@pytest.mark.parametrize('dtype', DTYPES)
def test_grad_never_takes_the_fused_operator(dtype):
    x, offset, mask, weight, bias = _inputs(2, 7, 6, 64, 16, 8, dtype,
                                            spread=1.0)
    args = [x.float().requires_grad_(), offset.requires_grad_(),
            mask.requires_grad_(), weight.requires_grad_(),
            bias.requires_grad_()]
    launches = dc.deform_conv_fused.launches
    with _Ops() as ops:
        out = dc.modulated_deform_conv(args[0].to(dtype), *args[1:],
                                       padding=(0, 1))
    assert ops.count(FUSED) == 0 and ops.count(IM2COL) == 2
    grads = torch.autograd.grad(out.square().sum(), args)
    assert dc.deform_conv_fused.launches == launches
    # today's path: the autograd Function called directly
    ref = [a.detach().clone().requires_grad_() for a in args]
    k, c, co = weight.shape
    want = dc._ModulatedDeformConv.apply(
        ref[0].to(dtype), ref[1], ref[2],
        ref[3].reshape(k * c, co).to(dtype).float(), ref[4],
        ((3, 3), (1, 1), (0, 1), (1, 1)))
    assert torch.equal(out, want)
    for got, exp in zip(grads, torch.autograd.grad(want.square().sum(),
                                                    ref)):
        assert torch.equal(got, exp)


def test_fused_operator_refuses_what_the_kernel_does_not_take():
    x, offset, mask, weight, bias = _inputs(1, 6, 5, 64, 16, 8,
                                            torch.float32)
    w_kc = _w_kc(weight, x.dtype)
    with pytest.raises(ValueError, match='K\\*C'):
        dc.deform_conv_fused(x, offset, mask, w_kc[:-1], bias)
    with pytest.raises(ValueError, match='bias'):
        dc.deform_conv_fused(x, offset, mask, w_kc, bias[:-1])
    with pytest.raises(ValueError, match='do not pair'):
        dc.deform_conv_fused(x, offset, mask[:, :-1], w_kc, bias)
    with pytest.raises(ValueError, match='unsupported device'):
        dc.deform_conv_fused(x.to('meta'), offset, mask, w_kc, bias)


class _Module(torch.nn.Module):
    def __init__(self, weight, bias, padding):
        super().__init__()
        self.weight = torch.nn.Parameter(weight)
        self.bias = torch.nn.Parameter(bias)
        self.padding = padding

    def forward(self, x, offset, mask):
        return dc.modulated_deform_conv(x, offset, mask, self.weight,
                                        self.bias, padding=self.padding)


@pytest.mark.parametrize('dtype', DTYPES)
def test_export_traces_the_fused_operator(dtype):
    x, offset, mask, weight, bias = _inputs(2, 7, 6, 64, 16, 8, dtype, ho=4)
    module = _Module(weight, bias, (1 - 3, 1))
    with torch.no_grad():
        program = torch.export.export(module, (x, offset, mask))
        want = module(x, offset, mask)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == 'call_function']
    assert targets.count('c2matching.deform_conv_fused.default') == 1
    assert 'c2matching.deform_im2col.default' not in targets
    assert torch.equal(program.module()(x, offset, mask), want)


@pytest.mark.parametrize('dtype', DTYPES)
def test_opcheck(dtype):
    x, offset, mask, weight, bias = _inputs(2, 5, 6, 32, 24, 4, dtype, ho=3)
    w_kc = _w_kc(weight, dtype)
    for b, padding in ((bias, [1, 1]), (None, [-1, 0])):
        torch.library.opcheck(torch.ops.c2matching.deform_conv_fused,
                              (x, offset, mask, w_kc, b, [3, 3], [1, 1],
                               padding, [1, 1]))


def test_no_launch_counted_on_cpu():
    x, offset, mask, weight, bias = _inputs(1, 5, 5, 64, 8, 8,
                                            torch.float32)
    n = dc.deform_conv_fused.launches
    dc.deform_conv_fused(x, offset, mask, _w_kc(weight, x.dtype), bias)
    assert dc.deform_conv_fused.launches == n


# --------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (on the card: python -m pytest '
                    '--noconftest tests/test_torch_deform_conv_fused.py -m '
                    'card)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


# the DynAggs of the HR 512x336 serving request: (H, W, C = Co)
CARD_SHAPES = [(128, 84, 256), (256, 168, 128), (512, 336, 64)]


def _card_check(x, offset, mask, weight, bias, padding=(1, 1)):
    w_kc = _w_kc(weight, x.dtype)
    conv = ((3, 3), (1, 1), padding, (1, 1))
    launches = dc.deform_conv_fused.launches
    got = dc.deform_conv_fused(x, offset, mask, w_kc, bias, *conv)
    torch.cuda.synchronize()
    assert dc.deform_conv_fused.launches == launches + 1
    route = dc._mdc_forward(x, offset, mask, w_kc, bias, conv)
    scale = route.abs().max().item()
    assert (got - route).abs().max().item() <= FUSED_REL * scale
    del route
    plain = dc.deform_conv_fused_plain(x, offset, mask, w_kc, bias, *conv)
    tol = FUSED_REL * plain.abs().max().item()
    if x.dtype == torch.bfloat16:
        tol += 2 * 2 ** -8 * x.float().abs().max().item() * \
            w_kc.abs().max().item()
    assert (got - plain).abs().max().item() <= tol


@pytest.mark.card
@pytest.mark.parametrize('batch', [1, 16])
@pytest.mark.parametrize('shape', CARD_SHAPES, ids=['relu3', 'relu2',
                                                    'relu1'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_card_kernel_at_the_dynagg_shapes(card, dtype, shape, batch):
    h, w, c = shape
    _card_check(*_inputs(batch, h, w, c, c, 8, dtype, spread=0.5,
                         device=card, seed=batch))


@pytest.mark.card
@pytest.mark.parametrize('shape', CARD_SHAPES, ids=['relu3', 'relu2',
                                                    'relu1'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_card_kernel_at_a_band(card, dtype, shape):
    """A band's rows: the lower half of the image at padding
    (1 - H / 2, 1), bit for bit the whole image's rows."""
    h, w, c = shape
    row0 = h // 2
    x, offset, mask, weight, bias = _inputs(2, h, w, c, c, 8, dtype,
                                            spread=0.5, device=card)
    band = (offset[:, row0:].contiguous(), mask[:, row0:].contiguous())
    _card_check(x, *band, weight, bias, padding=(1 - row0, 1))
    w_kc = _w_kc(weight, dtype)
    whole = dc.deform_conv_fused(x, offset, mask, w_kc, bias)
    part = dc.deform_conv_fused(x, *band, w_kc, bias, padding=(1 - row0, 1))
    assert torch.equal(part, whole[:, row0:])


def _shifted(t):
    """t's values in a view that starts one element into its storage, off
    the 16-byte and 8-byte boundaries."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
def test_card_kernel_on_unaligned_views(card, dtype):
    """x and the offsets as views one element into their storage: the
    shape is the kernel's, so a no-grad call still takes it, and the
    output is the aligned call's bit for bit."""
    x, offset, mask, weight, bias = _inputs(2, 40, 36, 64, 64, 8, dtype,
                                            spread=0.5, device=card)
    xs, offs = _shifted(x), _shifted(offset)
    assert xs.data_ptr() % 16 and offs.data_ptr() % 8
    _card_check(xs, offs, mask, weight, bias)
    w_kc = _w_kc(weight, dtype)
    assert torch.equal(dc.deform_conv_fused(xs, offs, mask, w_kc, bias),
                       dc.deform_conv_fused(x, offset, mask, w_kc, bias))
    before = dc.deform_conv_fused.launches
    with torch.no_grad():
        dc.modulated_deform_conv(xs, offs, mask, weight, bias)
    assert dc.deform_conv_fused.launches == before + 1


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
def test_card_serving_forward_takes_the_fused_kernel(card, dtype):
    """A no-grad modulated_deform_conv at a DynAgg shape: one fused launch,
    no B3 launch."""
    x, offset, mask, weight, bias = _inputs(4, 64, 48, 128, 128, 8, dtype,
                                            spread=0.5, device=card)
    before = (dc.deform_conv_fused.launches, dc.deform_im2col.launches)
    with torch.no_grad():
        dc.modulated_deform_conv(x, offset, mask, weight, bias)
    assert (dc.deform_conv_fused.launches, dc.deform_im2col.launches) == \
        (before[0] + 1, before[1])
