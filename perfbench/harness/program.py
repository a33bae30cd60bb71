"""The system under test: the port's stage-3 model at its entry points.

Builds ``RefRestorationModel`` from a configuration's options (the
configuration file holds them, copied from the repository's YAML with no
checkpoint paths), loads the benchmark's seeded weights into it, and puts
the benchmark's own hooks on its modules: ``record_function`` spans in
traced runs, and a capture of chosen outputs for the check.
"""
import copy

import torch

from .weights import load_into

# the nets the benchmark names in spans, by the model's attribute
NETS = ('net_extractor', 'net_map', 'net_g')
DYNAGGS = (('small_dyn_agg', 'relu3_1'), ('medium_dyn_agg', 'relu2_1'),
           ('large_dyn_agg', 'relu1_1'))


def options(config, train):
    """The model's options dict from a configuration."""
    opt = {k: copy.deepcopy(config[k]) for k in
           ('network_g', 'network_map', 'network_extractor')}
    opt.update(manual_seed=0, crop_border=None, is_train=train)
    if train:
        opt['network_d'] = copy.deepcopy(config['network_d'])
        opt['train'] = copy.deepcopy(config['train'])
    return opt


def build(config, weights, device, train):
    """The port's model on ``device`` with ``weights`` loaded."""
    from c2matching_tpu_torch.models import RefRestorationModel
    model = RefRestorationModel(options(config, train), device)
    load_into(model.net_extractor, weights, 'net_extractor.')
    load_into(model.net_map, weights, 'net_map.')
    load_into(model.net_g, weights, 'net_g.')
    if train and model.net_d is not None:
        load_into(model.net_d, weights, 'net_d.')
        load_into(model.cri_perceptual, weights, 'cri_perceptual.')
    return model


def dynaggs(model):
    agg = model.net_g.dyn_agg_restore
    return [(getattr(agg, attr), key) for attr, key in DYNAGGS]


class Spans:
    """``record_function`` ranges around calls of the model's nets and
    DynAggs, from forward hooks: 'net_extractor', 'net_map', 'net_g',
    'dynagg.<layer>'."""

    def __init__(self, model):
        self.handles = []
        self.open = []
        mods = [(getattr(model, n), n) for n in NETS]
        mods += [(m, f'dynagg.{key}') for m, key in dynaggs(model)]
        for module, name in mods:
            self.handles.append(module.register_forward_pre_hook(
                self._enter(name)))
            self.handles.append(module.register_forward_hook(
                self._exit(name)))

    def _enter(self, name):
        def hook(module, args):
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self.open.append(rf)
        return hook

    def _exit(self, name):
        def hook(module, args, out):
            self.open.pop().__exit__(None, None, None)
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


# a layer's scale against the match's relu3 grid
SCALE = {'dense_features1': 1, 'dense_features2': 1, 'relu3_1': 1,
         'relu2_1': 2, 'relu1_1': 4}


class Capture:
    """Keeps outputs of the model's nets while ``armed``, copied on the
    device into buffers of their own, one set a ``slot`` (no copy to the
    host and no synchronise): the match's relu3 offsets (candidate 0, the
    flow) of the whole batch, and for image ``deep`` (None: none) a crop of
    the extractor's features, the reference's VGG features and each
    DynAgg's output. ``crop`` is (row, column, side) on the relu3 grid; a
    layer at twice or four times that scale is cut at twice or four times
    it."""

    def __init__(self, model):
        self.armed = False
        self.deep = None
        self.crop = None
        self.got = {}
        self.buffers = {}
        self.slot = None
        self.handles = [
            model.net_extractor.register_forward_hook(self._extractor),
            model.net_map.register_forward_hook(self._map)]
        for module, key in dynaggs(model):
            self.handles.append(module.register_forward_hook(
                self._dynagg(f'dynagg.{key}', SCALE[key])))

    def arm(self, slot=0, deep=None, crop=None):
        self.armed, self.slot, self.deep, self.crop = True, slot, deep, crop
        self.got = {}

    def disarm(self):
        self.armed = False
        return self.got

    def _keep(self, name, t):
        buf = self.buffers.get((self.slot, name))
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self.buffers[(self.slot, name)] = torch.empty_like(t)
        self.got[name] = buf.copy_(t.detach())

    def _cut(self, name, t, f):
        y, x, s = self.crop
        self._keep(name, t[self.deep, y * f:(y + s) * f, x * f:(x + s) * f])

    def _extractor(self, module, args, out):
        if self.armed and self.deep is not None:
            for k in ('dense_features1', 'dense_features2'):
                self._cut(k, out[k], 1)

    def _map(self, module, args, out):
        if not self.armed:
            return
        pre_offset, ref_feat = out
        self._keep('flow', pre_offset['relu3_1'][:, 0])
        if self.deep is not None:
            for k, v in ref_feat.items():
                self._cut(k, v, SCALE[k])

    def _dynagg(self, name, f):
        def hook(module, args, out):
            if self.armed and self.deep is not None:
                self._cut(name, out, f)
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def flow_to_index(flow, valid_hw):
    """The match indices (L,) on the exact-size query grid of valid
    relu3 size ``valid_hw`` from one image's captured flow (H, W, 2[x,
    y]) on the model's (padded) grid: the chosen reference patch's row and
    column, flattened on the (vh-2) x (vw-2) grid; a patch off that grid
    reads -1."""
    vh, vw = valid_hw
    h, w = vh - 2, vw - 2
    f = flow[:h, :w].double()
    col = f[..., 0] + torch.arange(w, dtype=torch.float64)[None, :]
    row = f[..., 1] + torch.arange(h, dtype=torch.float64)[:, None]
    col, row = col.round().long(), row.round().long()
    ok = (col >= 0) & (col < w) & (row >= 0) & (row < h)
    return torch.where(ok, row * w + col, torch.full_like(col, -1)).view(-1)
