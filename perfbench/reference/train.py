"""Plain PyTorch reference of the stage-3 training iteration.

The G-pretrain step (pixel L1 only) and the GAN iteration of
``options/train/stage3_restoration_gan.yml``: the frozen match, one G
forward, the D update on the detached output (WGAN real / fake and the
gradient penalty at weight 10, whose D pass leaves BatchNorm's running
statistics alone), then the G update (L1, fro perceptual at relu5_1 times
1e-4, and WGAN-G times 1e-6 through the updated D). Adam as published
(betas 0.9 / 0.999, eps 1e-8), G in four LR groups by name. D's
BatchNorm normalises by the batch's mean and biased variance,
max(0, E[x^2] - E[x]^2), with epsilon 1e-5; D runs in train mode
throughout, so its running statistics never reach an output and are not
kept. Images are NCHW.
"""
import torch
import torch.nn.functional as F

from .nets import (FLOAT32, VGG19, Match, conv, extractor, pre_offsets,
                   restoration, serving_param_shapes,
                   vgg, vgg_param_shapes)

PERCEPTUAL_PREFIX = 'cri_perceptual.vgg.vgg_net.'


def lr_group(name):
    """G's LR groups as the published options name them: offset convs of
    the relu3 ('small') and relu2 ('medium') DynAggs, other offset convs,
    and the rest."""
    if 'offset' in name:
        if 'small' in name:
            return 'lr_relu3_offset'
        if 'medium' in name:
            return 'lr_relu2_offset'
        return 'lr_offset'
    return 'lr_g'


def _bn(x, weight, bias):
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.)
    mul = torch.rsqrt(var + 1e-5) * weight
    return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
        + bias[None, :, None, None]


def discriminator(x, weights, prec):
    """ImageDiscriminator (ndf from the weights): five conv-BN-LReLU(0.2)
    pairs, the second conv of each at stride 2, a global mean, 1x1 convs
    to 1024 and 1, a sigmoid. Returns (B, 1, 1, 1)."""
    p = 'net_d.'
    for i in range(1, 6):
        b = f'{p}conv_block{i}.'
        for conv_i, bn_i, stride in ((0, 1, 1), (3, 4, 2)):
            x = conv(x, weights[f'{b}{conv_i}.weight'],
                     weights[f'{b}{conv_i}.bias'], prec, stride)
            x = _bn(x, weights[f'{b}{bn_i}.weight'],
                    weights[f'{b}{bn_i}.bias'])
            x = torch.where(x >= 0, x, 0.2 * x)
    x = x.mean(dim=(2, 3), keepdim=True)
    x = conv(x, weights[f'{p}out_block.1.weight'],
             weights[f'{p}out_block.1.bias'], prec)
    x = torch.where(x >= 0, x, 0.2 * x)
    return torch.sigmoid(conv(x, weights[f'{p}out_block.3.weight'],
                              weights[f'{p}out_block.3.bias'], prec))


def discriminator_param_shapes(ndf, in_nc=3):
    shapes, cin, ch = {}, in_nc, ndf
    for i in range(1, 6):
        b = f'net_d.conv_block{i}.'
        for conv_i, bn_i, c_in in ((0, 1, cin), (3, 4, ch)):
            shapes[f'{b}{conv_i}.weight'] = (ch, c_in, 3, 3)
            shapes[f'{b}{conv_i}.bias'] = (ch,)
            shapes[f'{b}{bn_i}.weight'] = (ch,)
            shapes[f'{b}{bn_i}.bias'] = (ch,)
        cin = ch
        if i < 5:
            ch *= 2
    shapes['net_d.out_block.1.weight'] = (1024, ch, 1, 1)
    shapes['net_d.out_block.1.bias'] = (1024,)
    shapes['net_d.out_block.3.weight'] = (1, 1024, 1, 1)
    shapes['net_d.out_block.3.bias'] = (1,)
    return shapes


def training_param_shapes(net, ndf):
    """{name: shape} of every weight of the stage-3 model: the serving
    nets, D and the perceptual VGG19 (built in both of the stage's
    phases)."""
    shapes = serving_param_shapes(net)
    shapes.update(discriminator_param_shapes(ndf))
    shapes.update(vgg_param_shapes(PERCEPTUAL_PREFIX, VGG19))
    return shapes


def trained_names(shapes, gan):
    """The leaves the step trains: G's, and D's in the GAN iteration."""
    return [k for k in shapes if k.startswith('net_g.')
            or (gan and k.startswith('net_d.'))]


class TrainReference:
    """The reference's training state: its own copies of the weights, Adam
    for G (four LR groups) and D, stepped by ``step``."""

    def __init__(self, weights, shapes, train_opt, net, gan, prec=FLOAT32):
        self.prec = prec
        self.net = net
        self.gan = gan
        self.train_opt = train_opt
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        names = trained_names(shapes, gan)
        for k in names:
            self.w[k].requires_grad_(True)
        self._names = {id(self.w[k]): k for k in names}
        betas = tuple(train_opt.get('beta_g') or (0.9, 0.999))
        groups = {}
        for k in names:
            if k.startswith('net_g.'):
                groups.setdefault(lr_group(k), []).append(self.w[k])
        self.opt_g = torch.optim.Adam(
            [{'params': v, 'lr': train_opt.get(g) or train_opt['lr_g']}
             for g, v in groups.items()], betas=betas, eps=1e-8)
        self.opt_d = None
        if gan:
            self.opt_d = torch.optim.Adam(
                [self.w[k] for k in names if k.startswith('net_d.')],
                lr=train_opt['lr_d'],
                betas=tuple(train_opt.get('beta_d') or (0.9, 0.999)),
                eps=1e-8)
        self.first_grads = None

    def _g(self, batch, match_idx):
        """The frozen features and match (the given indices, judged
        elsewhere, or the reference's own, kept in ``last_idx``), then G's
        forward with grad."""
        w, prec = self.w, self.prec
        self.last_idx = []
        with torch.no_grad():
            ref_feats = vgg(batch['ref'], w, 'net_map.vgg.vgg_net.',
                            VGG19[:12], prec,
                            wanted={'relu1_1', 'relu2_1', 'relu3_1'})
            pres = []
            for i in range(batch['lq'].shape[0]):
                if match_idx is None:
                    f_in, f_ref = extractor(batch['up'][i:i + 1],
                                            batch['ref'][i:i + 1], w, prec)
                    m = Match(f_in[0], f_ref[0], prec)
                    idx, shape = m.best()[1], m.shape
                else:
                    h, wd = batch['lq'].shape[2:]
                    idx, shape = match_idx[i], (h - 2, wd - 2)
                self.last_idx.append(idx)
                pres.append(pre_offsets(idx, shape))
        outs = []
        for i in range(batch['lq'].shape[0]):
            outs.append(restoration(
                batch['lq'][i:i + 1], pres[i],
                {k: v[i:i + 1] for k, v in ref_feats.items()}, w, prec,
                self.net['n_blocks'], self.net['groups']))
        return torch.cat(outs)

    def step(self, batch, match_idx=None, alpha=None, update=True):
        """One iteration on ``batch`` ({'lq', 'up', 'ref', 'gt'}, NCHW);
        returns its losses (0-d tensors). After the first, ``first_grads``
        holds each trained leaf's gradient. ``update`` False skips the
        optimizers (a count of the step's operations on 'meta')."""
        w, prec, t = self.w, self.prec, self.train_opt
        gt = batch['gt']
        out = self._g(batch, match_idx)
        logs, grads = {}, {}
        if not self.gan:
            self.opt_g.zero_grad(set_to_none=True)
            l_pix = (out - gt).abs().mean() * t['pixel_weight']
            l_pix.backward()
            grads.update(self._grads('net_g.'))
            self._update(self.opt_g, update)
            logs['l_pix'] = l_pix.detach()
        else:
            fake = out.detach()
            self.opt_d.zero_grad(set_to_none=True)
            real_pred = discriminator(gt, w, prec)
            fake_pred = discriminator(fake, w, prec)
            l_real = -real_pred.mean()
            l_fake = fake_pred.mean()
            a = alpha.view(-1, 1, 1, 1)
            interp = (a * gt + (1 - a) * fake).requires_grad_(True)
            g, = torch.autograd.grad(discriminator(interp, w, prec).sum(),
                                     interp, create_graph=True)
            norm = torch.sqrt((g.reshape(g.shape[0], -1) ** 2).sum(1)
                              + 1e-24)
            l_gp = t['grad_penalty_weight'] * ((norm - 1) ** 2).mean()
            (l_real + l_fake + l_gp).backward()
            grads.update(self._grads('net_d.'))
            self._update(self.opt_d, update)
            logs.update(l_d_real=l_real.detach(), l_d_fake=l_fake.detach(),
                        l_grad_penalty=l_gp.detach())

            self.opt_g.zero_grad(set_to_none=True)
            l_pix = (out - gt).abs().mean() * t['pixel_weight']
            p = t['perceptual_opt']
            f_out = vgg(out, w, PERCEPTUAL_PREFIX, VGG19, prec)
            with torch.no_grad():
                f_gt = vgg(gt, w, PERCEPTUAL_PREFIX, VGG19, prec)
            l_percep = torch.sqrt(((f_out - f_gt) ** 2).sum()) \
                * p['perceptual_weight']
            d_names = [k for k in w if k.startswith('net_d.')]
            for k in d_names:
                w[k].requires_grad_(False)
            l_gan = -discriminator(out, w, prec).mean() * t['gan_weight']
            for k in d_names:
                w[k].requires_grad_(True)
            (l_pix + l_percep + l_gan).backward()
            grads.update(self._grads('net_g.'))
            self._update(self.opt_g, update)
            logs.update(l_g_pix=l_pix.detach(), l_g_percep=l_percep.detach(),
                        l_g_gan=l_gan.detach())
        if self.first_grads is None:
            self.first_grads = grads
        return logs

    def set_moments(self, moments):
        """Start Adam from ``moments`` ({name: the optimizer's state of
        that leaf}), as when following a state reached elsewhere."""
        for opt in (self.opt_g, self.opt_d):
            if opt is None:
                continue
            for group in opt.param_groups:
                for p in group['params']:
                    state = moments.get(self._names[id(p)])
                    if state:
                        opt.state[p] = {k: v.clone()
                                        for k, v in state.items()}

    @staticmethod
    def _update(opt, update):
        if update:
            opt.step()

    def _grads(self, prefix):
        return {k: (v.grad.detach().clone() if v.grad is not None
                    else torch.zeros_like(v))
                for k, v in self.w.items()
                if k.startswith(prefix) and v.requires_grad}
