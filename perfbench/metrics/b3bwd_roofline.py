"""The B3 backward (offset and mask gradients of the three DynAggs, with
the column gradients that feed them) against its roofline.

The least time for the work at the training shapes
(``harness.work.b3_backward_work``, as the kernel's own bound counts it)
over the device time of everything launched inside the autograd node of
the modulated deformable conv but the plain PyTorch operators that
compute the weight's and the bias's gradients, which the bound does not
count; in %. Whatever kernels the package launches for the rest, under
any name, are counted.
"""
from perfbench.harness import work

NODE = '_ModulatedDeformConvBackward'
# the weight's gradient (matmuls and their sum) and the bias's
OTHER_WORK = ('aten::mm', 'aten::matmul', 'aten::bmm', 'aten::addmm',
              'aten::add', 'aten::add_', 'aten::sum')


def read(run, variant):
    node = run.timeline.ops_in(lambda n: NODE in n)
    other = set(run.timeline.ops_in(lambda n: n in OTHER_WORK))
    device_s = sum(o[2] - o[1] for o in node if o not in other) / 1e9
    if device_s <= 0 or not run.items:
        return None
    net = run.config['network_g']
    dtype = net.get('gather_dtype') or 'float32'
    gt = run.traffic['gt_size']
    bound = 0.0
    for layer, (h, w) in work.layer_sizes((gt, gt)).items():
        c = work.LAYER_CHANNELS[layer]
        bound += work.b3_backward_work((run.traffic['batch'], h, w), c,
                                       net['groups'], c, dtype)[1]
    return 100.0 * bound * run.items / device_s
