"""The three DynAgg modules (offset conv, modulated deformable conv
through B3 and its contraction) against their roofline.

The least time for each module's work at the requests' valid sizes:
its inputs, weights and output once, the offset conv's and the
contraction's operations and the bilinear sampling
(``harness.work.dynagg_work``), over the device time of everything
launched inside the benchmark's 'dynagg.<layer>' spans, in %. The count
does not depend on how the package splits the work into kernels.
"""
from perfbench.harness import work


def read(run, variant):
    device_s = run.timeline.device_s_in(lambda n: n.startswith('dynagg.'))
    if device_s <= 0:
        return None
    net = run.config['network_g']
    dtype = net.get('gather_dtype') or 'float32'
    batch = run.traffic['batch']
    bound = 0.0
    for layer, (h, w) in work.layer_sizes(run.traffic['sizes'][0]).items():
        c = work.LAYER_CHANNELS[layer]
        bound += work.dynagg_work((batch, h, w), c, c, net['groups'],
                                  dtype)[1]
    return 100.0 * bound * run.items / device_s
