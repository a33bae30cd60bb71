"""Kernel B1 (the patch-match argmax) against its roofline.

The least time for the match at the requests' valid sizes (every valid
query patch against every valid reference patch, 9 x 256 deep, at the
configuration's match precision; ``harness.work.b1_work``) over the
device time of the operations launched inside the operator
``c2matching::match_argmax``, in %.
"""
from perfbench.harness import work

OP = 'c2matching::match_argmax'


def read(run, variant):
    device_s = run.timeline.device_s_in(OP)
    if device_s <= 0:
        return None
    dtype = run.config['network_map'].get('match_dtype') or 'float32'
    n = work.match_patches(work.layer_sizes(
        run.traffic['sizes'][0])['relu3_1'])
    bound = work.b1_work(n, n, 9 * work.MATCH_CHANNELS, dtype,
                         run.traffic['batch'])[2]
    return 100.0 * bound * run.items / device_s
