"""Device ms a training step of the discriminator's update: the device
time of the operations launched inside the program's ``c2m.d_update``
spans in the traced stretch (D's forwards on the real and the generated
batch, the gradient penalty's double backward, D's backward and its Adam
step), on any thread (``device_ops.launched_in``), over the stretch's
steps (its ``c2m.step`` spans). None where the trace holds no D update.
"""
from perfbench.metrics.device_ops import launched_in

SPAN = 'c2m.d_update'
STEP = 'c2m.step'


def read(run, variant):
    steps = run.timeline.span_count(STEP)
    ops = launched_in(run.timeline, (SPAN,))
    device_s = sum(o[2] - o[1] for o in ops) / 1e9
    if not (steps and device_s > 0):
        return None
    return 1e3 * device_s / steps
