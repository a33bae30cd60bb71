"""Device ms a served batch of the kernels launched inside the
benchmark's 'net_g' span: the restoration net
(RestorationNet)."""

SPAN = 'net_g'


def read(run, variant):
    if not run.timeline.span_count(SPAN) or not run.items:
        return None
    return 1e3 * run.timeline.device_s_in(SPAN) / run.items
