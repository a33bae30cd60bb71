"""Device ms a served batch of the kernels launched inside the
benchmark's 'net_map' span: the matcher and the
reference's VGG19 (CorrespondenceGenerationArch)."""

SPAN = 'net_map'


def read(run, variant):
    if not run.timeline.span_count(SPAN) or not run.items:
        return None
    return 1e3 * run.timeline.device_s_in(SPAN) / run.items
