"""Device activities (kernels, copies, fills) the host launched inside the
layout denoiser's spans, per layout step."""


def read(run):
    tr = run.trace_data
    steps = tr.span_count("layout_eps") if tr else 0
    if not steps:
        return None
    return len(tr.in_span("layout_eps")) / steps
