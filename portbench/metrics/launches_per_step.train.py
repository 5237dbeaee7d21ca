"""Device activities (kernels, copies, fills) of the traced window per
train step."""


def read(run):
    tr = run.trace_data
    steps = tr.span_count("optimizer") if tr else 0
    return len(tr.device) / steps if steps else None
