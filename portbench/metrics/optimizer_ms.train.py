"""Device milliseconds of the optimizer chain per train step: the device
activities the host launched inside `apply_gradients` (the shape branch's
gradient clip and AdamW over the f32 masters), summed, over the traced
steps."""


def read(run):
    tr = run.trace_data
    steps = tr.span_count("optimizer") if tr else 0
    if not steps:
        return None
    return sum(e - s for _, s, e, _ in tr.in_span("optimizer")) / 1e6 / steps
