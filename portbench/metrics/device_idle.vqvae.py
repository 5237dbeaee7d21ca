"""Percent of the traced VQ-VAE train steps' window in which no device
activity ran."""


def read(run):
    tr = run.trace_data
    if tr is None or tr.window_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
