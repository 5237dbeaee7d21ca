"""Percent of the traced window in which no device activity ran: 100 (1 -
the union of the activities' intervals / the window)."""


def read(run):
    tr = run.trace_data
    if tr is None or tr.window_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
