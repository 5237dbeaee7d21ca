"""Percent of the chip's bf16 peak (989 TFLOP/s) that the traced train
steps reached: the logical operations of one step, forward and backward
with nothing recomputed (`portbench/flops.py`), over the traced window's
time per step."""

from portbench import flops


def read(run):
    tr = run.trace_data
    steps = tr.span_count("optimizer") if tr else 0
    if not steps:
        return None
    ops = flops.train_ops(run.cfg, run.mix)
    return 100.0 * flops.peak_seconds(ops) / (tr.window_s() / steps)
