"""Percent of the chip's peak that the traced generation reached: the
least time the peaks allow for one call's logical operations (bf16 at 989
TFLOP/s, the configuration's int8 convolutions at 1,979 TOP/s;
`portbench/flops.py`) over the traced call's time."""

from portbench import flops, scenes
from portbench.generate import DECODE_CHUNK


def read(run):
    tr = run.trace_data
    if tr is None:
        return None
    nodes, triples = scenes.capacities(run.mix)
    ops = flops.generation_ops(run.cfg, nodes, triples, run.rows,
                               run.steps(), DECODE_CHUNK)
    return 100.0 * flops.peak_seconds(ops) / tr.window_s()
