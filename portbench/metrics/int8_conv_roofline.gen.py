"""Percent of their bound that the int8 convolution kernels Q1 / Q2
(`absmax_pass`, `quantize_pass`, `int8_conv3d_wgmma`, `csrc/int8_conv.cu`)
reached in the traced generation's shape steps: the sum of
`bounds.quantize_bound` and `bounds.int8_conv_bound` over the W8A8
torso's convolutions of each step (`bounds.torso_conv_sites`), over the
kernels' device time.  Nothing to read where the torso is not int8."""

from portbench import bounds

KERNELS = r"\b(absmax_pass|quantize_pass|int8_conv3d_wgmma)\b"


def read(run):
    tr = run.trace_data
    if tr is None or run.cfg["sample_dtype"] != "int8":
        return None
    got = tr.in_span("shape_eps", KERNELS)
    steps = tr.span_count("shape_eps")
    if not got or not steps:
        return None
    b = bounds.torso_step_bound_ms(run.cfg["shape_branch"]["unet"],
                                   run.rows)
    device_ms = sum(e - s for _, s, e, _ in got) / 1e6
    return 100.0 * steps * (b["q1_ms"] + b["q2_ms"]) / device_ms
