"""Percent of the chip's dense bf16 peak (989 TFLOP/s, the peak `mfu.train`
takes, so that no arithmetic of float32 products can read over 100%) that
the traced VQ-VAE train steps reached: the logical operations of one step,
forward and backward with nothing recomputed (`flops.vqvae_train_ops`),
over the traced window's time per `vqvae_step` span."""

from portbench import flops


def read(run):
    tr = run.trace_data
    steps = tr.span_count("vqvae_step") if tr else 0
    if not steps:
        return None
    ops = flops.vqvae_train_ops(run.cfg, run.mix)
    return 100.0 * flops.peak_seconds(ops) / (tr.window_s() / steps)
