"""Device-timeline milliseconds of one VQ decode chunk (CUDA events around
`decode_latent`), mean over the traced window's chunks."""


def read(run):
    ms = run.rec.span_ms("decode_latent")
    return sum(ms) / len(ms) if ms else None
