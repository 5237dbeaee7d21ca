"""Device-timeline milliseconds of one shape denoiser call (CUDA events
around `shape_eps`), mean over the traced window's calls."""


def read(run):
    ms = run.rec.span_ms("shape_eps")
    return sum(ms) / len(ms) if ms else None
