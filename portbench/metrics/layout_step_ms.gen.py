"""Device-timeline milliseconds of one layout denoiser call (CUDA events
around `layout_eps`), mean over the traced window's calls."""


def read(run):
    ms = run.rec.span_ms("layout_eps")
    return sum(ms) / len(ms) if ms else None
