"""Host milliseconds of building the sampling twin inside `sample_fn`
(`SGDiff.inference_module`, synchronised on either side), mean over the
traced calls."""


def read(run):
    t = run.rec.twin_build_s
    return 1e3 * sum(t) / len(t) if t else None
