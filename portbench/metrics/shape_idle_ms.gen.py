"""Device idle milliseconds charged to the program's shape chain (its
`shape_chain` span and the `shape_eps` spans in it:
`portbench/program_spans.py`), per shape denoiser call, in the traced
generation."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms(run, ("shape_chain",), per="shape_eps")
