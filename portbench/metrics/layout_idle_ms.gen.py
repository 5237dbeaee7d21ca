"""Device idle milliseconds charged to the program's layout chain (its
`layout_chain` span and the `layout_eps` spans in it:
`portbench/program_spans.py`), per layout denoiser call, in the traced
generation."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms(run, ("layout_chain",), per="layout_eps")
