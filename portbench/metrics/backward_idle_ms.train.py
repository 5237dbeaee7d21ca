"""Device idle milliseconds per train step charged to the program's
`backward` span (`loss.backward()`; `portbench/program_spans.py`), in the
traced steps."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms(run, ("backward",), per="train_step")
