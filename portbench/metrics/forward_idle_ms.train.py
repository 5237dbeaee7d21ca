"""Device idle milliseconds per train step charged to the program's
`forward` span and its children (the bf16 `cast` of the masters, the
module's parts; `portbench/program_spans.py`), in the traced steps."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms(run, ("forward",), per="train_step")
