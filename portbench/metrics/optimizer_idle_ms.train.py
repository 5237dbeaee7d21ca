"""Device idle milliseconds per train step charged to the program's
optimizer spans: the metrics' `grad_norm`, the `clip` and `adamw`
(`portbench/program_spans.py`), in the traced steps."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms(run, ("grad_norm", "clip", "adamw"),
                                 per="train_step")
