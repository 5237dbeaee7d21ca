"""Device idle milliseconds per sampling call charged to the program's
`sample_fn` span itself, in none of its children (the host between the
parts: the graph compaction, the noise draws, the padding, the boxes'
split; `portbench/program_spans.py`), in the traced generation."""

from portbench import program_spans


def read(run):
    return program_spans.self_idle_ms(run, "sample_fn")
