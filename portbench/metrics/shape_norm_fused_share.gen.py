"""Share of the GroupNorms over three spatial dims in the traced
generation, the shape torso's, that ran the fused norm kernel: the
program's `norm3d_fused` spans over its `norm3d` spans, in %.  Nothing
where the program records no `norm3d` span (a program without the fused
norm)."""

from portbench import program_spans


def read(run):
    got = program_spans.reduction(run)
    if not got:
        return None
    spans = got[0]
    norms = program_spans._count(run, spans, "norm3d")
    if not norms:
        return None
    return 100.0 * program_spans._count(run, spans, "norm3d_fused") / norms
