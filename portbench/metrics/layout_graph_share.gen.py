"""Share of the layout denoiser's calls in the traced generation that
replayed a CUDA graph: the program's `layout_graph` spans over its
`layout_eps` spans, in %.  Nothing where the program graphs no call (it
recorded no `layout_graph` or `layout_capture` span: a program without
the graphs)."""

from portbench import program_spans


def read(run):
    got = program_spans.reduction(run)
    if not got:
        return None
    spans = got[0]
    steps = program_spans._count(run, spans, "layout_eps")
    graphed = program_spans._count(run, spans, "layout_graph")
    if not steps or not (graphed or program_spans._count(
            run, spans, "layout_capture")):
        return None
    return 100.0 * graphed / steps
