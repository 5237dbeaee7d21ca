"""`layout_graph_share.gen` on made-up span lists: the share of the layout
denoiser's calls that replayed a graph, and nothing where the program
records no spans or graphs no call."""
import pytest

from echoscene_torch.trace import Span
from portbench import program_spans
from portbench.run import reader

NAME = "layout_graph_share.gen"


class Window:
    """What the readers use of a trace: a window of 0 .. 10,000 ns whose
    device is busy for its first half."""
    start_ns, end_ns = 0, 10_000

    def busy_intervals(self):
        return [(0, 5_000)]


class SimpleRun:
    def __init__(self):
        self.trace_data = Window()


def chain(graphed):
    """A sampling call whose layout chain makes 50 denoiser calls: the
    first eager, the second a capture and a replay, the rest replays (or,
    with `graphed` False, all eager)."""
    spans = [Span("sample_fn", 0, 9_000, None, 0),
             Span("layout_chain", 10, 8_000, 0, 0)]
    for i in range(50):
        at = 100 + 150 * i
        spans.append(Span("layout_eps", at, at + 100, 1, 0))
        step = len(spans) - 1
        if graphed and i == 1:
            spans.append(Span("layout_capture", at + 5, at + 40, step, 0))
        if graphed and i >= 1:
            spans.append(Span("layout_graph", at + 50, at + 90, step, 0))
    return spans


@pytest.mark.parametrize("spans,share", [
    (chain(True), 98.0), (chain(False), None), (None, None)],
    ids=["graphed", "eager", "no spans"])
def test_layout_graph_share(spans, share, monkeypatch):
    monkeypatch.setattr(program_spans, "program_spans", lambda: spans)
    assert reader(NAME)(SimpleRun()) == share
