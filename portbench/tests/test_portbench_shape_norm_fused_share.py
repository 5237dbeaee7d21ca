"""`shape_norm_fused_share.gen` on made-up span lists: the share of the
shape torso's norms that ran the fused kernel, and nothing where the
program records no spans or no norm spans."""
import pytest

from echoscene_torch.trace import Span
from portbench import program_spans
from portbench.run import reader

from test_portbench_layout_graph_share import SimpleRun

NAME = "shape_norm_fused_share.gen"


def chain(fused, norms=46, steps=20):
    """A sampling call whose shape chain makes `steps` denoiser calls of
    `norms` norm spans each, the first `fused` of each call holding a
    `norm3d_fused` span."""
    spans = [Span("sample_fn", 0, 9_000, None, 0),
             Span("shape_chain", 10, 8_000, 0, 0)]
    for i in range(steps):
        at = 100 + 300 * i
        spans.append(Span("shape_eps", at, at + 290, 1, 0))
        step = len(spans) - 1
        for k in range(norms):
            start = at + 2 + 6 * k
            spans.append(Span("norm3d", start, start + 5, step, 0))
            if k < fused:
                spans.append(Span("norm3d_fused", start + 1, start + 4,
                                  len(spans) - 1, 0))
    return spans


@pytest.mark.parametrize("spans,share", [
    (chain(46), 100.0), (chain(23), 50.0), (chain(0), 0.0),
    (chain(0, norms=0), None), (None, None)],
    ids=["all fused", "half fused", "none fused", "no norm spans",
         "no spans"])
def test_shape_norm_fused_share(spans, share, monkeypatch):
    monkeypatch.setattr(program_spans, "program_spans", lambda: spans)
    assert reader(NAME)(SimpleRun()) == share
