"""The charging of device idle time to the program's spans
(`portbench/program_spans.py`) on a made-up trace and span list, and the
six readers that use it, which read nothing where the program records no
spans."""
import sys

import pytest
import torch

from echoscene_torch.trace import Span
from portbench import program_spans
from portbench.run import reader
from portbench.trace import Trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
GEN = ("layout_idle_ms.gen", "shape_idle_ms.gen", "sample_self_idle_ms.gen")
TRAIN = ("forward_idle_ms.train", "backward_idle_ms.train",
         "optimizer_idle_ms.train")


class Event:
    def __init__(self, name, device, start, dur, ann=False):
        self._v = (name, device, start, dur, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return 0

    def is_user_annotation(self):
        return self._v[4]


def trace_of(busy):
    """A window of 0 .. 1000 ns whose device runs the `busy` intervals."""
    return Trace([Event("portbench.window", CPU, 0, 1000, ann=True)]
                 + [Event("k", CUDA, s, e - s) for s, e in busy])


# device busy 100-200, 400-500, 700-800; idle 0-100, 200-400, 500-700,
# 800-1000 (700 ns)
BUSY = [(100, 200), (400, 500), (700, 800)]
GEN_SPANS = [
    Span("sample_fn", 50, 950, None, 0),
    Span("layout_chain", 150, 450, 0, 0),
    Span("layout_eps", 160, 300, 1, 0),
    Span("layout_eps", 320, 420, 1, 0),
    Span("shape_chain", 460, 900, 0, 0),
    Span("shape_eps", 480, 600, 4, 0),
]
TRAIN_SPANS = [
    Span("train_step", 0, 480, None, 0),
    Span("forward", 10, 150, 0, 0),
    Span("cast", 20, 60, 1, 0),
    Span("backward", 150, 300, 0, 0),
    Span("grad_norm", 300, 320, 0, 0),
    Span("clip", 320, 350, 0, 0),
    Span("adamw", 350, 470, 0, 0),
    Span("train_step", 500, 1000, None, 7),
    Span("forward", 500, 650, 7, 7),
    Span("backward", 650, 820, 7, 7),
    Span("adamw", 820, 990, 7, 7),
]


def test_idle_charged_to_the_innermost_span():
    tr = trace_of(BUSY)
    got = program_spans.self_idle_by_name(
        GEN_SPANS, program_spans.charge(tr, GEN_SPANS))
    assert got == {
        program_spans.OUTSIDE: 50 + 50,     # 0-50, 950-1000
        "sample_fn": 50 + 50,               # 50-100, 900-950: self time
        "layout_eps": 100 + 80,             # 200-300, 320-400
        "layout_chain": 20,                 # 300-320, between its children
        "shape_eps": 100,                   # 500-600
        "shape_chain": 100 + 100,           # 600-700, 800-900
    }
    assert sum(got.values()) == 1000 - tr.busy_s() * 1e9


def test_gap_straddling_two_spans_is_split():
    tr = trace_of([(0, 100), (600, 1000)])
    spans = [Span("train_step", 0, 1000, None, 0),
             Span("forward", 50, 300, 0, 0),
             Span("backward", 300, 700, 0, 0)]
    assert program_spans.self_idle_by_name(
        spans, program_spans.charge(tr, spans)) == {
            "forward": 200, "backward": 300}


def test_no_root_inside_the_window_raises():
    tr = trace_of(BUSY)
    late = [Span("sample_fn", 2000, 3000, None, 0),
            Span("layout_eps", 100, 200, 0, 0)]
    with pytest.raises(RuntimeError, match="no root span"):
        program_spans.charge(tr, late)


def run_with(spans, monkeypatch):
    monkeypatch.setattr(program_spans, "program_spans", lambda: spans)
    return SimpleRun(trace_of(BUSY))


class SimpleRun:
    """What the readers use of a run: its trace (weak references allowed,
    as the cells' `Driver` objects allow them)."""

    def __init__(self, trace_data):
        self.trace_data = trace_data


def test_generation_readers(monkeypatch):
    run = run_with(GEN_SPANS, monkeypatch)
    got = {name: reader(name)(run) for name in GEN}
    # per layout_eps (2), per shape_eps (1), per sampling call (1); ms
    assert got["layout_idle_ms.gen"] == pytest.approx((20 + 180) / 2 / 1e6)
    assert got["shape_idle_ms.gen"] == pytest.approx((100 + 200) / 1e6)
    assert got["sample_self_idle_ms.gen"] == pytest.approx(100 / 1e6)
    assert all(reader(name)(run) is None for name in TRAIN)


def test_train_readers(monkeypatch):
    run = run_with(TRAIN_SPANS, monkeypatch)
    got = {name: reader(name)(run) for name in TRAIN}
    # idle 0-100, 200-400, 500-700, 800-1000; two steps
    assert got["forward_idle_ms.train"] == pytest.approx(
        (90 + 150) / 2 / 1e6)           # 10-100 (cast 20-60), 500-650
    assert got["backward_idle_ms.train"] == pytest.approx(
        (100 + 50 + 20) / 2 / 1e6)      # 200-300, 650-700, 800-820
    assert got["optimizer_idle_ms.train"] == pytest.approx(
        (20 + 30 + 50 + 170) / 2 / 1e6)  # 300-400, 820-990
    assert all(reader(name)(run) is None for name in GEN)


@pytest.mark.parametrize("case", ["no spans", "no recorder", "no trace"])
def test_readers_read_nothing_without_spans(case, monkeypatch):
    if case == "no recorder":
        # a program without `echoscene_torch.trace`
        import echoscene_torch
        monkeypatch.setitem(sys.modules, "echoscene_torch.trace", None)
        monkeypatch.delattr(echoscene_torch, "trace")
        run = SimpleRun(trace_of(BUSY))
    elif case == "no spans":
        run = run_with(None, monkeypatch)
    else:
        run = run_with(GEN_SPANS, monkeypatch)
        run.trace_data = None
    for name in GEN + TRAIN:
        assert reader(name)(run) is None, name
