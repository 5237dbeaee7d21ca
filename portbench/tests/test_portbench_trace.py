"""The reduction of a traced window, on made-up kineto events: the union of
device intervals, the idle gaps named by the span that launched the work
that ended them, and activities attributed to spans by their launches."""
import torch

from portbench.trace import Trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, device, start, dur, corr=0, ann=False):
        self._v = (name, device, start, dur, corr, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def window():
    return [
        Event("portbench.window", CPU, 0, 1000, ann=True),
        Event("portbench.layout_eps", CPU, 10, 90, ann=True),
        Event("portbench.shape_eps", CPU, 200, 300, ann=True),
        Event("aten::mm", CPU, 20, 5),
        Event("cudaLaunchKernel", CPU, 20, 2, corr=1),
        Event("cudaLaunchKernel", CPU, 50, 2, corr=2),
        Event("cudaLaunchKernel", CPU, 210, 2, corr=3),
        Event("cudaLaunchKernel", CPU, 600, 2, corr=4),
        Event("gemm_a", CUDA, 100, 50, corr=1),
        Event("gemm_a", CUDA, 120, 60, corr=2),       # overlaps the first
        Event("attention_kernel<64>", CUDA, 400, 100, corr=3),
        Event("fill", CUDA, 700, 100, corr=4),
        Event("portbench.layout_eps", CUDA, 100, 80, ann=True),
    ]


def test_busy_union_and_window():
    tr = Trace(window())
    assert tr.window_s() == 1000 / 1e9
    assert tr.busy_intervals() == [(100, 180), (400, 500), (700, 800)]
    assert tr.busy_s() == 280 / 1e9


def test_attribution_by_launch():
    tr = Trace(window())
    assert tr.attributed() == 1.0
    assert len(tr.in_span("layout_eps")) == 2
    assert [d[0] for d in tr.in_span("shape_eps", r"\battention_kernel\b")] \
        == ["attention_kernel<64>"]
    assert tr.span_count("layout_eps") == 1


def test_gaps_named_by_the_launching_span():
    tr = Trace(window())
    gaps = dict((name, s) for name, s in tr.idle_gaps())
    assert gaps["shape_eps"] == 220 / 1e9      # 180 .. 400
    assert gaps["layout_eps"] == 100 / 1e9     # 0 .. 100
    assert gaps["outside_spans"] == 200 / 1e9  # 500 .. 700, launched outside
    assert gaps["window end"] == 200 / 1e9
    top = tr.top_ops()
    assert top[0] == ["fill", 100 / 1e9] or top[0][0] in ("gemm_a", "fill")
