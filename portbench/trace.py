"""One traced window under `torch.profiler`, reduced to what the per-layer
metrics read.

The raw kineto events are read directly (`kineto_results.events()`), not
torch's post-processed tree, which a window of a few hundred thousand
launches would take minutes to build.  Device activities (kernels, copies,
fills) are intervals on the device's timeline; the benchmark's own
`record_function` ranges, named `portbench.<span>`, are intervals on the
host's, in the same clock.  A device activity belongs to the span in which
the host launched it: the launch is the runtime call with the activity's
correlation id.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "portbench."
WINDOW = "window"
OUTSIDE = "outside_spans"
MIN_ATTRIBUTED = 0.99


class Trace:
    """Device intervals, host spans and launch times of one window."""

    def __init__(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        self.device: List[Tuple[str, int, int, int]] = []
        self.spans: List[Tuple[str, int, int]] = []
        launches: Dict[int, int] = {}
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                if e.is_user_annotation():
                    continue
                s = e.start_ns()
                self.device.append((name, s, s + e.duration_ns(),
                                    e.correlation_id()))
            elif e.is_user_annotation() and name.startswith(PREFIX):
                s = e.start_ns()
                self.spans.append((name[len(PREFIX):], s,
                                   s + e.duration_ns()))
            elif name.startswith("cu"):
                # a CUDA runtime or driver call: the launch of the device
                # activity that has its correlation id, if any
                launches[e.correlation_id()] = e.start_ns()
        window = [s for s in self.spans if s[0] == WINDOW]
        if len(window) != 1:
            raise RuntimeError(f"the trace holds {len(window)} windows")
        _, self.start_ns, self.end_ns = window[0]
        self.spans = sorted((s for s in self.spans if s[0] != WINDOW),
                            key=lambda s: s[1])
        self.device.sort(key=lambda d: d[1])
        self._span_starts = [s[1] for s in self.spans]
        self.launch_of = launches

    # ------------------------------------------------------------------
    def span_at(self, t_ns: int) -> Optional[str]:
        """The benchmark span that holds host time t_ns, if any."""
        i = bisect.bisect_right(self._span_starts, t_ns) - 1
        if i >= 0 and self.spans[i][2] >= t_ns:
            return self.spans[i][0]
        return None

    def owner(self, activity) -> Optional[str]:
        """The span in which the host launched a device activity."""
        t = self.launch_of.get(activity[3])
        return None if t is None else self.span_at(t)

    def attributed(self) -> float:
        """Share of device activities whose launch was found."""
        if not self.device:
            return 0.0
        return sum(d[3] in self.launch_of for d in self.device) / len(
            self.device)

    def in_span(self, span: str, pattern: Optional[str] = None):
        """Device activities launched inside `span` (and whose name matches
        `pattern`, a regular expression, when given).  Raises where the
        trace does not link its device activities to their launches, so
        that no metric reads an empty span."""
        if self.attributed() < MIN_ATTRIBUTED:
            raise RuntimeError(
                f"{self.attributed():.3f} of the device activities have a "
                "launch in the trace")
        rx = re.compile(pattern) if pattern else None
        return [d for d in self.device if self.owner(d) == span
                and (rx is None or rx.search(d[0]))]

    def span_count(self, span: str) -> int:
        return sum(1 for s in self.spans if s[0] == span)

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device activities, clipped to the window."""
        out: List[List[int]] = []
        for _, s, e, _ in self.device:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for name, s, e, _ in self.device:
            total[name] += e - s
        best = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in best]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps of the device, each named by the span in
        which the host launched the activity that ended it
        ("outside_spans" where it was launched outside every benchmark
        span, "window end" for the last)."""
        busy = self.busy_intervals()
        gaps = []
        edge = self.start_ns
        starts = {}
        for d in self.device:
            starts.setdefault(max(d[1], self.start_ns), d)
        for s, e in busy:
            if s > edge:
                d = starts.get(s)
                name = (self.owner(d) if d is not None else None) \
                    or OUTSIDE
                gaps.append((s - edge, name))
            edge = e
        if self.end_ns > edge:
            gaps.append((self.end_ns - edge, "window end"))
        gaps.sort(key=lambda g: -g[0])
        return [[name, ns / 1e9] for ns, name in gaps[:n]]


def traced(fn, device) -> Tuple[object, Trace]:
    """Run fn() under the profiler (host and device activities) and return
    its value and the Trace of the window, which ends when the device has
    finished."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    with prof:
        torch.cuda.synchronize(device)
        with torch.profiler.record_function(PREFIX + WINDOW):
            value = fn()
            torch.cuda.synchronize(device)
    return value, Trace(prof.profiler.kineto_results.events())
