"""Device idle time of a traced window charged to the program's own spans.

The program records its spans (`echoscene_torch/trace.py`: the sampling
call, the twin build, the context, the chains and their denoiser calls,
the decode and its chunks; the train step, its forward, backward, gradient
norm, clip and AdamW) while a profiler runs, on the clock of the device
trace.  The rule: each instant of the traced window at which the device
runs nothing (the complement of `Trace.busy_intervals()`) is charged to
the innermost program span whose host interval holds it, or to OUTSIDE
where none does.  A span's self idle is what is charged to it and to none
of its children; the self idles and OUTSIDE sum to the window's idle.

The per-layer metrics read `idle_ms` and `self_idle_ms`.  Where the program records no spans
(a program without `echoscene_torch.trace`) they read nothing; where it
recorded spans but no root span overlaps the window, the reduction raises
rather than read an empty trace.
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

OUTSIDE = "outside the program"

# run -> (spans, charged idle) of its traced window, or None
_reductions: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def program_spans() -> Optional[list]:
    """The spans the program recorded since they were last taken, taken
    from its recorder; None where the program records none."""
    try:
        from echoscene_torch import trace
    except ImportError:
        return None
    return trace.take() or None


def _idle_intervals(tr) -> List[Tuple[int, int]]:
    """The instants of the window at which the device runs nothing."""
    out, edge = [], tr.start_ns
    for s, e in tr.busy_intervals():
        if s > edge:
            out.append((edge, s))
        edge = max(edge, e)
    if tr.end_ns > edge:
        out.append((edge, tr.end_ns))
    return out


def _depths(spans: Sequence) -> List[int]:
    """Each span's depth below its root (parents precede children)."""
    out: List[int] = []
    for sp in spans:
        out.append(0 if sp.parent is None else out[sp.parent] + 1)
    return out


def charge(tr, spans: Sequence) -> Dict[Optional[int], int]:
    """Idle nanoseconds of the window charged to each span (by index in
    `spans`; None is OUTSIDE).  Raises where no root span overlaps the
    window."""
    start, end = tr.start_ns, tr.end_ns
    if not any(sp.parent is None and sp.start_ns < end and sp.end_ns > start
               for sp in spans):
        raise RuntimeError("the program recorded no root span inside the "
                           "traced window")
    depth = _depths(spans)
    n = len(spans)
    opens = sorted(range(n), key=lambda i: spans[i].start_ns)
    closes = sorted(range(n), key=lambda i: spans[i].end_ns)
    points = sorted({start, end} | {t for sp in spans
                                    for t in (sp.start_ns, sp.end_ns)
                                    if start < t < end})
    # the window cut at every span boundary, each piece owned by the
    # innermost span holding it
    pieces = []
    active, io, ic = set(), 0, 0
    for a, b in zip(points, points[1:]):
        while io < n and spans[opens[io]].start_ns <= a:
            active.add(opens[io])
            io += 1
        while ic < n and spans[closes[ic]].end_ns <= a:
            active.discard(closes[ic])
            ic += 1
        owner = max(active, key=lambda i: (depth[i], spans[i].start_ns, i),
                    default=None)
        pieces.append((a, b, owner))
    charged: Dict[Optional[int], int] = {}
    idle = _idle_intervals(tr)
    j = 0
    for a, b, owner in pieces:
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            overlap = min(b, idle[k][1]) - max(a, idle[k][0])
            if overlap > 0:
                charged[owner] = charged.get(owner, 0) + overlap
            k += 1
    return charged


def self_idle_by_name(spans: Sequence, charged: Dict[Optional[int], int]
                      ) -> Dict[str, int]:
    """Self idle nanoseconds (`charge`'s) summed by span name, and
    OUTSIDE's."""
    out: Dict[str, int] = {}
    for i, ns in charged.items():
        name = OUTSIDE if i is None else spans[i].name
        out[name] = out.get(name, 0) + ns
    return out


def _within(spans: Sequence, i: Optional[int], names: Iterable[str]
            ) -> bool:
    """Whether span i or one of its ancestors is named in `names`."""
    while i is not None:
        if spans[i].name in names:
            return True
        i = spans[i].parent
    return False


def reduction(run):
    """(spans, idle charged to each) of `run`'s traced window, or None where
    the run was not traced or the program recorded no spans.  The spans are
    taken from the program once per run; later readers get the same."""
    if run not in _reductions:
        spans = program_spans() if run.trace_data is not None else None
        _reductions[run] = (None if spans is None else
                            (spans, charge(run.trace_data, spans)))
    return _reductions[run]


def _count(run, spans: Sequence, name: str) -> int:
    """The spans named `name` that overlap the traced window."""
    tr = run.trace_data
    return sum(1 for sp in spans if sp.name == name
               and sp.start_ns < tr.end_ns and sp.end_ns > tr.start_ns)


def idle_ms(run, names: Sequence[str], per: str) -> Optional[float]:
    """Idle milliseconds of the traced window charged to the spans named in
    `names` and their descendants, per span named `per`."""
    got = reduction(run)
    count = got and _count(run, got[0], per)
    if not count:
        return None
    spans, charged = got
    ns = sum(v for i, v in charged.items() if _within(spans, i, names))
    return ns / 1e6 / count


def self_idle_ms(run, name: str) -> Optional[float]:
    """Idle milliseconds charged to the spans named `name` themselves (to
    none of their children), per such span."""
    got = reduction(run)
    count = got and _count(run, got[0], name)
    if not count:
        return None
    spans, charged = got
    ns = sum(v for i, v in charged.items()
             if i is not None and spans[i].name == name)
    return ns / 1e6 / count
