"""Spans of the program's layers, recorded while a `torch.profiler` runs.

`span(name)` (or the decorator `spanned(name)`) marks one layer's work on
the host: the sampling call (`SGDiff.sample_fn`) and its parts (inside a
layout denoiser call, `layout_capture` and `layout_graph` where it
captures and replays a CUDA graph), the train step (`SGDiff.train_step`)
and its parts.  While a profiler is active (`torch.profiler.profile`, or
`train.profiling.profile_trace`) a span

  * opens a profiler range named `echoscene.<name>`, so the profiler's own
    trace shows the program's layers around its operators and kernels
    (the profiler's C++ range, `_RecordFunctionFast`: `record_function`
    goes through the dispatcher, which puts three times as much host time
    between the span's stamp and the range's), and
  * keeps `Span(name, start_ns, end_ns, parent, call)` in memory, stamped
    with `time.time_ns()`: Unix-epoch nanoseconds, the clock of kineto's
    host events and device activities, so that a span and a device
    interval of one trace compare directly.  The span's interval holds its
    profiler range: it is stamped just before the range opens and just
    after it closes.

Otherwise a span is one check of the profiler's state
(`torch._C._autograd._profiler_enabled`) and does nothing else: it
records nothing, allocates nothing on the device and launches nothing.

`parent` is the index, in the list `take()` returns, of the span that
encloses this one on the same thread (None for a root, or where the parent
was not kept); `call` identifies the root, so every span of one
`sample_fn` or `train_step` call shares it.  At most CAPACITY finished
spans are kept between two `take()`s; later ones are dropped.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

PREFIX = "echoscene."
CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: int


_finished: List[tuple] = []   # (id, name, start_ns, end_ns, parent id, call)
_lock = threading.Lock()      # guards _finished
_ids = itertools.count()
_local = threading.local()    # each thread's stack of open spans
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """True while a profiler is active: spans record only then."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A context manager that records `name` while a profiler is active
    (module docstring) and does nothing otherwise."""
    return _Span(name) if enabled() else _OFF


def spanned(name: str):
    """A decorator: each call of the function inside `span(name)`."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return decorate


def take() -> List[Span]:
    """The spans finished since the last call, in the order they opened
    (a parent before its children); the recorder forgets them."""
    global _finished
    with _lock:
        done, _finished = _finished, []
    done.sort()
    index = {rec[0]: i for i, rec in enumerate(done)}
    return [Span(name, start, end, index.get(parent), call)
            for _, name, start, end, parent, call in done]


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "call", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self.range = torch._C._profiler._RecordFunctionFast(
            PREFIX + self.name)
        self.start = time.time_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        with _lock:
            if len(_finished) < CAPACITY:
                _finished.append((self.id, self.name, self.start, end,
                                  self.parent, self.call))
        return False
