"""Adaptive micro-batching for online serving.

Port of echoscene_tpu/serve/batcher.py (threads only; the reference has no
serving path).  A generation call costs nearly the same for one scene as for
a full padded bucket, so N concurrent clients served one by one waste most
of the card.  `MicroBatcher` puts a queue in front of a `GenerationService`:
a worker thread takes the first waiting request, waits up to `max_wait_ms`
for companions, and dispatches ONE padded generate call for up to
`max_batch` requests.  A batch that fails is retried request by request, so
a malformed request fails alone; `close` fails every queued future instead
of stranding it.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence


class MicroBatcher:
    def __init__(self, service, max_wait_ms: float = 30.0,
                 max_batch: Optional[int] = None):
        self.service = service
        self.max_wait = max_wait_ms / 1000.0
        # spec.max_scenes is the bucket; a larger batch would split into
        # several dispatches inside generate() anyway
        self.max_batch = max_batch or service.spec.max_scenes
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                       "isolated_failures": 0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="echoscene-microbatcher")
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, request: Dict[str, Any]) -> Future:
        """Enqueue one request; resolves to its result dict."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((request, fut))
        # close() may have raced between the check and the put; if the worker
        # is already gone, nothing will ever serve this future — fail it now
        if self._closed and not self._worker.is_alive():
            self._drain("MicroBatcher closed")
        return fut

    def generate(self, requests: Sequence[Dict[str, Any]],
                 timeout: Optional[float] = None) -> List[Dict[str, Any]]:
        """Synchronous convenience wrapper: submit all, wait for all.

        Items from concurrent callers coalesce into shared dispatches."""
        futs = [self.submit(r) for r in requests]
        return [f.result(timeout=timeout) for f in futs]

    def stats(self) -> Dict[str, float]:
        s = dict(self._stats)
        s["mean_batch_size"] = (s["batched_requests"] / s["batches"]
                                if s["batches"] else 0.0)
        return s

    def close(self, timeout: float = 10.0) -> None:
        self._closed = True
        self._q.put(None)               # wake the worker
        self._worker.join(timeout=timeout)
        self._drain("MicroBatcher closed")

    def _drain(self, reason: str) -> None:
        """Fail every queued future — requests enqueued after the close
        sentinel (or left behind by a dead worker) must never hang a client
        blocked on Future.result()."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError(reason))

    # ------------------------------------------------------------------
    def _take_batch(self):
        """Block for the first request, then drain companions until the
        window closes or the bucket is full."""
        import time
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                item = (self._q.get_nowait() if remaining <= 0
                        else self._q.get(timeout=remaining))
            except queue.Empty:
                break
            if item is None:            # close() sentinel: stop after this batch
                self._q.put(None)
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        try:
            self._run_loop()
        finally:
            # worker exiting for ANY reason (close sentinel or an unexpected
            # crash outside the per-batch handler): refuse new work and fail
            # whatever is still queued instead of stranding the futures
            self._closed = True
            self._drain("MicroBatcher worker exited")

    def _run_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            reqs = [r for r, _ in batch]
            futs = [f for _, f in batch]
            self._stats["requests"] += len(batch)
            self._stats["batches"] += 1
            self._stats["batched_requests"] += len(batch)
            try:
                results = self.service.generate(reqs)
                for f, res in zip(futs, results):
                    f.set_result(res)
            except Exception:
                if len(batch) == 1:
                    futs[0].set_exception(_capture())
                    continue
                # generate() validates every request before running any
                # (service.py), so one malformed request fails the whole
                # dispatch — retry individually to isolate the offender(s)
                for r, f in batch:
                    try:
                        (res,) = self.service.generate([r])
                        f.set_result(res)
                    except Exception:
                        self._stats["isolated_failures"] += 1
                        f.set_exception(_capture())


def _capture() -> BaseException:
    import sys
    return sys.exc_info()[1]
