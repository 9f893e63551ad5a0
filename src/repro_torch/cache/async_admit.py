"""Asynchronous admission: decouple ``admit`` from the request path.

Production engines never block a generation slot on eviction scoring — a
completed response is *queued* for admission and a background worker pays
the insert + RAC victim-scan cost off the critical path.  This module is
that queue for :class:`repro_torch.cache.SemanticCache`:

  - :meth:`AsyncAdmitter.submit` appends ``(cid, emb, payload, t, req)``
    and returns immediately (the producer-visible cost is one deque append
    under a condition variable);
  - a daemon worker drains the queue in FIFO order, applying each
    admission through the facade's synchronous path — so policies, event
    hooks, payload bookkeeping, and metrics behave exactly as if the
    caller had admitted inline, just later;
  - :meth:`flush` blocks until everything queued (and in flight) has been
    applied and returns the cids evicted since the previous flush — the
    facade calls it at batch boundaries and before checkpoint/restore.

Determinism: admissions carry the logical time assigned at *submit* and
are applied in submission order, so after a ``flush()`` the cache state
(store, policy, payloads, metrics counters, clock) is identical to the
synchronous path given the same call sequence.  ``background=False`` goes
one step further for replay parity: nothing runs concurrently at all —
the queue only drains inside ``flush()``/``drain()`` on the caller's
thread.

Thread safety: the facade serializes all state mutation behind its own
lock; the admitter only orders *when* admissions happen.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

__all__ = ["AsyncAdmitter"]


class AsyncAdmitter:
    """FIFO admission queue with an optional background drain worker.

    ``tracker`` (a :class:`repro_torch.telemetry.Tracker`, observation-only)
    receives a ``cache.queue_depth`` gauge at every submit plus
    ``cache.enqueue_s`` / ``cache.flush_s`` stall histograms — the
    producer-visible admission-stall distributions behind the serving
    SLO report."""

    def __init__(self, cache, background: bool = True, tracker=None):
        self._cache = cache
        self._trk = tracker
        self._cv = threading.Condition()
        self._pending: deque[tuple] = deque()
        self._evicted: list[int] = []       # victims since the last flush
        self._inflight = 0                  # items popped but not yet applied
        self._error: BaseException | None = None   # first failed admission
        self._closed = False
        self.background = background
        self.enqueue_s = 0.0                # producer blocking: submit calls
        self.flush_s = 0.0                  # producer blocking: flush waits
        self.applied = 0
        self._worker = None
        if background:
            self._worker = threading.Thread(
                target=self._run, name="cache-admit", daemon=True)
            self._worker.start()

    # ------------------------------------------------------------ producer
    def __len__(self) -> int:
        with self._cv:
            return len(self._pending) + self._inflight

    def submit(self, cid: int, emb, payload: Any, t: int, req) -> None:
        """Queue one admission (logical time already assigned by the
        facade, so ordering is locked in at submit time)."""
        t0 = time.perf_counter()
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncAdmitter is closed")
            self._pending.append((cid, emb, payload, t, req))
            depth = len(self._pending) + self._inflight
            self._cv.notify_all()
        dt = time.perf_counter() - t0
        self.enqueue_s += dt
        if self._trk is not None:
            self._trk.observe("cache.enqueue_s", dt)
            self._trk.gauge("cache.queue_depth", depth)

    def flush(self) -> list[int]:
        """Apply every queued admission; return victims since last flush.

        If a queued admission raised while draining, that exception is
        re-raised here (once) — an error the synchronous path would have
        raised at the admit() call site must not become a silent drop."""
        t0 = time.perf_counter()
        if self.background:
            with self._cv:
                while self._pending or self._inflight:
                    self._cv.wait()
                out, self._evicted = self._evicted, []
        else:
            self._drain_inline()
            with self._cv:
                out, self._evicted = self._evicted, []
        dt = time.perf_counter() - t0
        self.flush_s += dt
        if self._trk is not None:
            self._trk.observe("cache.flush_s", dt)
        if self._error is not None:
            err, self._error = self._error, None
            with self._cv:
                self._evicted[:0] = out     # keep victims for the next
            raise err                       # flush() after the error
        return out

    drain = flush                           # replay-parity alias

    @property
    def stall_s(self) -> float:
        """Total producer-visible blocking (enqueue + flush waits)."""
        return self.enqueue_s + self.flush_s

    def close(self):
        """Flush outstanding work and stop the worker thread (the worker
        is stopped even when the flush re-raises a drain error).

        Deterministic shutdown guarantee: anything submitted *between* the
        flush and the close mark — e.g. a tier promotion raced in by a
        concurrent lookup — is still applied.  The background worker
        drains its queue before exiting; without a worker the final
        inline drain below covers the same window, so a close can never
        silently drop a queued admission or tier move."""
        try:
            self.flush()
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            if self._worker is not None:
                self._worker.join(timeout=5)
                self._worker = None
            self._drain_inline()            # tail drain: no dropped moves

    # ------------------------------------------------------------ consumer
    def _apply(self, item: tuple):
        evicted, error = [], None
        try:
            evicted = self._cache._admit_now(*item)
        except BaseException as e:          # surface via flush(), keep the
            error = e                       # worker (and flush waits) alive
        with self._cv:
            self._evicted.extend(evicted)
            if error is not None and self._error is None:
                self._error = error
            self.applied += 1
            self._inflight -= 1
            self._cv.notify_all()

    def _drain_inline(self):
        while True:
            with self._cv:
                if not self._pending:
                    return
                item = self._pending.popleft()
                self._inflight += 1
            self._apply(item)

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:       # closed and drained
                    return
                item = self._pending.popleft()
                self._inflight += 1
            self._apply(item)
