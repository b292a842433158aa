"""Admission control + signature-grouping scheduler.

The queue is *bounded* (admission control: a full queue rejects at submit
time with :class:`~repro_torch.service.requests.ServiceOverloaded` rather than
accepting work it cannot serve), *prioritized* (higher ``priority``
dispatches first; FIFO within a priority), and *signature-grouped*: when a
worker asks for work, the scheduler hands it **every** queued request that
shares the chosen head-of-line signature (up to ``group_max``).  A worker
therefore amortizes one warm plan across a whole group back-to-back — and
this grouping boundary is where ``SimulationService(micro_batch=N)``
coalesces the group into one batched ensemble launch: the same signature
re-planned with ``batch=B`` steps every member per kernel call (see
``SimulationService._serve_batched``).

Deadlines are enforced at dispatch: a request whose deadline passed while
queued is expired (its ticket fails with ``DeadlineExceeded``) instead of
occupying a worker.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import List, Optional

from repro_torch.service.requests import (
    DeadlineExceeded,
    ServiceOverloaded,
    Ticket,
)


class SignatureScheduler:
    """Bounded priority queue that dispatches same-signature groups."""

    def __init__(self, capacity: int = 256, group_max: int = 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self.group_max = group_max
        self._heap: List[tuple] = []  # (-priority, seq, ticket)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._closed = False
        self.expired: List[Ticket] = []  # tickets failed at dispatch

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def submit(self, ticket: Ticket) -> None:
        """Admit ``ticket`` or raise :class:`ServiceOverloaded` (queue full)
        / ``RuntimeError`` (scheduler closed)."""
        req = ticket.request
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if len(self._heap) >= self.capacity:
                raise ServiceOverloaded(
                    f"queue full ({self.capacity} pending); request "
                    f"{req.request_id} rejected"
                )
            ticket.stats.submitted_s = time.monotonic()
            heapq.heappush(
                self._heap, (-req.priority, next(self._seq), ticket)
            )
            self._ready.notify()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._ready.notify_all()

    def _pop_expired(self, now: float) -> None:
        """Fail (and drop) every queued ticket whose deadline has passed."""
        keep = []
        for item in self._heap:
            t = item[2]
            dl = t.request.deadline_s
            if dl is not None and now - t.stats.submitted_s > dl:
                t.stats.finished_s = now
                t._fail(
                    DeadlineExceeded(
                        f"request {t.request.request_id} expired after "
                        f"{now - t.stats.submitted_s:.3f}s in queue "
                        f"(deadline {dl}s)"
                    )
                )
                self.expired.append(t)
            else:
                keep.append(item)
        if len(keep) != len(self._heap):
            heapq.heapify(keep)
            self._heap[:] = keep

    def get_group(self, timeout: Optional[float] = None) -> List[Ticket]:
        """Block for work; return all queued requests sharing the
        head-of-line signature (priority order, ≤ ``group_max``).

        Returns ``[]`` on timeout or when the scheduler is closed and
        drained — workers use that as their exit signal.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                self._pop_expired(time.monotonic())
                if self._heap:
                    break
                if self._closed:
                    return []
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return []
                self._ready.wait(remaining)
            head = heapq.heappop(self._heap)[2]
            sig = head.request.signature
            group, keep = [head], []
            # drain in priority order so the group preserves dispatch order
            while self._heap and len(group) < self.group_max:
                item = heapq.heappop(self._heap)
                if item[2].request.signature == sig:
                    group.append(item[2])
                else:
                    keep.append(item)
            for item in keep:
                heapq.heappush(self._heap, item)
            return group
