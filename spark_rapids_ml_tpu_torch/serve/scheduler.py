"""The micro-batcher's queue discipline.

The port's cut of the JAX package's ``serve/scheduler.py``: only
``FifoQueue``, the plain first-in-first-out deque. The weighted-fair
scheduler (start-time fair queuing over tenants and priorities) and the
admission controller that feeds it are not ported yet; the two priority
classes the batcher's request records carry are defined here, as in the
JAX package's ``serve/admission.py``.
"""

from __future__ import annotations

import collections

INTERACTIVE = "interactive"
BATCH = "batch"


class FifoQueue:
    """A FIFO deque, bounded by its caller: no reordering and no
    preemption, so a full queue rejects the newcomer, and expired requests
    are shed as they reach the head."""

    def __init__(self):
        self._q: collections.deque = collections.deque()

    def append(self, req) -> None:
        self._q.append(req)

    def popleft(self):
        return self._q.popleft()

    def peek(self):
        return self._q[0]

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


__all__ = ["BATCH", "FifoQueue", "INTERACTIVE"]
