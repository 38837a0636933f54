"""Weighted-fair request scheduling for the micro-batcher queues.

The port's copy of the JAX package's ``serve/scheduler.py``: the same
request stream gives the same dequeue order, victims and sweeps in both
packages. A FIFO micro-batcher serves its bounded queue FIFO — which
means one tenant's burst owns the queue and every other caller waits
behind it. This module replaces the queue DISCIPLINE (not the queue
bound, not the coalescer) with **start-time fair queuing (SFQ)** over
row-cost virtual time, the classic packet-scheduling algorithm applied
to predict requests:

* each request belongs to a **flow** ``(tenant, priority)`` and costs
  its row count divided by the flow's weight
  (``tenant_weight × priority_weight``, over-quota requests further
  demoted by ``DEFAULT_OVER_QUOTA_FACTOR``);
* a request's **start tag** is ``max(virtual_time,
  flow's_last_finish_tag)`` and its finish tag is
  ``start + rows / weight``; the queue always dispatches the pending
  request with the smallest start tag (FIFO among equals via a
  sequence tiebreak), and virtual time advances to the dispatched
  start tag;

so a tenant that floods the queue only advances its OWN virtual
timeline — its requests' tags race ahead while a compliant tenant's
stay at the current virtual time and keep winning the dequeue. Fairness
is proportional to weight, work-conserving (an idle flow donates its
share), and O(depth) per operation — the queue is bounded at
``max_queue_depth`` (≤ a few hundred), so linear scans beat the
bookkeeping of a heap with arbitrary eviction.

**Priority preemption.** Under pressure (the shed controller's
``pressure_fn``), dequeue considers interactive requests first — batch
work drains only when no interactive request is pending. And when the
queue is FULL, an arriving request may **evict** a strictly
lower-ranked victim (rank: in-quota interactive > over-quota
interactive > in-quota batch > over-quota batch; the victim with the
LATEST finish tag — the least-entitled work — goes first): the victim
is shed with ``ShedLoad``, the arrival takes its slot. FIFO had only
"reject the newcomer", which let queued batch work starve an
interactive burst.

**Kill switch**: ``SPARK_RAPIDS_ML_TORCH_SERVE_SCHED=fifo`` (or ``0``)
restores the plain FIFO deque bit-for-bit — ``FifoQueue`` is a thin
wrapper over ``collections.deque`` with no reordering and no
preemption. With a single flow (every request the same
tenant/priority), ``FairQueue`` also degenerates to exact FIFO order
(monotone start tags, sequence tiebreak), so default single-tenant
traffic is unchanged either way.
"""

from __future__ import annotations

import collections
import os
from typing import Callable, Dict, List, Optional, Tuple

from spark_rapids_ml_tpu_torch.serve.admission import BATCH, INTERACTIVE

SCHED_ENV = "SPARK_RAPIDS_ML_TORCH_SERVE_SCHED"

# Priority-class weights: interactive work advances its virtual time 4x
# slower per row, so it wins ~4/5 of contended dispatches even before
# pressure-mode strict preemption kicks in.
DEFAULT_PRIORITY_WEIGHTS = {INTERACTIVE: 4.0, BATCH: 1.0}
DEFAULT_OVER_QUOTA_FACTOR = 0.25


def fair_scheduling_from_env(default: bool = True) -> bool:
    """Whether the weighted-fair queue is enabled (the kill switch:
    ``fifo``/``0``/``off`` restores plain FIFO)."""
    raw = os.environ.get(SCHED_ENV, "").strip().lower()
    if not raw:
        return default
    return raw not in ("fifo", "0", "off", "false")


class FifoQueue:
    """The pre-scheduler discipline, bit-for-bit: a bounded-by-caller
    FIFO deque. No reordering, no preemption (``select_victim`` always
    declines, so a full queue rejects the newcomer exactly as before)."""

    def __init__(self):
        self._q: collections.deque = collections.deque()

    def append(self, req) -> None:
        self._q.append(req)

    def popleft(self):
        return self._q.popleft()

    def peek(self):
        return self._q[0]

    def select_victim(self, candidate) -> Optional[object]:
        return None

    def pop_expired(self, now: Optional[float] = None) -> list:
        """FIFO sheds expired requests only as they reach the head —
        the exact pre-scheduler behavior (the head always drains, so
        FIFO cannot starve an expired entry the way a policy pick
        can)."""
        return []

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


class _Entry:
    __slots__ = ("req", "start", "finish", "seq")

    def __init__(self, req, start: float, finish: float, seq: int):
        self.req = req
        self.start = start
        self.finish = finish
        self.seq = seq


def _rank(req) -> int:
    """Preemption rank (higher = more entitled to a queue slot)."""
    interactive = getattr(req, "priority", INTERACTIVE) != BATCH
    over = bool(getattr(req, "over_quota", False))
    return (2 if interactive else 0) + (0 if over else 1)


class FairQueue:
    """Start-time fair queuing over row-cost virtual time.

    NOT thread-safe by itself — every call site in ``MicroBatcher``
    already runs under the batcher lock, exactly like the deque it
    replaces. ``pressure_fn`` (optional) flips strict
    interactive-first dequeue on while the shed controller reports
    pressure."""

    def __init__(
        self,
        *,
        tenant_weights: Optional[Dict[str, float]] = None,
        pressure_fn: Optional[Callable[[], bool]] = None,
    ):
        self.tenant_weights = dict(tenant_weights or {})
        self.pressure_fn = pressure_fn
        self._entries: List[_Entry] = []
        self._vtime = 0.0
        self._finish_tags: Dict[Tuple[str, str], float] = {}
        self._seq = 0
        # peek/pop coherence: _pick re-evaluates pressure_fn, which
        # other threads mutate (the shed controller) — a pressure flip
        # between the worker's peek and its popleft would batch one
        # request while silently removing ANOTHER (the removed one then
        # hangs to its wait timeout). peek caches its choice; popleft
        # honors the cache while the queue is unmutated.
        self._mutations = 0
        self._peeked: Optional[Tuple[int, int]] = None

    # -- the discipline ----------------------------------------------------

    def _weight(self, req) -> float:
        tenant = getattr(req, "tenant", "default")
        priority = getattr(req, "priority", INTERACTIVE)
        weight = (float(self.tenant_weights.get(tenant, 1.0))
                  * DEFAULT_PRIORITY_WEIGHTS.get(priority, 1.0))
        if getattr(req, "over_quota", False):
            weight *= DEFAULT_OVER_QUOTA_FACTOR
        return max(weight, 1e-9)

    def append(self, req) -> None:
        flow = (getattr(req, "tenant", "default"),
                getattr(req, "priority", INTERACTIVE))
        start = max(self._vtime, self._finish_tags.get(flow, 0.0))
        finish = start + max(int(getattr(req, "n", 1)), 1) / \
            self._weight(req)
        self._finish_tags[flow] = finish
        self._entries.append(_Entry(req, start, finish, self._seq))
        self._seq += 1
        self._mutations += 1
        self._peeked = None
        if len(self._finish_tags) > 4096:
            # idle-flow tags at/behind virtual time carry no state
            self._finish_tags = {
                k: v for k, v in self._finish_tags.items()
                if v > self._vtime
            }

    def _pick(self) -> int:
        entries = self._entries
        pool = range(len(entries))
        if self.pressure_fn is not None and self.pressure_fn():
            interactive = [i for i in pool
                           if getattr(entries[i].req, "priority",
                                      INTERACTIVE) != BATCH]
            if interactive:
                pool = interactive
        return min(pool, key=lambda i: (entries[i].start,
                                        entries[i].seq))

    def popleft(self):
        if not self._entries:
            raise IndexError("pop from an empty FairQueue")
        if (self._peeked is not None
                and self._peeked[0] == self._mutations):
            idx = self._peeked[1]
        else:
            idx = self._pick()
        self._peeked = None
        self._mutations += 1
        entry = self._entries.pop(idx)
        self._vtime = max(self._vtime, entry.start)
        return entry.req

    def peek(self):
        if not self._entries:
            raise IndexError("peek into an empty FairQueue")
        idx = self._pick()
        self._peeked = (self._mutations, idx)
        return self._entries[idx].req

    def pop_expired(self, now: Optional[float] = None) -> List[object]:
        """Remove and return EVERY queued request whose deadline has
        passed — not just whichever one the policy would pick next.
        Under pressure the strict interactive-first pick never reaches
        queued batch entries, so without a whole-queue sweep an expired
        batch request would neither be served nor deadline-shed: its
        client would hang to the full wait timeout while the dead entry
        pinned queue depth (and with it the pressure signal itself)."""
        expired: List[object] = []
        keep: List[_Entry] = []
        for entry in self._entries:
            check = getattr(entry.req, "expired", None)
            if callable(check) and check(now):
                expired.append(entry.req)
            else:
                keep.append(entry)
        if expired:
            self._entries = keep
            self._mutations += 1
            self._peeked = None
        return expired

    def select_victim(self, candidate) -> Optional[object]:
        """On a full queue: the queued request an arriving ``candidate``
        may preempt, or None (candidate is rejected instead). Only a
        STRICTLY lower-ranked request is evictable; among those, the
        lowest rank first, then the latest finish tag (the
        least-entitled virtual service), then the newest arrival."""
        cand_rank = _rank(candidate)
        best: Optional[int] = None
        for i, entry in enumerate(self._entries):
            if _rank(entry.req) >= cand_rank:
                continue
            if best is None:
                best = i
                continue
            cur = self._entries[best]
            key = (_rank(entry.req), -entry.finish, -entry.seq)
            cur_key = (_rank(cur.req), -cur.finish, -cur.seq)
            if key < cur_key:
                best = i
        if best is None:
            return None
        self._mutations += 1
        self._peeked = None
        entry = self._entries.pop(best)
        # roll back the flow's virtual time for work it will never get:
        # without this a repeatedly-preempted flow accumulates phantom
        # finish tags and receives less than its weighted share even
        # for requests that ARE served. Only exact when the victim was
        # its flow's latest-appended entry — which the max-finish
        # victim choice makes the common case.
        flow = (getattr(entry.req, "tenant", "default"),
                getattr(entry.req, "priority", INTERACTIVE))
        if self._finish_tags.get(flow) == entry.finish:
            self._finish_tags[flow] = entry.start
        return entry.req

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)


__all__ = [
    "DEFAULT_OVER_QUOTA_FACTOR",
    "DEFAULT_PRIORITY_WEIGHTS",
    "FairQueue",
    "FifoQueue",
    "SCHED_ENV",
    "fair_scheduling_from_env",
]
