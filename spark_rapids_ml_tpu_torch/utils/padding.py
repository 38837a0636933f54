"""Shape-bucket padding: funnel ragged batch sizes into few program shapes.

Counterpart of the JAX package's ``utils/padding.py``. Serving rounds every
coalesced batch up to the nearest configured **row bucket** (powers of two
by default), so steady-state traffic runs one program shape per bucket and
its outputs can be held against the JAX package at the bucket shape. The
serving products are row-independent (X @ PC), so a real row's output does
not depend on the zero rows below it; the pad rows are sliced off before any
caller sees them.

``StagingPool`` is where the port differs: on the card its buffers are
**pinned** host memory, and the host→device copy that reads a buffer runs
asynchronously on a copy stream. A buffer may therefore be rewritten only
once the copy that read it has finished, whatever the rotation count: each
slot carries the copy's CUDA event (``fence``) and ``fill`` waits on it
before writing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# Below this row count every batch shares ONE bucket: tiny interactive
# requests (1..8 rows) should hit a single program shape, not four.
MIN_BUCKET_ROWS = 8


def default_buckets(max_rows: int) -> Tuple[int, ...]:
    """The power-of-two bucket ladder up to (at least) ``max_rows``:
    ``(8, 16, 32, ..., next_pow2(max_rows))``."""
    out = []
    b = MIN_BUCKET_ROWS
    while True:
        out.append(b)
        if b >= max_rows:
            return tuple(out)
        b *= 2


def bucket_for(n_rows: int, buckets: Optional[Sequence[int]] = None) -> int:
    """The row bucket a batch of ``n_rows`` pads up to.

    With an explicit ``buckets`` ladder: the smallest bucket >= n_rows;
    past the largest (the engine caps batches at the top bucket) the next
    power of two. Without one: the next power of two, floored at
    ``MIN_BUCKET_ROWS``.
    """
    if n_rows < 1:
        raise ValueError(f"n_rows must be >= 1, got {n_rows}")
    if buckets:
        for b in sorted(int(v) for v in buckets):
            if b >= n_rows:
                return b
    b = MIN_BUCKET_ROWS
    while b < n_rows:
        b *= 2
    return b


def pad_to_bucket(
    rows: np.ndarray, buckets: Optional[Sequence[int]] = None
) -> Tuple[np.ndarray, int]:
    """Pad a (n, d) row matrix up to its shape bucket with zero rows.

    Returns ``(padded, n)`` with ``padded.shape[0] == bucket_for(n)`` and
    ``n`` the original row count, which the caller slices back to. A batch
    already on a bucket boundary, and an empty batch, are returned as-is.
    """
    rows = np.asarray(rows)
    if rows.ndim != 2:
        raise ValueError(f"expected a (n, d) matrix, got shape {rows.shape}")
    n = int(rows.shape[0])
    if n == 0:
        return rows, 0
    bucket = bucket_for(n, buckets)
    if bucket == n:
        return rows, n
    return np.pad(rows, ((0, bucket - n), (0, 0))), n


def padding_waste(n_rows: int, bucket: int) -> float:
    """Fraction of the padded batch that is filler (0.0 on exact fit)."""
    if bucket <= 0:
        return 0.0
    return max(bucket - n_rows, 0) / bucket


class _Slot:
    __slots__ = ("array", "tensor", "fence")

    def __init__(self, shape, dtype: np.dtype, pinned: bool):
        if pinned:
            # page-locked, so the copy stream's non_blocking copy is a real
            # asynchronous DMA; written through its numpy view
            self.tensor = torch.from_numpy(
                np.zeros(shape, dtype=dtype)).pin_memory()
            self.array = self.tensor.numpy()
        else:
            self.tensor = None
            self.array = np.zeros(shape, dtype=dtype)
        self.fence = None  # the event of the last copy that read the slot


class StagingPool:
    """Per-bucket reusable host staging arrays for the pipelined batcher.

    Each request's rows are written straight into a preallocated
    (bucket, d) array (only the padding tail is zeroed), which then goes to
    ``ServingProgram.put``. Buffers rotate over ``slots`` entries per
    (bucket, d) shape; the batcher sizes it at ``pipeline_depth + 2``.

    ``pinned=True`` (the card) allocates page-locked buffers, and reuse is
    tied to the copy that read a buffer: after ``put`` the batcher hands
    the copy's event to ``fence``, and ``fill`` synchronises on a slot's
    event before writing into it. The exact-fit shortcut (a lone request
    already on its bucket, handed over uncopied) applies only to an
    unpinned pool: on the card the request is copied into a pinned slot so
    its host→device copy stays asynchronous.

    Single-writer by design: only one worker thread fills a pool (each
    worker generation builds its own).
    """

    def __init__(self, dtype=np.float64, slots: int = 3,
                 pinned: bool = False):
        self.dtype = np.dtype(dtype)
        self.slots = max(int(slots), 2)
        self.pinned = bool(pinned)
        # (bucket, d) -> {"slots": [...], "next": int}; allocated lazily
        self._pools: dict = {}
        self._by_id: dict = {}  # id(array) -> its slot, for fence()

    def fill(self, parts: Sequence[np.ndarray],
             buckets: Optional[Sequence[int]] = None,
             ) -> Tuple[np.ndarray, int]:
        """Stage one coalesced batch: ``(staged, n)`` where ``staged`` is
        the (bucket, d) array holding the ``parts`` row blocks in order
        with a zeroed padding tail, and ``n`` is the real row count."""
        if not parts:
            raise ValueError("cannot stage an empty batch")
        n = sum(int(p.shape[0]) for p in parts)
        d = int(parts[0].shape[1])
        for p in parts[1:]:
            # the slice assignment below would silently BROADCAST a
            # width-1 block across all d features
            if int(p.shape[1]) != d:
                raise ValueError(
                    f"cannot coalesce a {p.shape[1]}-feature request "
                    f"into a {d}-feature batch"
                )
        bucket = bucket_for(n, buckets)
        if (not self.pinned and len(parts) == 1 and bucket == n
                and parts[0].dtype == self.dtype):
            return parts[0], n  # exact fit: no copy, like pad_to_bucket
        key = (bucket, d)
        pool = self._pools.get(key)
        if pool is None:
            pool = {"slots": [], "next": 0}
            self._pools[key] = pool
        slots = pool["slots"]
        idx = pool["next"]
        if idx >= len(slots):
            slot = _Slot((bucket, d), self.dtype, self.pinned)
            slots.append(slot)
            self._by_id[id(slot.array)] = slot
        slot = slots[idx]
        pool["next"] = (idx + 1) % self.slots
        if slot.fence is not None:
            slot.fence.synchronize()  # the copy that read it has finished
            slot.fence = None
        staged = slot.array
        offset = 0
        for p in parts:
            rows = int(p.shape[0])
            staged[offset:offset + rows] = p  # coerces dtype if needed
            offset += rows
        if offset < bucket:
            staged[offset:] = 0.0  # the reused buffer's stale tail
        return staged, n

    def fence(self, staged: np.ndarray, event) -> None:
        """Tie the slot holding ``staged`` to ``event`` (the copy that
        reads it): the slot is not rewritten before the event completes.
        A no-op for an array the pool does not own or a None event."""
        slot = self._by_id.get(id(staged))
        if slot is not None and slot.array is staged:
            slot.fence = event
