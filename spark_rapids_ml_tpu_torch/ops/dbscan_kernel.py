"""DBSCAN on the device: ε-graph construction + min-label propagation.

Counterpart of the JAX package's ``ops/dbscan_kernel.py``, which XLA
compiled (no Pallas kernel), so here it is PyTorch ops. The formulation is
the JAX package's:

* the ε-neighbourhood graph is dense pairwise-distance blocks
  (``ops/knn_kernel.pairwise_sqdist``, float32 distances taken in float64
  and rounded once), compared with ε² in the data's dtype;
* connected components of the core-point graph come from iterated
  min-label propagation, ``label[i] ← min(label[j] : j core neighbour)``;
* border points take the minimum core-neighbour label in one final sweep;
  noise is −1.

Labels ride as row indices in the data's dtype, as in the JAX package
(exact up to ``LABEL_ENVELOPE`` = 2²⁴ rows at float32; callers refuse
more, as JAX's do).

Two differences from the JAX package, both by design:

* each ``lax.while_loop`` is a host loop (``_propagate``) with one scalar
  read per sweep, the standing decision taken for Lloyd's loop;
* each ``lax.map`` over row blocks is a Python loop over (block_rows × n)
  panels, so peak memory stays one panel (the dense kernel holds the whole
  n × n adjacency, as JAX's does, as booleans).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from spark_rapids_ml_tpu_torch.ops.knn_kernel import _inf, pairwise_sqdist

LABEL_ENVELOPE = 2 ** 24


def _eps_squared(eps, x: torch.Tensor) -> torch.Tensor:
    """ε² taken in x's dtype, as the JAX package squares a dtype scalar."""
    e = torch.as_tensor(eps, dtype=x.dtype, device=x.device)
    return e * e


def _propagate(labels: torch.Tensor, core: torch.Tensor,
               neighbor_min: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """Min-label propagation to its fixed point: every sweep is one
    ``neighbor_min`` over the graph and one scalar read of whether any
    label moved (the JAX package's ``lax.while_loop``)."""
    inf = _inf(labels)
    while True:
        nxt = torch.minimum(labels, torch.where(core, neighbor_min(labels),
                                                inf))
        moved = bool((nxt != labels).any())
        labels = nxt
        if not moved:
            return labels


def _finish(core, labels_core, border_label, valid=None):
    """Core points keep their component's label, the rest the border
    sweep's; rows with neither (and invalid rows) are noise, −1."""
    final = torch.where(core, labels_core, border_label)
    if valid is not None:
        final = torch.where(valid, final, _inf(final))
    minus_one = torch.full((), -1, dtype=final.dtype, device=final.device)
    return torch.where(torch.isfinite(final), final, minus_one).to(
        torch.int32)


def dbscan_labels(
    x: torch.Tensor, eps, min_pts: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels[n] int32, core_mask[n] bool) for one device-resident batch.

    Labels are cluster representatives (the minimum row index in each
    cluster); the estimator relabels to consecutive ids on the host.
    Noise rows get −1."""
    n = x.shape[0]
    adj = pairwise_sqdist(x, x) <= _eps_squared(eps, x)  # includes self
    core = adj.sum(dim=1) >= min_pts
    inf = _inf(x)
    labels0 = torch.where(core, torch.arange(n, dtype=x.dtype,
                                             device=x.device), inf)
    # propagation flows only through core points (border points never
    # bridge clusters)
    adj &= core[None, :]

    def neighbor_min(labels):
        return torch.where(adj, labels[None, :], inf).amin(dim=1)

    labels_core = _propagate(labels0, core, neighbor_min)
    return _finish(core, labels_core, neighbor_min(labels_core)), core


def dbscan_labels_blocked(
    x: torch.Tensor,
    valid: torch.Tensor,
    eps,
    min_pts: int,
    block_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dbscan_labels`` semantics with the ε-graph tiled over row blocks.

    Every pass (the degrees, each propagation sweep, the border sweep)
    recomputes one (block_rows × n) distance panel at a time, so peak
    memory is one panel and n reaches the hundreds of thousands.

    ``x`` must be padded to a multiple of ``block_rows``; ``valid`` marks
    real rows (padded rows are never core, never neighbours, label −1)."""
    n = x.shape[0]
    if n % block_rows:
        raise ValueError(
            f"{n} rows is not a multiple of block_rows = {block_rows}")
    eps2 = _eps_squared(eps, x)
    valid = valid.to(device=x.device, dtype=torch.bool)
    inf = _inf(x)
    blocks = x.split(block_rows)

    def panels(columns: torch.Tensor):
        """Each block's ε-adjacency to the ``columns`` rows."""
        for xi in blocks:
            yield (pairwise_sqdist(xi, x) <= eps2) & columns[None, :]

    degree = torch.cat([adj.sum(dim=1) for adj in panels(valid)])
    core = (degree >= min_pts) & valid
    labels0 = torch.where(core, torch.arange(n, dtype=x.dtype,
                                             device=x.device), inf)

    def neighbor_min(labels):
        return torch.cat([torch.where(adj, labels[None, :], inf).amin(dim=1)
                          for adj in panels(core)])

    labels_core = _propagate(labels0, core, neighbor_min)
    return _finish(core, labels_core, neighbor_min(labels_core), valid), core
