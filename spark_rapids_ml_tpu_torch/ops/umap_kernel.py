"""UMAP on the device: fuzzy graph, spectral and PCA inits, dense and tiled
force optimization.

Counterpart of the JAX package's ``ops/umap_kernel.py``, with the same
construction: the kNN graph from the exact brute-force search
(``ops/knn_kernel.py``), per-point bandwidths (ρ, σ) by a bisection of
exactly 32 steps over all rows at once, and full-batch dense forces in
place of UMAP's sequential SGD with negative sampling. The JAX package
writes none of it in Pallas (its products are ``jnp`` / ``lax`` code), so
here it is PyTorch ops on tensors of an explicit device, and each
optimizer's epochs are a host loop over eager ops where JAX's are a
``lax.fori_loop``.

Three properties the JAX functions get from XLA on the TPU, which eager
PyTorch on the card must get by construction:

* **No TF32.** Every pairwise distance goes through
  ``ops/knn_kernel.pairwise_sqdist``: taken in float64 and rounded once
  for float32 inputs. The force's product W·Y (``_net_force``) is taken
  in float64 and rounded once as well, and the transform's weighted
  average is an elementwise reduction (``models/umap.py``). So no
  process-wide ``torch.set_float32_matmul_precision("high")`` reaches a
  product of the path, and a float32 fit gives the same bits under it.
* **Deterministic edge sums.** JAX's tiled optimizer sums the edge forces
  with ``jax.ops.segment_sum``; CUDA's ``index_add_`` sums with atomics,
  whose order changes from run to run, and the dynamics amplify rounding
  about 1000× per epoch. ``SegmentSum`` sorts the edges once on the host
  by each endpoint and sums each endpoint's rows in a fixed order,
  without atomics, so two fits from one seed give the same bits.
* **The inits' freedom is JAX's.** ``spectral_init`` takes
  ``torch.linalg.eigh`` (cuSOLVER on the card, LAPACK on the CPU); on a
  disconnected graph the eigenvalue 0 repeats and the two libraries may
  return different bases of its null space, and on a connected one the
  columns' signs may differ. ``pca_init`` has the same sign freedom. Both
  are deliberate differences (ROADMAP queue 3 item 22); tests align signs
  on a connected graph.

``optimize_embedding_blocked`` also takes a ragged last block: the JAX
function needs n to be a multiple of ``block_rows`` (one compiled
``lax.map`` shape); eager ops need no padding, and a padded input with its
``valid`` mask gives the JAX function's answer.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops.kmeans_kernel import _wide
from spark_rapids_ml_tpu_torch.ops.knn_kernel import pairwise_sqdist

# the bisection's bracket and step count, as the JAX package's
CALIBRATION_STEPS = 32
SIGMA_LO = 1e-8
SIGMA_HI = 1e3
# φ's regularizer in the repulsion, and the clips of the weights and steps
EPS = 1e-3
WEIGHT_CLIP = 1e4
STEP_CLIP = 4.0
# rows per piece of a segmented sum (``SegmentSum``)
SEGMENT_WIDTH = 32


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype and device: the JAX
    package hands the optimizers ``jnp.asarray(value, dtype)``, so each
    constant is rounded to the fit's dtype once."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def smooth_knn_calibration(
    knn_dists: torch.Tensor, n_iter: int = CALIBRATION_STEPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rho[n], sigma[n]): UMAP's smooth-kNN distance calibration.

    ρᵢ = distance to the nearest neighbor (local connectivity 1); σᵢ
    solves Σⱼ exp(−max(dᵢⱼ−ρᵢ,0)/σᵢ) = log₂(k) by bisection, all rows at
    once, exactly ``n_iter`` steps from [1e-8, 1e3]. Rows whose σ ends at
    the lower bracket (all distances equal) fall back to their mean
    distance, at least 1e-3."""
    k = knn_dists.shape[1]
    rho = knn_dists[:, 0]
    target = torch.log2(_scalar(float(k), knn_dists))
    shifted = torch.clamp_min(knn_dists - rho[:, None], 0.0)
    lo = torch.full_like(rho, SIGMA_LO)
    hi = torch.full_like(rho, SIGMA_HI)
    for _ in range(n_iter):
        mid = (lo + hi) / 2.0
        # sum too large ⇒ shrink sigma
        too_big = torch.exp(-shifted / mid[:, None]).sum(dim=1) > target
        lo = torch.where(too_big, lo, mid)
        hi = torch.where(too_big, mid, hi)
    sigma = (lo + hi) / 2.0
    mean_d = knn_dists.mean(dim=1)
    return rho, torch.where(sigma <= 2e-8, torch.clamp_min(mean_d, 1e-3),
                            sigma)


def memberships(knn_dists: torch.Tensor) -> torch.Tensor:
    """μᵢⱼ = exp(−max(dᵢⱼ−ρᵢ,0)/σᵢ) over each row's k neighbors."""
    rho, sigma = smooth_knn_calibration(knn_dists)
    return torch.exp(-torch.clamp_min(knn_dists - rho[:, None], 0.0)
                     / sigma[:, None])


def fuzzy_graph(
    knn_dists: torch.Tensor, knn_idx: torch.Tensor, n: int
) -> torch.Tensor:
    """Dense symmetrized membership matrix P (n×n) from kNN distances.

    μ scattered into rows by maximum (JAX's ``.at[].max`` on zeros), then
    the fuzzy-set union P = μ + μᵀ − μ∘μᵀ (probabilistic t-conorm),
    diagonal zeroed."""
    mu = memberships(knn_dists)
    k = knn_dists.shape[1]
    rows = torch.arange(n, device=mu.device).repeat_interleave(k)
    flat = rows * n + knn_idx.reshape(-1).to(rows.dtype)
    p = torch.zeros((n, n), dtype=mu.dtype, device=mu.device)
    p.view(-1).scatter_reduce_(0, flat, mu.reshape(-1), "amax")
    pt = p.T
    p = p + pt - p * pt
    return p.fill_diagonal_(0.0)


def spectral_init(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Embedding init from the normalized graph Laplacian's bottom
    non-trivial eigenvectors, scaled to UMAP's conventional ±10 box. An
    ``eigh`` that fails raises; nothing carries on on the CPU."""
    deg = p.sum(dim=1)
    inv_sqrt = 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12))
    # I − D^-½ P D^-½, with P's diagonal 0: the identity adds 1 there only
    lap = (inv_sqrt[:, None] * p).mul_(inv_sqrt[None, :]).neg_()
    lap.diagonal().add_(1.0)
    _, vecs = torch.linalg.eigh(lap)
    del lap
    emb = vecs[:, 1:dim + 1]
    scale = 10.0 / torch.clamp_min(emb.abs().max(), 1e-12)
    return emb * scale


def _net_force(w: torch.Tensor, yi: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """rowsum(W)·Yᵢ − W·Y, the force of the weights W (rows of Yᵢ against
    all of Y), in W's dtype. A float32 W is taken in float64 and rounded
    once, so no TF32 setting reaches the product (``ops/pca_kernel.
    _project``'s rule); float64 is the JAX package's arithmetic."""
    ww = _wide(w)
    force = ww.sum(dim=1, keepdim=True) * _wide(yi) - ww @ _wide(y)
    return force.to(w.dtype)


def _step(y: torch.Tensor, force: torch.Tensor, learning_rate: torch.Tensor,
          epoch: int, n_epochs: int) -> torch.Tensor:
    """y + clip(α·force, ±4), α decaying linearly to 0 (UMAP's schedule)."""
    alpha = learning_rate * (1.0 - epoch / n_epochs)
    return y + torch.clamp(alpha * force, -STEP_CLIP, STEP_CLIP)


def optimize_embedding(
    p: torch.Tensor,
    emb0: torch.Tensor,
    a,
    b,
    learning_rate,
    repulsion_strength,
    n_epochs: int,
) -> torch.Tensor:
    """Full-batch dense-force descent of the UMAP cross-entropy.

    Attraction weight on pair (i,j):  P·(−2ab·d^{2(b−1)})/(1+a·d^{2b});
    repulsion weight: (1−P)·(2γb)/((ε+d²)(1+a·d^{2b})). The weights are
    clipped to ±1e4 (for b < 1 the attraction diverges as d → 0), the net
    force is F = diag(rowsum W)·Y − W·Y, and the step α·F is clipped to
    ±4 with α decaying linearly to zero. One epoch per host iteration."""
    y = emb0
    a, b = _scalar(a, y), _scalar(b, y)
    lr = _scalar(learning_rate, y)
    gamma = _scalar(repulsion_strength, y)
    for epoch in range(n_epochs):
        # the JAX package's expressions, in its order of operations; the
        # in-place forms only spare n×n temporaries
        d2 = pairwise_sqdist(y, y)
        d2c = torch.clamp_min(d2, 1e-12)
        d2b = torch.pow(d2c, b)
        denom = 1.0 + a * d2b
        w = (-2.0 * a * b * d2b).div_(d2c).mul_(p).div_(denom)
        w.clamp_(-WEIGHT_CLIP, 0.0)                     # attraction
        del d2c, d2b
        rep = (1.0 - p).mul_(2.0 * gamma * b).div_(d2.add_(EPS).mul_(denom))
        w += rep.clamp_(0.0, WEIGHT_CLIP)              # repulsion
        del d2, denom, rep
        w.fill_diagonal_(0.0)
        # force_i = Σⱼ wᵢⱼ (yᵢ − yⱼ): with w_att ≤ 0 and w_rep ≥ 0 this IS
        # the descent direction — attraction pulls, repulsion pushes
        y = _step(y, _net_force(w, y, y), lr, epoch, n_epochs)
    return y


class SegmentSum:
    """Row sums of values by segment, in a fixed order and without
    atomics: ``jax.ops.segment_sum(values, segment_ids, num_segments)``
    whose bits do not change from run to run on the card.

    Built once on the host from the segment ids. Each level groups every
    segment's rows into pieces of at most ``width`` (the rows in their
    original order, a short piece padded with zero rows) and sums each
    piece left to right, one elementwise add per column of the piece; the
    next level sums the pieces of the segments that had more than one,
    until each segment has one row, which is written to its place. So a
    segment of at most ``width`` rows is summed in the order of XLA's
    scatter-add on the CPU, 0 + v₁ + v₂ + …, and every order depends on
    the segment ids alone."""

    def __init__(self, segment_ids, num_segments: int, device,
                 width: int = SEGMENT_WIDTH):
        seg = np.asarray(segment_ids, dtype=np.int64).reshape(-1)
        self.num_segments = int(num_segments)
        entries = np.argsort(seg, kind="stable")   # rows grouped by segment
        owner = seg[entries]
        n_rows = len(seg)                          # the level's value rows
        self.levels: List[torch.Tensor] = []
        while True:
            counts = np.bincount(owner, minlength=self.num_segments)
            cols = int(min(width, counts.max(initial=1)))
            pos = np.arange(len(owner)) - (np.cumsum(counts) - counts)[owner]
            pieces = -(-counts // cols)
            piece = (np.cumsum(pieces) - pieces)[owner] + pos // cols
            # row n_rows is the zero row appended to the level's values
            table = np.full((int(pieces.sum()), cols), n_rows, np.int64)
            table[piece, pos % cols] = entries
            self.levels.append(torch.as_tensor(table, device=device))
            owner = np.repeat(np.arange(self.num_segments), pieces)
            n_rows = len(owner)
            entries = np.arange(n_rows)
            if pieces.max(initial=0) <= 1:
                break
        self.segments = torch.as_tensor(owner, device=device)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        for table in self.levels:
            zero = values.new_zeros((1,) + values.shape[1:])
            rows = torch.cat([values, zero])[table]
            values = rows[:, 0]
            for col in range(1, table.shape[1]):
                values = values + rows[:, col]
        out = values.new_zeros((self.num_segments,) + values.shape[1:])
        out[self.segments] = values
        return out


def symmetric_edge_list(mu, knn_idx, n: int):
    """Host-side sparse fuzzy-set union: the (i<j, P_ij) edge list.

    The dense kernel scatters μ into an n×n matrix and unions with its
    transpose (``fuzzy_graph``); at large n that matrix is the memory
    wall, but the UNION only has support on kNN edges — at most 2·n·k of
    them. NumPy assembly: dedupe directed duplicates by max (the
    ``.at[].max`` semantics), then P = μ_ij + μ_ji − μ_ij·μ_ji per
    undirected pair. Returns (edge_i, edge_j, p) int32/int32/f64 arrays.
    The JAX package's NumPy function, copied."""
    mu = np.asarray(mu, dtype=np.float64)
    idx = np.asarray(knn_idx, dtype=np.int64)
    k = mu.shape[1]
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = idx.reshape(-1)
    vals = mu.reshape(-1)
    keep = rows != cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    # directed key → max over duplicates
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    uniq, start = np.unique(key, return_index=True)
    dmax = np.maximum.reduceat(vals, start)
    # pair up (i→j) with (j→i): canonical undirected key
    di, dj = uniq // n, uniq % n
    lo, hi = np.minimum(di, dj), np.maximum(di, dj)
    ukey = lo * n + hi
    forward = di < dj
    uorder = np.argsort(ukey, kind="stable")
    ukey_s = ukey[uorder]
    w_s = dmax[uorder]
    fwd_s = forward[uorder]
    uu, _ = np.unique(ukey_s, return_index=True)
    # each undirected key appears once or twice; accumulate both directions
    w_ij = np.zeros(len(uu))
    w_ji = np.zeros(len(uu))
    pos = np.searchsorted(uu, ukey_s)
    np.maximum.at(w_ij, pos[fwd_s], w_s[fwd_s])
    np.maximum.at(w_ji, pos[~fwd_s], w_s[~fwd_s])
    p = w_ij + w_ji - w_ij * w_ji
    return (
        (uu // n).astype(np.int32),
        (uu % n).astype(np.int32),
        p,
    )


def pca_init(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Embedding init from the top principal components, scaled to the
    conventional ±10 box — umap-learn's ``init='pca'``. The tiled large-n
    path uses this instead of the dense spectral init (whose n×n
    Laplacian eigh is the O(n³) wall the path exists to avoid). The
    port's covariance / eigh chain: a float32 x reaches the hand Gram
    kernel at the default precision; the projection is taken in float64
    and rounded once, as ``_net_force``."""
    from spark_rapids_ml_tpu_torch.ops.covariance import (
        column_means,
        covariance,
    )
    from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance

    mean = column_means(x)
    comps, _ = pca_from_covariance(
        covariance(x, mean=mean), dim, flip_signs=False, solver="eigh"
    )
    xc = x - mean[None, :]
    emb = (_wide(xc) @ _wide(comps)).to(x.dtype)
    scale = 10.0 / torch.clamp_min(emb.abs().max(), 1e-12)
    return emb * scale


class EdgeForces:
    """The attraction and the −P·repulsion correction of a symmetric edge
    list (support only on graph edges), with ``SegmentSum`` plans for
    both endpoints built once. ``mask`` (0/1 per edge) zeroes padded
    edges, as the sharded optimizer's slices need."""

    def __init__(self, edge_i, edge_j, edge_p: torch.Tensor, n: int,
                 mask: Optional[torch.Tensor] = None):
        device = edge_p.device
        ei = np.asarray(edge_i, dtype=np.int64)
        ej = np.asarray(edge_j, dtype=np.int64)
        self.ei = torch.as_tensor(ei, device=device)
        self.ej = torch.as_tensor(ej, device=device)
        self.p = edge_p
        self.mask = mask
        self.sum_i = SegmentSum(ei, n, device)
        self.sum_j = SegmentSum(ej, n, device)

    def __call__(self, y, a, b, gamma) -> torch.Tensor:
        yi, yj = y[self.ei], y[self.ej]
        diff = yi - yj
        d2 = torch.sum(diff ** 2, dim=1)
        d2c = torch.clamp_min(d2, 1e-12)
        d2b = torch.pow(d2c, b)
        denom = 1.0 + a * d2b
        w_att = torch.clamp(self.p * (-2.0 * a * b * d2b / d2c) / denom,
                            -WEIGHT_CLIP, 0.0)
        # the dense kernel's repulsion carries (1−P); the blocked pass
        # used 1, so subtract the P·repulsion part exactly on edges
        w_rep_corr = -torch.clamp(
            self.p * (2.0 * gamma * b) / ((EPS + d2) * denom),
            0.0, WEIGHT_CLIP)
        w = w_att + w_rep_corr
        if self.mask is not None:
            w = w * self.mask
        w_edge = w[:, None] * diff
        return self.sum_i(w_edge) - self.sum_j(w_edge)


def repulsion(yp: torch.Tensor, y: torch.Tensor, a, b, gamma,
              valid_f: Optional[torch.Tensor],
              block_rows: int) -> torch.Tensor:
    """The all-pairs repulsion (weight (2γb)/((ε+d²)(1+a·d^{2b})), support
    everywhere) on the rows ``yp`` from every row of ``y``, streamed over
    blocks of ``block_rows``: one (block × n) distance block alive at a
    time. ``valid_f`` (0/1 per row of ``y``) masks padding rows out as
    sources. Self-pairs need no masking: their force w_ii·(yᵢ−yᵢ) is
    identically zero in the rowsum(W)·Y − W·Y form."""
    c = 2.0 * gamma * b
    parts = []
    for yi in yp.split(block_rows):
        d2 = pairwise_sqdist(yi, y)
        # (ε + d²)(1 + a·d^{2b}), in the JAX package's order of operations
        den = torch.clamp_min(d2, 1e-12).pow_(b).mul_(a).add_(1.0)
        den.mul_(d2.add_(EPS))
        del d2
        w = torch.div(c, den, out=den).clamp_(0.0, WEIGHT_CLIP)
        if valid_f is not None:
            w.mul_(valid_f[None, :])
        parts.append(_net_force(w, yi, y))
        del w, den
    return torch.cat(parts)


def optimize_embedding_blocked(
    edge_i,                      # (nnz,) int, i < j
    edge_j,                      # (nnz,) int
    edge_p: torch.Tensor,        # (nnz,) membership P_ij
    emb0: torch.Tensor,          # (n, dim)
    valid: Optional[torch.Tensor],   # (n,) bool real rows, or None: all
    a,
    b,
    learning_rate,
    repulsion_strength,
    n_epochs: int,
    block_rows: int,
) -> torch.Tensor:
    """``optimize_embedding`` semantics with the n×n force matrix TILED.

    Same weights as the dense kernel, split by support: the all-pairs
    repulsion streams over row blocks (``repulsion``; peak memory one
    block_rows × n distance block); the attraction and the −P·repulsion
    correction ride the edge list with two fixed-order segmented sums
    (``EdgeForces``). n need not be a multiple of ``block_rows``."""
    y = emb0
    a, b = _scalar(a, y), _scalar(b, y)
    lr = _scalar(learning_rate, y)
    gamma = _scalar(repulsion_strength, y)
    valid_f = None if valid is None else valid.to(y.dtype)
    edges = EdgeForces(edge_i, edge_j, edge_p.to(y.dtype), y.shape[0])
    for epoch in range(n_epochs):
        force = repulsion(y, y, a, b, gamma, valid_f, block_rows)
        force += edges(y, a, b, gamma)
        y = _step(y, force, lr, epoch, n_epochs)
    return y


def fit_ab(min_dist: float, spread: float = 1.0) -> Tuple[float, float]:
    """Fit the (a, b) of φ(d)=1/(1+a·d^{2b}) to UMAP's target curve
    (1 for d<min_dist, exp(−(d−min_dist)/spread) beyond) — plain NumPy
    grid+refine least squares, no scipy dependency. The JAX package's
    NumPy function, copied."""
    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(
        xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread)
    )

    def loss(av, bv):
        return ((1.0 / (1.0 + av * xv ** (2 * bv)) - yv) ** 2).sum()

    best = (1.0, 1.0, loss(1.0, 1.0))
    grid_a = np.linspace(0.2, 10.0, 60)
    grid_b = np.linspace(0.3, 2.5, 60)
    for av in grid_a:
        for bv in grid_b:
            cur = loss(av, bv)
            if cur < best[2]:
                best = (av, bv, cur)
    av, bv, _ = best
    for _ in range(3):  # local refine
        da = np.linspace(av * 0.8, av * 1.2, 40)
        db = np.linspace(bv * 0.8, bv * 1.2, 40)
        for ai in da:
            for bi in db:
                cur = loss(ai, bi)
                if cur < best[2]:
                    best = (ai, bi, cur)
        av, bv, _ = best
    return float(av), float(bv)
