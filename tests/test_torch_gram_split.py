"""The Gram's route plan (ops/fused_gram.gram_plan) and the arithmetic of its
split and narrow routes, on the CPU.

The routes run only on the card, where tests/test_torch_gpu.py and
chip_smoke.py hold them bit for bit against the whole-depth launch. Here:
the plan as a pure function of (rows, n, SMs); a float32 numpy emulation of
what the split and narrow launches do with a fold's partial sums (stored in
their workspace layouts, as csrc/fused_gram.cu writes them, then summed fold
by fold left to right by the reduce launch), bit-equal to the plain version
at highest on ragged depths; and the same result against the JAX package's
Pallas kernel in interpret mode, within the bar tests/test_torch_fused_gram.py
uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_gram import (
    fused_centered_gram as jax_fused_centered_gram,
)
from spark_rapids_ml_tpu_torch.ops import fused_gram
from spark_rapids_ml_tpu_torch.ops.fused_gram import (
    FOLD_ROWS,
    NARROW_KERNEL,
    fused_centered_gram_reference,
    gram_plan,
)

H100_SMS = 132
F32 = "fused_centered_gram_f32"
BF16X3 = "fused_centered_gram_bf16x3"
TILE = 64 * 256         # a 128 × 128 tile's fold slots
NARROW = 8 * 288        # the narrow kernel's fold slots


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


# (rows, n, precision) → (route, runs, folds, fold floats, CUDA launches,
# the ``launches`` key), on an H100's 132 SMs
PLANS = {
    "bucket, one fold": ((8192, 4096, "highest"),
                         ("tile128", 1, 1, 0, 2, F32)),
    "Hessian, 528 tiles": ((65_536, 4096, "highest"),
                           ("tile128", 1, 8, 528 * TILE, 2, F32)),
    "HIGGS, narrow": ((2_097_152, 28, "highest"),
                      ("narrow", 256, 256, 256 * NARROW, 2, NARROW_KERNEL)),
    "HIGGS, bfloat16_3x split": ((2_097_152, 28, "bfloat16_3x"),
                                 ("split", 256, 256, 256 * TILE, 3, BF16X3)),
    "MNIST, split": ((60_000, 784, "highest"),
                     ("split", 8, 8, 8 * 28 * TILE, 3, F32)),
    "MNIST, bfloat16_3x split": ((60_000, 784, "bfloat16_3x"),
                                 ("split", 8, 8, 8 * 28 * TILE, 3, BF16X3)),
    "multinomial partials": ((32_768, 256, "highest"),
                             ("split", 4, 4, 4 * 3 * TILE, 3, F32)),
    "narrow width, one fold": ((8192, 28, "highest"),
                               ("tile128", 1, 1, 0, 2, F32)),
    "the split's last width": ((65_536, 1920, "highest"),
                               ("split", 3, 8, 8 * 120 * TILE, 3, F32)),
    "past it": ((65_536, 2048, "highest"),
                ("tile128", 1, 8, 136 * TILE, 2, F32)),
    "narrow's last width": ((8193, 64, "highest"),
                            ("narrow", 2, 2, 2 * NARROW, 2, NARROW_KERNEL)),
    "past it, split": ((8193, 65, "highest"),
                       ("split", 2, 2, 2 * TILE, 3, F32)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_gram_plan(case):
    (rows, n, precision), want = PLANS[case]
    plan = gram_plan(rows, n, precision, H100_SMS)
    assert (plan.route, plan.runs, plan.folds, plan.fold_floats,
            plan.cuda_launches, plan.kernel) == want


@pytest.mark.parametrize("case", list(PLANS))
def test_one_run_forces_the_whole_depth_launch(case):
    (rows, n, precision), _ = PLANS[case]
    plan = gram_plan(rows, n, precision, H100_SMS, one_run=True)
    tiles = -(-n // 128)
    assert plan.route == "tile128" and plan.runs == 1
    assert plan.kernel == fused_gram.kernel_name(precision)
    assert plan.fold_floats == (tiles * (tiles + 1) // 2 * TILE
                                if plan.folds > 1 else 0)


@pytest.mark.parametrize("n", [1, 64, 128, 1920, 1921])
def test_split_follows_the_sm_count(n):
    """The split applies while the upper tiles are fewer than the SMs: at
    1920 wide (120 tiles) on 132 SMs, not on 120; never more runs than
    folds, and about two waves of blocks."""
    tiles = -(-n // 128)
    upper = tiles * (tiles + 1) // 2
    for sms in (8, 120, 132, 1024):
        plan = gram_plan(262_144, n, "bfloat16_3x", sms)
        if upper >= sms:
            assert plan.route == "tile128"
        else:
            assert plan.route == "split"
            assert plan.runs == min(32, -(-2 * sms // upper))
            assert 1 < plan.runs <= plan.folds == 32


def test_the_narrow_route_is_highest_only():
    for precision in ("bfloat16", "bfloat16_3x"):
        assert gram_plan(2_097_152, 28, precision, H100_SMS).route == "split"
    for precision in ("highest", "float32"):
        assert gram_plan(2_097_152, 28, precision, H100_SMS).route == "narrow"


def test_plain_version_counts_no_launch_on_the_cpu(rng):
    fused_gram.reset_launches()
    x = torch.from_numpy(rng.normal(size=(FOLD_ROWS + 9, 8)).astype(
        np.float32))
    fused_gram.fused_centered_gram(x, x.mean(0), torch.ones(x.shape[0]),
                                   "highest")
    assert sum(fused_gram.launches.values()) == 0
    assert NARROW_KERNEL in fused_gram.launches


# -- the workspace layouts of csrc/fused_gram.cu, element for element --------

def _ffma_element(t, e):
    tx, ty, u, v = t % 16, t // 16, e // 8, e % 8
    return (u // 4) * 64 + ty * 4 + u % 4, (v // 4) * 64 + tx * 4 + v % 4


def _tc_element(t, e):
    wg, tt = t // 128, t % 128
    return (wg * 64 + 16 * (tt // 32) + (tt % 32) // 4 + 8 * ((e // 2) % 2),
            8 * (e // 4) + 2 * (tt % 4) + e % 2)


def _narrow_blocks(n, tr=4, tc=2):
    """The narrow kernel's compute threads: thread p owns the tr × tc block
    (bi, bj), row blocks in order, column blocks bj ≥ ⌊tr·bi / tc⌋."""
    blocks = []
    for bi in range(-(-n // tr)):
        blocks += [(bi, bj) for bj in range(tr * bi // tc, -(-n // tc))]
    return blocks


def _tile_layout(layout):
    """{(t, e): (r, c)} of a 128 × 128 tile's 256 threads × 64 slots."""
    element = _ffma_element if layout == "ffma" else _tc_element
    return {(t, e): element(t, e) for t in range(256) for e in range(64)}


@pytest.mark.parametrize("layout", ["ffma", "tc"])
def test_tile_slots_hold_each_element_once(layout):
    seen = sorted(_tile_layout(layout).values())
    assert seen == [(r, c) for r in range(128) for c in range(128)]


@pytest.mark.parametrize("n", list(range(1, 65)))
def test_narrow_blocks_cover_the_upper_triangle_once(n):
    blocks = _narrow_blocks(n)
    assert len(blocks) <= 288  # the kernel's threads
    owner = {}
    for p, (bi, bj) in enumerate(blocks):
        for u in range(4):
            for v in range(2):
                r, c = 4 * bi + u, 2 * bj + v
                if r <= c < n:
                    assert (r, c) not in owner
                    owner[(r, c)] = p
    assert sorted(owner) == [(r, c) for r in range(n) for c in range(r, n)]
    assert len(_narrow_blocks(64)) == 272


def _fold_partials(x, mean, rowmul):
    """Each fold's partial sums, as the plain version forms them."""
    return [fused_centered_gram_reference(x[s:s + FOLD_ROWS], mean,
                                          rowmul[s:s + FOLD_ROWS],
                                          "highest").numpy()
            for s in range(0, x.shape[0], FOLD_ROWS)]


def _split_then_reduce(partials, n, runs, layout):
    """The split launch's arithmetic in float32 numpy: ``runs`` runs of
    whole folds store each fold's partial sums in its own slots of the
    workspace (in ``layout``), then the reduce launch sums every slot over
    the folds left to right and writes the element and its mirror."""
    folds = len(partials)
    if layout == "narrow":
        blocks = _narrow_blocks(n)
        slots = {(p, 2 * u + v): (4 * bi + u, 2 * bj + v)
                 for p, (bi, bj) in enumerate(blocks)
                 for u in range(4) for v in range(2)}
        tiles = [(0, 0)]
    else:
        slots = _tile_layout(layout)
        t = -(-n // 128)
        tiles = [(i, j) for i in range(t) for j in range(i, t)]
    work = np.full((folds, len(tiles), len(slots)), np.nan, np.float32)
    keys = list(slots)
    for run in range(runs):
        for f in range(run * folds // runs, (run + 1) * folds // runs):
            for u, (ti, tj) in enumerate(tiles):
                for s, (t, e) in enumerate(keys):
                    r, c = slots[(t, e)]
                    gi, gj = 128 * ti + r, 128 * tj + c
                    if gi < n and gj < n:
                        work[f, u, s] = partials[f][gi, gj]
    g = np.full((n, n), np.nan, np.float32)
    for u, (ti, tj) in enumerate(tiles):
        for s, (t, e) in enumerate(keys):
            r, c = slots[(t, e)]
            gi, gj = 128 * ti + r, 128 * tj + c
            if (ti == tj and r > c) or gi >= n or gj >= n:
                continue
            total = work[0, u, s]
            for f in range(1, folds):
                total = np.float32(total + work[f, u, s])
            g[gi, gj] = g[gj, gi] = total
    return g


# (rows, n, layout, runs): ragged last folds, a ragged tile column, one run
# per fold and fewer runs than folds
SPLITS = [
    (2 * FOLD_ROWS + 300, 28, "narrow", 3),
    (3 * FOLD_ROWS + 1, 5, "narrow", 2),
    (FOLD_ROWS + 64, 64, "narrow", 2),
    (2 * FOLD_ROWS + 4000, 130, "ffma", 3),
    (2 * FOLD_ROWS + 4000, 130, "tc", 2),
]


@pytest.mark.parametrize("rows,n,layout,runs", SPLITS)
def test_split_partials_reduce_to_the_plain_bits(rng, rows, n, layout, runs):
    """Whatever block computes a fold, its partial sums are the fold's; the
    reduce launch's left-to-right sum is the plain version's bit for bit
    (and the whole-depth kernel's, which sums its folds in place in the
    same order)."""
    x = torch.from_numpy((rng.normal(size=(rows, n)) + 0.5).astype(
        np.float32))
    mean = x.mean(0)
    mask = torch.ones(rows)
    mask[-100:] = 0.0
    rowmul = (mask / (rows - 101) ** 0.5).float()
    want = fused_centered_gram_reference(x, mean, rowmul, "highest").numpy()
    got = _split_then_reduce(_fold_partials(x, mean, rowmul), n, runs,
                             layout)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("rows,n", [(2 * FOLD_ROWS + 300, 28),
                                    (FOLD_ROWS + 700, 130)])
def test_split_result_matches_pallas_interpret(rng, rows, n):
    """The folded sums against the JAX package's Pallas kernel (one chain
    over every row) in interpret mode, padded to its blocks with rows whose
    multiplier is 0, within tests/test_torch_fused_gram.py's bar."""
    x = rng.normal(size=(rows, n)).astype(np.float32)
    mean = rng.normal(scale=0.3, size=n).astype(np.float32)
    rowmul = np.full(rows, 1.0 / np.sqrt(rows - 1), dtype=np.float32)
    got = _split_then_reduce(
        _fold_partials(*(torch.from_numpy(a) for a in (x, mean, rowmul))),
        n, 2, "narrow" if n <= 64 else "ffma")
    pr, pn = -(-rows // 512) * 512, -(-n // 128) * 128
    xp = np.zeros((pr, pn), np.float32)
    xp[:rows, :n] = x
    mp = np.zeros(pn, np.float32)
    mp[:n] = mean
    rp = np.zeros(pr, np.float32)
    rp[:rows] = rowmul
    want = np.asarray(jax_fused_centered_gram(
        jnp.asarray(xp), jnp.asarray(mp), jnp.asarray(rp), interpret=True,
        precision="highest", block_n=128, block_r=512))[:n, :n]
    np.testing.assert_allclose(got, want, atol=1e-4)
