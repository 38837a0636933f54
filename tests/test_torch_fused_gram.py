"""The port's fused Gram (ops/fused_gram.py) against the JAX package's
Pallas kernel, run as tests/test_pallas_gram.py runs it on the CPU
(``interpret=True``), and against numpy emulations of the bf16 rounding.

On the CPU the port's wrapper takes its plain version; the CUDA kernel is
held against that plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_gram import (
    covariance_fused as jax_covariance_fused,
    fused_centered_gram as jax_fused_centered_gram,
)
from spark_rapids_ml_tpu_torch.ops import fused_gram
from spark_rapids_ml_tpu_torch.ops.fused_gram import (
    covariance_fused,
    fused_centered_gram,
    fused_centered_gram_reference,
    gram_prep,
    gram_prep_reference,
    padded_depth,
    scratch_shape,
)


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _inputs(rng, rows, n):
    x = rng.normal(size=(rows, n)).astype(np.float32)
    mean = rng.normal(scale=0.3, size=n).astype(np.float32)
    rowmul = np.full(rows, 1.0 / np.sqrt(rows - 1), dtype=np.float32)
    return x, mean, rowmul


def _bf16_round(a):
    """Round float32 to bfloat16 (nearest, ties to even), back in float32."""
    u = np.asarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _emulated_gram(x, mean, rowmul, split):
    """The kernel's operands, built in numpy f32, multiplied in float64."""
    xc = (x - mean[None, :]) * rowmul[:, None]
    hi = _bf16_round(xc)
    h = hi.astype(np.float64)
    if not split:
        return h.T @ h
    lo = _bf16_round(xc - hi).astype(np.float64)
    return h.T @ h + h.T @ lo + lo.T @ h


def _port(x, mean, rowmul, precision):
    return fused_centered_gram(torch.from_numpy(x), torch.from_numpy(mean),
                               torch.from_numpy(rowmul), precision).numpy()


# (rows, n, block_n, block_r): one tile, an even tile count (the TPU's
# folded grid) and an odd one (the TPU falls back to the full grid).
TILINGS = [(256, 128, 128, 256), (512, 256, 128, 256), (512, 384, 128, 256)]


@pytest.mark.parametrize("precision", ["highest", "bfloat16_3x"])
@pytest.mark.parametrize("rows,n,block_n,block_r", TILINGS)
def test_matches_pallas_interpret(rng, precision, rows, n, block_n, block_r):
    x, mean, rowmul = _inputs(rng, rows, n)
    want = jax_fused_centered_gram(
        jnp.asarray(x), jnp.asarray(mean), jnp.asarray(rowmul),
        interpret=True, precision=precision, block_n=block_n,
        block_r=block_r)
    got = _port(x, mean, rowmul, precision)
    # the bar test_pallas_gram.py uses on exact tiles: f32 sums in another
    # order, over O(1) entries
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def _ragged(rng):
    # 700×37: both axes ragged for any tiling; the TPU padded both
    return rng.normal(loc=2.0, size=(700, 37)).astype(np.float32), None, True


def _garbage_masked(rng):
    x = rng.normal(size=(520, 30)).astype(np.float32)
    mask = np.ones(520, dtype=np.float32)
    mask[500:] = 0.0  # rows beyond 500 are garbage
    x[500:] = 1e6
    return x, mask, True


def _uncentered(rng):
    return rng.normal(size=(600, 40)).astype(np.float32), None, False


@pytest.mark.parametrize("case", [_ragged, _garbage_masked, _uncentered])
def test_covariance_fused_matches_pallas_and_numpy(rng, case):
    x, mask, centering = case(rng)
    cov, mean = covariance_fused(x, mask=mask, mean_centering=centering,
                                 device="cpu")
    jcov, jmean = jax_covariance_fused(x, mask=mask,
                                       mean_centering=centering,
                                       interpret=True)
    valid = x if mask is None else x[mask > 0]
    x64 = valid.astype(np.float64)
    mu = x64.mean(axis=0) if centering else np.zeros(x.shape[1])
    want = (x64 - mu).T @ (x64 - mu) / (x64.shape[0] - 1)
    assert cov.shape == (x.shape[1], x.shape[1])
    # the bars test_pallas_gram.py uses with padding/masking
    np.testing.assert_allclose(cov.numpy(), want, atol=5e-3)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), atol=5e-3)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), mu, atol=1e-5)


@pytest.mark.parametrize("rows,n", [(512, 64), (333, 129)])
def test_single_pass_bf16_matches_numpy_emulation(rng, rows, n):
    x, mean, rowmul = _inputs(rng, rows, n)
    want = _emulated_gram(x, mean, rowmul, split=False)
    got = _port(x, mean, rowmul, "bfloat16")
    # same bf16 products, exact in f32; only the f32 sums differ
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rows,n", [(512, 64), (333, 129)])
def test_split_bf16x3_matches_numpy_emulation(rng, rows, n):
    x, mean, rowmul = _inputs(rng, rows, n)
    want = _emulated_gram(x, mean, rowmul, split=True)
    got = _port(x, mean, rowmul, "bfloat16_3x")
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_single_pass_bf16_rounds_where_pallas_interpret_does_not(rng):
    """Pallas interpret on the CPU computes 'bfloat16' in f32, so against
    JAX the single pass holds only to the documented ~1e-2 relative
    contract (models/pca.py gramPrecision) — and it does round."""
    x, mean, rowmul = _inputs(rng, 512, 128)
    jax_g = np.asarray(jax_fused_centered_gram(
        jnp.asarray(x), jnp.asarray(mean), jnp.asarray(rowmul),
        interpret=True, precision="bfloat16", block_n=128, block_r=256))
    got = _port(x, mean, rowmul, "bfloat16")
    rel = np.abs(got - jax_g).max() / np.abs(jax_g).max()
    assert 1e-5 < rel < 1e-2


def test_output_exactly_symmetric(rng):
    x, mean, rowmul = _inputs(rng, 300, 70)
    for precision in ("highest", "bfloat16", "bfloat16_3x"):
        g = _port(x, mean, rowmul, precision)
        np.testing.assert_array_equal(g, g.T)


@pytest.mark.parametrize("alias,name", [("float32", "highest"),
                                        ("default", "bfloat16")])
def test_precision_aliases(rng, alias, name):
    x, mean, rowmul = _inputs(rng, 200, 33)
    np.testing.assert_array_equal(_port(x, mean, rowmul, alias),
                                  _port(x, mean, rowmul, name))
    assert fused_gram.kernel_name(alias) == fused_gram.kernel_name(name)


def test_env_default_precision(rng, monkeypatch):
    x, mean, rowmul = _inputs(rng, 200, 33)
    monkeypatch.setenv("TPUML_GRAM_PRECISION", "highest")
    np.testing.assert_array_equal(_port(x, mean, rowmul, None),
                                  _port(x, mean, rowmul, "highest"))
    monkeypatch.setenv("TPUML_GRAM_PRECISION", "int8")
    with pytest.raises(ValueError, match="TPUML_GRAM_PRECISION"):
        _port(x, mean, rowmul, None)


def _bad_dtype(x, m, r):
    return x.double(), m, r


def _bad_rank(x, m, r):
    return x[0], m, r


def _bad_mean(x, m, r):
    return x, m[:-1], r


def _bad_rowmul(x, m, r):
    return x, m, r[:-1]


def _bad_stride(x, m, r):
    return x.T.contiguous().T, m, r


def _bad_mean_dtype(x, m, r):
    return x, m.double(), r


@pytest.mark.parametrize("corrupt", [_bad_dtype, _bad_rank, _bad_mean,
                                     _bad_rowmul, _bad_stride,
                                     _bad_mean_dtype])
def test_rejects_what_the_kernel_does_not_take(rng, corrupt):
    x, mean, rowmul = (torch.from_numpy(a) for a in _inputs(rng, 20, 8))
    with pytest.raises(ValueError):
        fused_centered_gram(*corrupt(x, mean, rowmul))


def test_cpu_calls_take_plain_version_and_count_no_launch(rng):
    fused_gram.reset_launches()
    x, mean, rowmul = (torch.from_numpy(a) for a in _inputs(rng, 64, 16))
    np.testing.assert_array_equal(
        fused_centered_gram(x, mean, rowmul).numpy(),
        fused_centered_gram_reference(x, mean, rowmul).numpy())
    assert sum(fused_gram.launches.values()) == 0


def test_covariance_fused_defaults_to_the_card(rng, monkeypatch):
    """Without a device argument it takes the entry points' device: with no
    CUDA device and no CPU request it raises instead of running on the CPU."""
    x, _, _ = _inputs(rng, 40, 6)
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        covariance_fused(x)
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    cov, mean = covariance_fused(x)
    assert cov.device.type == "cpu" and mean.device.type == "cpu"


def _emulated_prep(x, mean, rowmul, split):
    """The prep pass's planes in numpy: hi (and lo) of the centred operand,
    transposed and zero-padded to whole 64-deep k-blocks, as float32."""
    rows, n = x.shape
    xc = (x - mean[None, :]) * rowmul[:, None]
    hi = _bf16_round(xc)
    planes = [hi] + ([_bf16_round(xc - hi)] if split else [])
    out = np.zeros((len(planes), n, max(1, -(-rows // 64)) * 64), np.float32)
    for p, plane in enumerate(planes):
        out[p, :, :rows] = plane.T
    return out


@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_3x"])
@pytest.mark.parametrize("rows,n", [(333, 129), (64, 8), (2, 5), (130, 64)])
def test_prep_reference_matches_numpy_emulation(rng, precision, rows, n):
    x, mean, rowmul = _inputs(rng, rows, n)
    rowmul[rows // 2:] = 0.0  # masked rows must come out as exact zeros
    got = gram_prep_reference(torch.from_numpy(x), torch.from_numpy(mean),
                              torch.from_numpy(rowmul), precision)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == scratch_shape(rows, n, precision)
    want = _emulated_prep(x, mean, rowmul, precision == "bfloat16_3x")
    # bf16 → f32 is exact, so equal floats are equal bits
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_3x"])
def test_gram_of_prep_planes_is_the_plain_gram(rng, precision):
    """The planes hold exactly the operands the plain Gram multiplies:
    x̃ᵀ in hi (and lo), the padding adding nothing."""
    x, mean, rowmul = (torch.from_numpy(a) for a in _inputs(rng, 300, 70))
    planes = gram_prep_reference(x, mean, rowmul, precision).double()
    g = planes[0] @ planes[0].T
    if precision == "bfloat16_3x":
        g = g + planes[0] @ planes[1].T + planes[1] @ planes[0].T
    want = fused_centered_gram_reference(x, mean, rowmul, precision).double()
    # the same bf16 products, summed in float64 here and in f32 there
    np.testing.assert_allclose(g.numpy(), want.numpy(),
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("rows,n,block_n,block_r", TILINGS)
def test_gram_of_prep_planes_matches_pallas_interpret(rng, rows, n, block_n,
                                                      block_r):
    x, mean, rowmul = _inputs(rng, rows, n)
    hi, lo = gram_prep_reference(torch.from_numpy(x), torch.from_numpy(mean),
                                 torch.from_numpy(rowmul),
                                 "bfloat16_3x").double()
    got = (hi @ hi.T + hi @ lo.T + lo @ hi.T).numpy()
    want = jax_fused_centered_gram(
        jnp.asarray(x), jnp.asarray(mean), jnp.asarray(rowmul),
        interpret=True, precision="bfloat16_3x", block_n=block_n,
        block_r=block_r)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def _emulated_f32_prep(x, mean, rowmul):
    """The highest prep pass's scratch in numpy: x̃ in f32, row-major, rows
    zero-padded to whole 64-deep k-blocks and columns to a multiple of 4."""
    rows, n = x.shape
    out = np.zeros((max(1, -(-rows // 64)) * 64, -(-n // 4) * 4), np.float32)
    out[:rows, :n] = (x - mean[None, :]) * rowmul[:, None]
    return out


@pytest.mark.parametrize("rows,n", [(333, 129), (64, 8), (2, 5), (130, 64)])
def test_highest_prep_reference_matches_numpy_emulation(rng, rows, n):
    x, mean, rowmul = _inputs(rng, rows, n)
    rowmul[rows // 2:] = 0.0  # masked rows must come out as exact zeros
    got = gram_prep_reference(torch.from_numpy(x), torch.from_numpy(mean),
                              torch.from_numpy(rowmul), "highest")
    assert got.dtype == torch.float32
    assert tuple(got.shape) == scratch_shape(rows, n, "highest")
    want = _emulated_f32_prep(x, mean, rowmul)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert not np.any(got.numpy()[rows // 2:])  # ±0: (x − mean)·0


def _gram_of_f32_plane(plane, n):
    """The f32 scratch's Gram in float64, cut to n × n: the products the
    FFMA pipeline sums, each exact in float64."""
    return (plane.double().T @ plane.double())[:n, :n].numpy()


def test_gram_of_highest_prep_plane_is_the_plain_gram(rng):
    """The plane holds exactly the operand the plain Gram multiplies, the
    padding adding nothing."""
    x, mean, rowmul = (torch.from_numpy(a) for a in _inputs(rng, 300, 70))
    plane = gram_prep_reference(x, mean, rowmul, "highest")
    full = plane.double().T @ plane.double()
    assert not torch.any(full[70:]) and not torch.any(full[:, 70:])
    want = fused_centered_gram_reference(x, mean, rowmul, "highest").double()
    # the same f32 products, summed in float64 here and in f32 there
    np.testing.assert_allclose(_gram_of_f32_plane(plane, 70), want.numpy(),
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("rows,n,block_n,block_r", TILINGS)
def test_gram_of_highest_prep_plane_matches_pallas_interpret(rng, rows, n,
                                                             block_n, block_r):
    x, mean, rowmul = _inputs(rng, rows, n)
    plane = gram_prep_reference(torch.from_numpy(x), torch.from_numpy(mean),
                                torch.from_numpy(rowmul), "highest")
    want = jax_fused_centered_gram(
        jnp.asarray(x), jnp.asarray(mean), jnp.asarray(rowmul),
        interpret=True, precision="highest", block_n=block_n,
        block_r=block_r)
    # the bar test_matches_pallas_interpret uses
    np.testing.assert_allclose(_gram_of_f32_plane(plane, n), np.asarray(want),
                               atol=1e-4)


@pytest.mark.parametrize("rows,depth", [(0, 64), (1, 64), (63, 64), (64, 64),
                                        (65, 128), (8192, 8192),
                                        (8193, 8256)])
def test_padded_depth(rows, depth):
    assert padded_depth(rows) == depth


@pytest.mark.parametrize("precision,shape", [
    ("bfloat16", (1, 129, 1024)), ("default", (1, 129, 1024)),
    ("bfloat16_3x", (2, 129, 1024)), ("highest", (1024, 132)),
    ("float32", (1024, 132))])
def test_scratch_shape(precision, shape):
    assert scratch_shape(1000, 129, precision) == shape


@pytest.mark.parametrize("rows,n,shape", [(1, 4, (64, 4)), (8192, 4096,
                                                             (8192, 4096)),
                                          (65, 131, (128, 132))])
def test_highest_scratch_rows_are_whole_16_byte_strides(rows, n, shape):
    """TMA needs a row stride of whole 16 bytes: 4 floats."""
    assert scratch_shape(rows, n, "highest") == shape
    assert shape[1] * 4 % 16 == 0


def test_cpu_highest_prep_takes_plain_version_and_counts_no_launch(rng):
    fused_gram.reset_launches()
    x, mean, rowmul = (torch.from_numpy(a) for a in _inputs(rng, 50, 13))
    for precision in ("highest", "float32"):
        got = gram_prep(x, mean, rowmul, precision)
        assert got.dtype == torch.float32
        assert torch.equal(got, gram_prep_reference(x, mean, rowmul,
                                                    "highest"))
    assert sum(fused_gram.launches.values()) == 0


def test_cpu_prep_takes_plain_version_and_counts_no_launch(rng):
    fused_gram.reset_launches()
    x, mean, rowmul = (torch.from_numpy(a) for a in _inputs(rng, 50, 12))
    for precision in ("bfloat16", "bfloat16_3x"):
        assert torch.equal(gram_prep(x, mean, rowmul, precision),
                           gram_prep_reference(x, mean, rowmul, precision))
    assert sum(fused_gram.launches.values()) == 0


@pytest.mark.parametrize("corrupt", [_bad_dtype, _bad_rank, _bad_mean,
                                     _bad_rowmul, _bad_stride,
                                     _bad_mean_dtype])
def test_prep_rejects_what_the_kernel_does_not_take(rng, corrupt):
    x, mean, rowmul = (torch.from_numpy(a) for a in _inputs(rng, 20, 8))
    with pytest.raises(ValueError):
        gram_prep(*corrupt(x, mean, rowmul), "bfloat16_3x")


@pytest.mark.parametrize("corrupt", [_bad_dtype, _bad_rank, _bad_mean,
                                     _bad_rowmul, _bad_stride,
                                     _bad_mean_dtype])
def test_highest_prep_rejects_what_the_kernel_does_not_take(rng, corrupt):
    x, mean, rowmul = (torch.from_numpy(a) for a in _inputs(rng, 20, 8))
    with pytest.raises(ValueError):
        gram_prep(*corrupt(x, mean, rowmul), "highest")


@pytest.mark.parametrize("precision", ["highest", "bfloat16", "bfloat16_3x"])
def test_plain_version_sums_fold_row_chunks_in_row_order(rng, precision):
    """Past FOLD_ROWS rows the plain version, like the kernel, sums the
    Grams of FOLD_ROWS-row chunks in row order: exactly the sum of its
    results on the chunks (a partial last chunk included)."""
    rows = 2 * fused_gram.FOLD_ROWS + 100
    x, mean, rowmul = (torch.from_numpy(a) for a in _inputs(rng, rows, 24))
    chunks = [slice(s, s + fused_gram.FOLD_ROWS)
              for s in range(0, rows, fused_gram.FOLD_ROWS)]
    assert len(chunks) == 3
    want = None
    for c in chunks:
        part = fused_centered_gram_reference(x[c], mean, rowmul[c], precision)
        want = part if want is None else want + part
    got = fused_centered_gram_reference(x, mean, rowmul, precision)
    assert torch.equal(got, want)
    assert torch.equal(got, got.T)
