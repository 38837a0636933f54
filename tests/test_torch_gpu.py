"""Tests of the port that need the card (marker ``gpu``).

They skip, with a reason, where there is no CUDA device: whether there is
one is decided inside the ``cuda_device`` fixture, never at import. This
file imports neither jax nor the JAX package, so it runs on a machine
without them; tests/conftest.py does import jax, so run it there with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import PCA
from spark_rapids_ml_tpu_torch.ops import fused_gram
from spark_rapids_ml_tpu_torch.ops.fused_gram import (
    fused_centered_gram,
    fused_centered_gram_reference,
)
from spark_rapids_ml_tpu_torch.utils import cuda_build

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device(monkeypatch):
    """The card, with entry points resolving to it; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda", 0)


def _decaying(rows, d, seed=0, loc=3.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return rng.normal(size=(rows, d)) @ (q * 2.0 ** (-np.arange(d) / 4)) + loc


def test_kernel_builds_with_nvcc(cuda_device):
    result = cuda_build.build("fused_gram")
    assert os.path.isfile(result.path)


@pytest.mark.parametrize("precision", ["highest", "bfloat16", "bfloat16_3x"])
@pytest.mark.parametrize("rows,n", [(1000, 1100), (256, 128), (5, 129)])
def test_kernel_matches_plain_version_on_card(cuda_device, precision, rows, n):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(rows, n, generator=g, device=cuda_device)
    mean = 0.3 * torch.randn(n, generator=g, device=cuda_device)
    rowmul = torch.full((rows,), (rows - 1) ** -0.5, device=cuda_device)
    rowmul[rows - rows // 5:] = 0.0  # a masked tail
    name = fused_gram.kernel_name(precision)
    before = fused_gram.launches[name]
    got = fused_centered_gram(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    assert fused_gram.launches[name] == before + 1
    want = fused_centered_gram_reference(x, mean, rowmul, precision)
    # f32 sums in another order (tensor-core accumulation in bf16 modes)
    err = (got - want).abs().max().item()
    assert err <= fused_gram.PLAIN_RTOL[name] * want.abs().max().item()
    assert torch.equal(got, got.T)


# The tensor-core pipeline's edges, as (rows, n, masked tail rows, extra
# columns of the parent whose row view x is, from column 1).
EDGES = {
    "one row": (1, 64, 0, 0),
    "rows below one k-block": (40, 130, 0, 0),
    "rows not a multiple of 64": (200, 136, 0, 0),
    "n not a multiple of 8": (300, 131, 0, 0),
    "n 4096, diagonal tiles": (256, 4096, 0, 0),
    "strided row view": (500, 300, 0, 7),
    "masked tail of garbage": (700, 260, 200, 0),
}


def _edge_inputs(device, edge):
    rows, n, masked, extra = EDGES[edge]
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(rows, n + extra, generator=g, device=device) + 0.5
    if extra:
        x = x[:, 1:n + 1]
    mask = torch.ones(rows, device=device)
    if masked:
        mask[rows - masked:] = 0.0
        x[rows - masked:] = 1e6  # padding garbage the mask must hide
    valid = int(mask.sum())
    mean = (x * mask[:, None]).sum(0) / valid
    rowmul = mask / max(valid - 1, 1) ** 0.5
    return x, mean.contiguous(), rowmul.contiguous()


@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_3x"])
@pytest.mark.parametrize("edge", list(EDGES))
def test_pipeline_edges_match_plain_version(cuda_device, precision, edge):
    x, mean, rowmul = _edge_inputs(cuda_device, edge)
    name = fused_gram.kernel_name(precision)
    before = fused_gram.launches[name]
    got = fused_centered_gram(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    assert fused_gram.launches[name] == before + 1
    want = fused_centered_gram_reference(x, mean, rowmul, precision)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= fused_gram.PLAIN_RTOL[name] * want.abs().max().item()
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_3x"])
@pytest.mark.parametrize("edge", list(EDGES))
def test_prep_pass_is_bit_equal_to_its_plain_version(cuda_device, precision,
                                                     edge):
    x, mean, rowmul = _edge_inputs(cuda_device, edge)
    before = fused_gram.launches[fused_gram.PREP_KERNEL]
    got = fused_gram.gram_prep(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    assert fused_gram.launches[fused_gram.PREP_KERNEL] == before + 1
    want = fused_gram.gram_prep_reference(x, mean, rowmul, precision)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_highest_bar_rejects_tf32_and_the_bf16_split(cuda_device):
    """At the main-path bucket the full-f32 kernel is within its bar, and a
    TF32 product or the bf16 hi/lo split of the same inputs is not."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(8192, 4096, generator=g, device=cuda_device) + 0.5
    mean = x.mean(0)
    rowmul = torch.full((8192,), 8191 ** -0.5, device=cuda_device)
    want = fused_centered_gram_reference(x, mean, rowmul, "highest")
    scale = want.abs().max().item()
    bar = fused_gram.PLAIN_RTOL[fused_gram.kernel_name("highest")]

    def rel(got):
        return (got - want).abs().max().item() / scale

    assert rel(fused_centered_gram(x, mean, rowmul, "highest")) < bar
    assert rel(fused_centered_gram(x, mean, rowmul, "bfloat16_3x")) > bar
    xc = (x - mean) * rowmul[:, None]
    torch.backends.cuda.matmul.allow_tf32 = True  # restored by the fixture
    tf32 = xc.T @ xc
    assert rel(torch.triu(tf32) + torch.triu(tf32, 1).T) > bar


def test_kernel_takes_a_strided_row_view(cuda_device):
    """Any row stride, no copy: a column slice of a wider matrix."""
    wide = torch.randn(300, 200, device=cuda_device)
    x = wide[:, 10:150]
    mean = torch.zeros(140, device=cuda_device)
    rowmul = torch.ones(300, device=cuda_device)
    got = fused_centered_gram(x, mean, rowmul, "highest")
    want = fused_centered_gram_reference(x.contiguous(), mean, rowmul,
                                         "highest")
    bar = fused_gram.PLAIN_RTOL[fused_gram.kernel_name("highest")]
    assert (got - want).abs().max().item() <= bar * want.abs().max().item()


def test_kernel_wrapper_raises_on_card_input_it_does_not_take(cuda_device):
    before = sum(fused_gram.launches.values())
    x = torch.randn(16, 8, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError):
        fused_centered_gram(x, torch.zeros(8, device=cuda_device),
                            torch.ones(16, device=cuda_device))
    with pytest.raises(ValueError):
        fused_centered_gram(x.float(), torch.zeros(8), torch.ones(16))
    assert sum(fused_gram.launches.values()) == before


@pytest.mark.parametrize("streamed", [False, True])
def test_float32_fit_on_card_goes_through_the_kernel(cuda_device, streamed):
    x = _decaying(3000, 40)
    fused_gram.reset_launches()
    est = PCA().setK(4).setDtype("float32").setBatchRows(1024)
    model = est.fit((lambda: iter([x])) if streamed else x)
    assert sum(fused_gram.launches.values()) == (3 if streamed else 1)
    ref = (PCA().setK(4).setUseXlaDot(False).setUseXlaSvd(False).fit(x))
    cos = np.abs(np.sum(model.pc * ref.pc, axis=0))
    assert cos.min() > 0.9999
    np.testing.assert_allclose(model.explained_variance,
                               ref.explained_variance, atol=1e-5)


def test_float64_fit_on_card_matches_host_fit(cuda_device):
    """float64 takes the plain path on the card: no kernel, oracle bar."""
    x = _decaying(500, 12)
    fused_gram.reset_launches()
    model = PCA().setK(5).setDtype("float64").fit(x)
    assert sum(fused_gram.launches.values()) == 0
    ref = PCA().setK(5).setUseXlaDot(False).setUseXlaSvd(False).fit(x)
    np.testing.assert_allclose(model.pc, ref.pc, atol=1e-5)
    np.testing.assert_allclose(model.explained_variance,
                               ref.explained_variance, atol=1e-5)
    out = np.asarray(model.transform(x).column("pca_features"))
    np.testing.assert_allclose(out, x @ model.pc, atol=1e-8)
