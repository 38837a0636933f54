"""The end-to-end single-device PCA functions.

Counterpart of the JAX package's ``ops/pca_kernel.py``: ``pca_fit_kernel``
runs mean pass (``RapidsRowMatrix.scala:152-162``) → centered Gram
(``:168-202``) → eigendecomposition + postprocess (``rapidsml_jni.cu:338-392``)
on one device; ``pca_transform_kernel`` is the batched transform the
reference left disabled (``RapidsPCA.scala:172-190``), one product over the
whole batch.

The serving variants (``pca_transform_serve``, ``pca_transform_bf16``,
``pca_transform_int8``) are what the pipelined micro-batcher runs through
``PCAModel.serving_transform_program``. The JAX package computes them as
XLA dot products, not Pallas kernels, so here they are PyTorch products
(cuBLAS on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from spark_rapids_ml_tpu_torch.ops.covariance import column_means, covariance
from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance
from spark_rapids_ml_tpu_torch.ops.quantize import quantize_symmetric


class PCAFitResult(NamedTuple):
    components: torch.Tensor          # (n_features, k), column j = j-th PC
    explained_variance: torch.Tensor  # (k,) ratios λᵢ/Σλ
    mean: torch.Tensor                # (n_features,) column means (or zeros)


def pca_fit_kernel(
    x: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    mean_centering: bool = True,
    flip_signs: bool = True,
    solver: str = "eigh",
    precision: Optional[str] = None,
) -> PCAFitResult:
    """Full PCA fit on x's device: mean → centered Gram → eigh → top-k.

    Two-pass (explicit centering before the Gram) for parity with the
    reference's semantics. ``mask`` marks valid rows of a padded batch.
    """
    if mean_centering:
        mean = column_means(x, mask)
        cov = covariance(x, mean=mean, mask=mask, precision=precision)
    else:
        mean = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        cov = covariance(x, mean=None, mask=mask, precision=precision)
    components, evr = pca_from_covariance(
        cov, k, flip_signs=flip_signs, solver=solver
    )
    return PCAFitResult(components, evr, mean)


def _project(x: torch.Tensor, components: torch.Tensor) -> torch.Tensor:
    """X @ PC in x's dtype. Spark PCA semantics: NO mean subtraction at
    transform time (``RapidsPCA.scala:187-189``).

    The JAX package multiplies at ``Precision.HIGHEST``. On the card a
    float32 product may run in TF32 (``torch.backends.cuda.matmul
    .allow_tf32``, ``torch.set_float32_matmul_precision``), a process-wide
    setting that a serving thread can neither own nor safely toggle. So a
    float32 batch is multiplied in float64, which no such setting reaches,
    and rounded back to float32: full f32 whatever the setting, at least as
    accurate as a full-f32 product. Other dtypes multiply in their own.
    """
    if x.dtype == torch.float32:
        return (x.double() @ components.double()).float()
    return x @ components.to(x.dtype)


def pca_transform_kernel(x: torch.Tensor,
                         components: torch.Tensor) -> torch.Tensor:
    """Project a whole batch: X @ PC (see ``_project``)."""
    return _project(x, components)


# -- serving variants -------------------------------------------------------

def pca_transform_serve(x: torch.Tensor,
                        components: torch.Tensor) -> torch.Tensor:
    """The serving program's native projection (``_project``). The JAX
    package's twin donates the staged input buffer to XLA; PyTorch has no
    donation, and the staged batch is an ordinary tensor that the caching
    allocator reclaims once the program drops it."""
    return _project(x, components)


def _project_bf16(x: torch.Tensor,
                  components_bf16: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 products and accumulation, an f32 result: the
    JAX package's ``preferred_element_type=float32``. The components
    arrive pre-cast (staged once at program build); only the batch casts
    here. On the card one bf16 GEMM with an f32 output
    (``torch.mm(..., out_dtype=float32)``); elsewhere the bf16-rounded
    operands upcast to f32, whose products are exact in f32, so both
    compute the same function (``torch.matmul`` on bf16 operands would
    instead round every output to bf16)."""
    xb = x.to(torch.bfloat16)
    if xb.is_cuda:
        return torch.mm(xb, components_bf16, out_dtype=torch.float32)
    return xb.float() @ components_bf16.float()


pca_transform_bf16 = _project_bf16

# torch._int_mm on the card wants more than 16 rows and inner and output
# widths that are multiples of 8: the batch is padded up to these, and the
# components are padded at program build (``pad_int8_components``).
INT8_MIN_ROWS = 32
INT8_MULTIPLE = 8


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_int8_components(q: np.ndarray) -> np.ndarray:
    """Quantized (d, k) components zero-padded to multiples of 8 in both
    widths. A zero feature row adds nothing to any product, and a zero
    column is a column the caller slices off."""
    d, k = q.shape
    return np.pad(q, ((0, _round_up(d, INT8_MULTIPLE) - d),
                      (0, _round_up(k, INT8_MULTIPLE) - k)))


def _project_int8(x: torch.Tensor, components_q: torch.Tensor,
                  components_scale: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 product with int32 accumulation and an f32
    dequantized output (``ops.quantize``). The components arrive
    pre-quantized (``quantize_symmetric_host`` at program build); only the
    batch pays the max/round/clip per call. The quantized batch is
    zero-padded to ``torch._int_mm``'s shapes (rows to ``INT8_MIN_ROWS``,
    features to the components' rows) and the rows sliced back; the
    columns are the components' own, padded ones included. The rescale
    keeps the JAX package's association, ``acc * (sx * scale)``."""
    rows = x.shape[0]
    xq, sx = quantize_symmetric(x)
    pad_rows = max(INT8_MIN_ROWS - rows, 0)
    pad_cols = components_q.shape[0] - xq.shape[1]
    if pad_rows or pad_cols:
        xq = F.pad(xq, (0, pad_cols, 0, pad_rows))
    acc = torch._int_mm(xq, components_q)[:rows]
    return acc.float() * (sx * components_scale)


pca_transform_int8 = _project_int8


# The stage bodies, keyed by precision like the JAX package's. The served
# PCA stage (``PCAModel._serving_bodies``) keeps int8's first k columns.
SERVING_STAGE_BODIES = {
    "native": _project,
    "bf16": _project_bf16,
    "int8": _project_int8,
}
