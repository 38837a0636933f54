"""The end-to-end single-device PCA functions.

Counterpart of the JAX package's ``ops/pca_kernel.py``: ``pca_fit_kernel``
runs mean pass (``RapidsRowMatrix.scala:152-162``) → centered Gram
(``:168-202``) → eigendecomposition + postprocess (``rapidsml_jni.cu:338-392``)
on one device; ``pca_transform_kernel`` is the batched transform the
reference left disabled (``RapidsPCA.scala:172-190``), one product over the
whole batch. The bf16/int8 serving variants come with the serving slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spark_rapids_ml_tpu_torch.ops.covariance import column_means, covariance
from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance


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
    transform time (``RapidsPCA.scala:187-189``). Full f32 on the card while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (the default)."""
    return x @ components.to(x.dtype)


def pca_transform_kernel(x: torch.Tensor,
                         components: torch.Tensor) -> torch.Tensor:
    """Project a whole batch: X @ PC (see ``_project``)."""
    return _project(x, components)
