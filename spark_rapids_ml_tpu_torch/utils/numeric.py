"""Small shared numeric helpers and constants (host-side)."""

from __future__ import annotations

import numpy as np

# The Gram precision vocabulary, shared by the ``gramPrecision`` Param
# validator and ops/covariance.py. Same names as the JAX package so saved
# metadata stays compatible. On the card: 'highest'/'float32' are full f32
# (TF32 is not), 'bfloat16'/'default' one bf16 pass, 'bfloat16_3x' the hi/lo
# bf16 split with three passes (see ops/fused_gram.py).
GRAM_PRECISIONS = ("default", "bfloat16", "bfloat16_3x", "float32",
                   "highest")


def sigmoid(z: np.ndarray) -> np.ndarray:
    """Numerically stable logistic function: never evaluates exp on a
    positive argument, so large |z| cannot overflow (the naive
    ``1/(1+exp(-z))`` warns and round-trips through inf for z < -745)."""
    z = np.asarray(z, dtype=np.float64)
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out
