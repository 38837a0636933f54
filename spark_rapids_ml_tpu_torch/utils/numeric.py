"""Small shared numeric constants (host-side)."""

from __future__ import annotations

# The Gram precision vocabulary, shared by the ``gramPrecision`` Param
# validator and ops/covariance.py. Same names as the JAX package so saved
# metadata stays compatible. On the card: 'highest'/'float32' are full f32
# (TF32 is not), 'bfloat16'/'default' one bf16 pass, 'bfloat16_3x' the hi/lo
# bf16 split with three passes (see ops/fused_gram.py).
GRAM_PRECISIONS = ("default", "bfloat16", "bfloat16_3x", "float32",
                   "highest")
