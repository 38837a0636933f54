"""Symmetric int8 quantization for the reduced-precision serving products.

Counterpart of the JAX package's ``ops/quantize.py``, with the same scheme:

* **per-tensor symmetric** scales (``scale = max|a| / 127``), zero-point
  free, so the dequantized product is one f32 rescale of the int32
  accumulator;
* accumulation in **int32** (``torch._int_mm``): products of two int8
  operands cannot overflow int32 until the contraction exceeds ~2^17
  terms, far past any serving feature width here;
* the batch is quantized on the device from the staged f32/f64 input, per
  call; the constant model weights once, on the host, at program build.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the port's
quantized values equal the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_symmetric(a: torch.Tensor):
    """``(q, scale)`` with ``q = clip(round(a / scale)) ∈ int8`` and
    ``a ≈ q * scale``, on ``a``'s device, for the batch operand. The scale
    is computed in ``a``'s dtype and returned as a 0-d float32 tensor; its
    floor keeps an all-zero (padding-only) tensor from dividing by zero."""
    peak = torch.clamp_min(a.abs().max(), 1e-12)
    # a divisor on the device: CUDA divides by a host scalar as a multiply
    # by its reciprocal, which can differ in the last bit
    scale = peak / torch.full((), 127.0, dtype=peak.dtype, device=peak.device)
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantize_symmetric_host(a):
    """NumPy mirror of ``quantize_symmetric`` for the constant model
    weights: quantized once at ``ServingProgram`` build and staged to the
    device as int8 + scale."""
    a = np.asarray(a, dtype=np.float64)
    scale = max(float(np.max(np.abs(a))), 1e-12) / 127.0
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale)
