"""Fused center + scale + mask + Gram: the hand-written CUDA kernel
(``csrc/fused_gram.cu``) and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas_gram.py``. The function is

    G = (diag(rowmul) · (X − mean))ᵀ (diag(rowmul) · (X − mean))

computed in one pass over X, with only the upper output tiles visited and
the result mirrored, so G is exactly symmetric. ``rowmul`` is the per-row
multiplier: row mask × 1/√(count − 1), 0 on padding rows.

``fused_centered_gram`` launches the kernel for a CUDA tensor and uses
``fused_centered_gram_reference`` only for a CPU tensor. There is no
fallback on the card: a CUDA input the kernel does not take raises. The
kernel needs no padding (it masks ragged rows and columns itself), so
``covariance_fused`` keeps the JAX contract without the host pad copy.

Precision (``gramPrecision``; None defers to ``TPUML_GRAM_PRECISION``):
'highest'/'float32' are full f32, 'bfloat16'/'default' one bf16 pass with
f32 accumulation, 'bfloat16_3x' splits each operand into bf16 hi + lo and
sums hi·hi + hi·lo + lo·hi in f32 (lo·lo dropped), as the TPU kernel did.
The plain version rounds to bf16 exactly as the kernel does.

Every precision runs in two launches on the current stream: a prep pass
that centres X once into scratch this wrapper allocates (``scratch_shape``),
then a Gram pipeline that reads only that scratch. For 'highest' the
scratch is x̃ in f32, row-major (``padded_depth`` × n rounded up to 4),
read by an FFMA pipeline; for the bf16 modes it is x̃ᵀ rounded and split
into bf16 planes, read by a tensor-core pipeline. The call counts as one
launch. ``gram_prep`` runs the prep pass alone, and ``gram_prep_reference``
is its plain version; both serve only the tests and ``chip_smoke.py``,
which hold the two bit for bit.

The JAX package's TPU cost rule (``symmetric_cost_wins``) and its v5e block
constants were measured on a TPU and are not carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.utils import cuda_build
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

# precision name → the kernel's mode (its template instantiation)
_MODES = {
    "highest": 0, "float32": 0,
    "bfloat16": 1, "default": 1,
    "bfloat16_3x": 2,
}
# kernel instantiation name by mode, the keys of ``launches``
KERNEL_NAMES = (
    "fused_centered_gram_f32",
    "fused_centered_gram_bf16",
    "fused_centered_gram_bf16x3",
)

# How far the kernel may be from its plain version on the same inputs,
# max |Δ| / max |G| (the two sum the same f32 products in another order;
# the bf16 modes accumulate on the tensor cores). Each bar lies between the
# largest error of the sound kernel and what a kernel computing in another
# precision gives on the same inputs (TF32 or the bf16 split in place of
# full f32, one bf16 pass or a dropped cross term in place of the split,
# full f32 in place of one bf16 pass), so a kernel that ran in the wrong
# precision fails it. chip_smoke.py measures both sides on the card.
PLAIN_RTOL = {
    "fused_centered_gram_f32": 1.5e-5,
    "fused_centered_gram_bf16": 6e-5,
    "fused_centered_gram_bf16x3": 6.5e-5,
}

# ``gram_prep``'s count: the prep pass launched alone, outside any Gram
PREP_KERNEL = "fused_centered_gram_prep"

# No f32 sum runs deeper than this many rows: every FOLD_ROWS rows the
# kernel adds its running sums into a fold workspace and restarts them
# (csrc/fused_gram.cu, FOLD_ROWS), and the plain version sums its Grams over
# FOLD_ROWS-row chunks in row order. The bars above were set at this depth
# (the 8192-row bucket); one f32 chain over 262,144 rows was 1.3e-3 of
# max |G| from float64 in the bf16 modes.
FOLD_ROWS = 8192

# The prep pass pads the scratch's depth (the rows of X) with zeros to a
# multiple of this: the tensor-core k-block (64 bf16, one 128-byte swizzle
# row) and a whole number of the FFMA pipeline's k-blocks.
K_BLOCK = 64

# Launches of each instantiation, counted where the kernel is launched and
# nowhere else (CPU calls take the plain version and do not count).
launches = {name: 0 for name in KERNEL_NAMES + (PREP_KERNEL,)}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kernel_name(precision: Optional[str] = None) -> str:
    """The kernel instantiation a precision selects."""
    return KERNEL_NAMES[_MODES[_resolve(precision)]]


def _resolve(precision: Optional[str]) -> str:
    from spark_rapids_ml_tpu_torch.ops.covariance import resolve_gram_precision

    return resolve_gram_precision(precision)


def padded_depth(rows: int) -> int:
    """Rows of X padded to whole k-blocks (at least one): the depth ``kp``
    of the prep pass's scratch."""
    return max(1, -(-rows // K_BLOCK)) * K_BLOCK


def scratch_shape(rows: int, n: int,
                  precision: Optional[str] = None) -> tuple:
    """Shape of the scratch the prep pass writes for an (rows, n) input:
    for highest (kp, n4), x̃ in f32 with n rounded up to a multiple of 4
    (TMA's 16-byte row stride); for the bf16 modes (planes, n, kp), x̃ᵀ in
    bf16, one plane (hi) for bfloat16 and two (hi, lo) for bfloat16_3x."""
    return _scratch_shape(rows, n, _MODES[_resolve(precision)])


def _scratch_shape(rows: int, n: int, mode: int) -> tuple:
    if mode == 0:
        return (padded_depth(rows), -(-n // 4) * 4)
    return (2 if mode == 2 else 1, n, padded_depth(rows))


def _scratch_dtype(mode: int) -> torch.dtype:
    return torch.float32 if mode == 0 else torch.bfloat16


def _check_inputs(x: torch.Tensor, mean: torch.Tensor,
                  rowmul: torch.Tensor) -> None:
    """The kernel's input contract, checked on every device so the plain
    version accepts exactly what the kernel does."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    rows, n = x.shape
    for name, t, size in (("mean", mean, n), ("rowmul", rowmul, rows)):
        if t.shape != (size,):
            raise ValueError(
                f"{name} must have shape ({size},), got {tuple(t.shape)}")
    for name, t in (("x", x), ("mean", mean), ("rowmul", rowmul)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(
                f"{name} is on {t.device}, x is on {x.device}")
    if n == 0:
        raise ValueError("x has no columns")
    if n > 1 and x.stride(1) != 1:
        raise ValueError("x must have unit column stride")
    if rows > 1 and x.stride(0) < n:
        raise ValueError(f"x row stride {x.stride(0)} is below its width {n}")
    for name, t in (("mean", mean), ("rowmul", rowmul)):
        if t.numel() > 1 and t.stride(0) != 1:
            raise ValueError(f"{name} must be contiguous")


def fused_centered_gram_reference(x: torch.Tensor, mean: torch.Tensor,
                                  rowmul: torch.Tensor,
                                  precision: Optional[str] = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same arithmetic: the
    same f32 centring and scaling, the same bf16 rounding (round to nearest
    even) and hi/lo split, f32 accumulation in the same ``FOLD_ROWS``-row
    folds, summed in row order, then the upper triangle mirrored. Only the
    order of the f32 sums within a fold differs from the kernel."""
    _check_inputs(x, mean, rowmul)
    mode = _MODES[_resolve(precision)]
    g = None
    for start in range(0, max(x.shape[0], 1), FOLD_ROWS):
        rows = slice(start, start + FOLD_ROWS)
        xc = (x[rows] - mean[None, :]) * rowmul[rows, None]
        if mode == 0:
            part = xc.T @ xc
        else:
            hi = xc.to(torch.bfloat16).to(torch.float32)
            part = hi.T @ hi
            if mode == 2:
                lo = (xc - hi).to(torch.bfloat16).to(torch.float32)
                part = part + hi.T @ lo + lo.T @ hi
        g = part if g is None else g + part
    return torch.triu(g) + torch.triu(g, 1).T


def gram_prep_reference(x: torch.Tensor, mean: torch.Tensor,
                        rowmul: torch.Tensor,
                        precision: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of the prep pass: x̃ = (x − mean)·rowmul in
    f32, written into a zeroed ``scratch_shape`` tensor: as it is for
    highest (f32, row-major); for the bf16 modes rounded to bf16 (nearest
    even) as hi and, for bfloat16_3x, lo = bf16(x̃ − hi), each transposed.
    The kernel must match it bit for bit."""
    _check_inputs(x, mean, rowmul)
    mode = _MODES[_resolve(precision)]
    rows, n = x.shape
    xc = (x - mean[None, :]) * rowmul[:, None]
    out = torch.zeros(_scratch_shape(rows, n, mode),
                      dtype=_scratch_dtype(mode), device=x.device)
    if mode == 0:
        out[:rows, :n] = xc
        return out
    hi = xc.to(torch.bfloat16)
    out[0, :, :rows] = hi.T
    if mode == 2:
        out[1, :, :rows] = (xc - hi.to(torch.float32)).to(torch.bfloat16).T
    return out


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The library's C entry points with their argument types, set once."""
    lib = cuda_build.load("fused_gram")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    gram = lib.tpuml_fused_centered_gram
    gram.argtypes = [ptr, i64, ptr, ptr, ptr, i32, i32, i32, ptr, i32, ptr, ptr]
    prep = lib.tpuml_gram_prep
    prep.argtypes = [ptr, i64, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    smem = lib.tpuml_gram_dynamic_smem
    smem.argtypes = [i32]
    for fn in (gram, prep, smem):
        fn.restype = ctypes.c_int
    fold_floats = lib.tpuml_gram_fold_floats
    fold_floats.argtypes = [i32]
    fold_floats.restype = i64
    return gram, prep, smem, fold_floats


def dynamic_smem_bytes(precision: Optional[str] = None) -> int:
    """Dynamic shared memory the precision's Gram launch asks for. Builds
    the library if needed."""
    return _kernel_fns()[2](_MODES[_resolve(precision)])


def _launch(fn, x: torch.Tensor, *args) -> int:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return fn(*args, stream)


def _raise_on(err: int, what: str, x: torch.Tensor, mode: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: cudaError {err} "
            f"(x {tuple(x.shape)}, precision mode {mode})")


def gram_prep(x: torch.Tensor, mean: torch.Tensor, rowmul: torch.Tensor,
              precision: Optional[str] = None) -> torch.Tensor:
    """The prep pass alone: the ``scratch_shape`` tensor that
    ``fused_centered_gram`` hands to its Gram launch. A CUDA input launches
    the prep kernel (counted under ``PREP_KERNEL``); a CPU input takes
    ``gram_prep_reference``."""
    if x.device.type == "cpu":
        return gram_prep_reference(x, mean, rowmul, precision)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_inputs(x, mean, rowmul)
    rows, n = x.shape
    mode = _MODES[_resolve(precision)]
    scratch = torch.empty(_scratch_shape(rows, n, mode),
                          dtype=_scratch_dtype(mode), device=x.device)
    err = _launch(_kernel_fns()[1], x, x.data_ptr(), max(x.stride(0), n),
                  mean.data_ptr(), rowmul.data_ptr(), scratch.data_ptr(),
                  rows, n, mode, padded_depth(rows))
    _raise_on(err, "gram_prep", x, mode)
    launches[PREP_KERNEL] += 1
    return scratch


def fused_centered_gram(x: torch.Tensor, mean: torch.Tensor,
                        rowmul: torch.Tensor,
                        precision: Optional[str] = None) -> torch.Tensor:
    """``(diag(rowmul)·(x − mean))ᵀ (diag(rowmul)·(x − mean))``, exactly
    symmetric, float32 (n, n).

    x is (rows, n) float32 with unit column stride (any row stride), mean
    (n,) and rowmul (rows,) float32 on the same device. A CUDA input
    launches the kernel on the current stream (the prep pass, then the
    Gram pipeline, counted as one launch); a CPU input takes the plain
    version. Anything else the kernel does not take raises ValueError.

    On the card the call also allocates the prep pass's scratch for its
    duration (``scratch_shape``): for highest kp × n4 × 4 bytes (kp and n4
    are rows and n rounded up to 64 and 4), 134 MB at the 8192 × 4096
    bucket; for bfloat16 half that, for bfloat16_3x the same. Above
    ``FOLD_ROWS`` rows it also allocates the fold workspace, 64 KiB per
    upper 128 × 128 tile (35 MB at n = 4096).
    """
    if x.device.type == "cpu":
        return fused_centered_gram_reference(x, mean, rowmul, precision)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_inputs(x, mean, rowmul)
    rows, n = x.shape
    mode = _MODES[_resolve(precision)]
    g = torch.empty((n, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(_scratch_shape(rows, n, mode),
                          dtype=_scratch_dtype(mode), device=x.device)
    kp = padded_depth(rows)
    fold = None
    if kp > FOLD_ROWS:
        fold = torch.empty(_kernel_fns()[3](n), dtype=torch.float32,
                           device=x.device)
    err = _launch(_kernel_fns()[0], x, x.data_ptr(), max(x.stride(0), n),
                  mean.data_ptr(), rowmul.data_ptr(), g.data_ptr(), rows, n,
                  mode, scratch.data_ptr(), kp,
                  None if fold is None else fold.data_ptr())
    _raise_on(err, "fused_centered_gram", x, mode)
    launches[KERNEL_NAMES[mode]] += 1
    return g


def covariance_fused(x, mask=None, mean_centering: bool = True,
                     device=None, precision: Optional[str] = None):
    """Covariance via the fused Gram: one float32 copy of the host matrix
    to ``device``, the masked mean on the device, then one fused Gram with
    ``rowmul = mask · 1/√(count − 1)``. Returns (cov[n, n], mean[n]) on
    ``device``. ``mask`` marks valid rows with 0/1; the count is the number
    of nonzero entries, an integer. ``device`` None is the entry points'
    device (the card unless the CPU is requested; see
    ``utils.resources.resolve_device``)."""
    device = resolve_device() if device is None else torch.device(device)
    dtype = torch.float32
    x_dev = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    x_dev = x_dev.contiguous()
    rows, n = x_dev.shape
    if mask is None:
        rowmask = torch.ones(rows, dtype=dtype, device=x_dev.device)
    else:
        rowmask = torch.as_tensor(np.asarray(mask), device=x_dev.device)
        rowmask = rowmask.to(dtype).contiguous()
    count = torch.count_nonzero(rowmask)
    if mean_centering:
        mean = (x_dev * rowmask[:, None]).sum(dim=0) / count
    else:
        mean = torch.zeros(n, dtype=dtype, device=x_dev.device)
    scale = 1.0 / torch.sqrt(torch.clamp(count - 1, min=1).to(dtype))
    cov = fused_centered_gram(x_dev, mean, rowmask * scale,
                              precision=precision)
    return cov, mean
