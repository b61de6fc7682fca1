"""Scalar dtype policy for the PyTorch port.

Reference parity: the C++ library restricts scalars with ``ScalarConcept``
(reference src/core/types.hpp:28-30) to floating-point and
``std::complex`` of floating-point. Here the same contract is a set of
allowed torch dtypes. Functions accept torch dtypes and anything
``numpy.dtype`` accepts (``np.float64``, ``"complex64"``...) and return torch
dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

# The allowed scalar dtypes (the ScalarConcept analogue).
REAL_DTYPES = (torch.float32, torch.float64)
COMPLEX_DTYPES = (torch.complex64, torch.complex128)
SCALAR_DTYPES = REAL_DTYPES + COMPLEX_DTYPES


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the JAX package's spelling)."""
    return str(dtype).removeprefix("torch.")


def as_torch_dtype(dtype) -> torch.dtype:
    """Any dtype-like (torch dtype, numpy dtype or type, string) as a torch
    dtype, without the scalar-concept check. ``bfloat16`` is taken by name,
    since numpy knows it only through ``ml_dtypes``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    if dt.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dt)).dtype


def canonical_dtype(dtype) -> torch.dtype:
    """Validate and canonicalise a scalar dtype.

    Raises ``TypeError`` for dtypes outside the scalar concept (ints, bools,
    bf16...), mirroring the compile-time rejection by ``ScalarConcept``.
    """
    try:
        dt = as_torch_dtype(dtype)
    except TypeError:
        dt = None
    if dt in SCALAR_DTYPES:
        return dt
    shown = dtype_name(dt) if dt is not None else np.dtype(dtype).name
    raise TypeError(
        f"dtype {shown} does not satisfy the scalar concept "
        f"(allowed: float32, float64, complex64, complex128)"
    )


def numpy_dtype(dtype) -> np.dtype | None:
    """The numpy dtype of a scalar dtype, checked (None stays None)."""
    if dtype is None:
        return None
    return torch.empty(0, dtype=canonical_dtype(dtype)).numpy().dtype


def is_complex_dtype(dtype) -> bool:
    """``is_complex_of_floating`` analogue (types.hpp:15-21)."""
    return as_torch_dtype(dtype).is_complex


def real_dtype_of(dtype) -> torch.dtype:
    """The real dtype underlying a scalar dtype (NumTraits<Scalar>::Real)."""
    dt = canonical_dtype(dtype)
    return dt.to_real() if dt.is_complex else dt


def complex_dtype_of(dtype) -> torch.dtype:
    """The complex dtype with the same precision as ``dtype``."""
    dt = canonical_dtype(dtype)
    return dt if dt.is_complex else dt.to_complex()


def check_scalar_type(array_dtype, expected_dtype, what: str) -> None:
    """Runtime scalar-type guard.

    Parity with ``M.scalar_type() != typeid(Scalar)`` checks that raise
    ``std::runtime_error("...: scalar type mismatch")`` (e.g.
    power_method.hpp:137-139). Raises ``TypeError``.
    """
    stored, requested = as_torch_dtype(array_dtype), as_torch_dtype(expected_dtype)
    if stored != requested:
        raise TypeError(f"{what}: scalar type mismatch "
                        f"(stored {dtype_name(stored)}, requested {dtype_name(requested)})")
