"""The H100's published peaks (NVIDIA's data sheet, SXM part, dense, at the
700 W limit), the yardstick of every roofline share here. A share states
the card's power limit beside it in PERF.md."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # outside the tensor cores

ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}


def bound_s(nbytes: float, flops: float, dtype: str = "float32") -> float:
    """The least time the card could take: the bytes over the memory rate or
    the operations over the peak rate of their type, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def complex_itemsize(dtype: str) -> int:
    """Bytes of one complex entry of a real dtype's complex counterpart."""
    return 2 * ITEMSIZE[dtype]
