"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit; a card set lower runs below them)."""

#: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12

#: dense rates, floating-point operations a second (float32 and float64
#: outside the tensor cores)
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12,
              "float16": 989e12}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card can take to do ``flops`` operations of
    ``dtype`` and move ``nbytes``: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
