"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "bfloat16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
}


def bound_s(n_bytes: float, n_ops: float, dtype: str):
    """(seconds, "bytes" or "operations"): the least time the chip needs,
    the larger of bytes over the memory rate and operations over the
    type's peak."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_o = n_ops / FLOPS[dtype]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def conv_type(allow_tf32: bool) -> str:
    """The peak a float32 cuDNN convolution is held to."""
    return "tf32" if allow_tf32 else "float32"
