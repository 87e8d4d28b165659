"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): HBM3 at 3.35 TB/s, 67 TFLOP/s in
float32 outside the tensor cores.  The hand kernels compute in int32 and
float32 on the CUDA cores, so the float32 rate is their compute peak."""

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def roofline_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of
    the bytes over the memory rate and the operations over the f32 rate."""
    return max(nbytes / HBM_BYTES_S, ops / F32_OPS_S)
