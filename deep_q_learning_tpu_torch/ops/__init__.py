"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel module gives the bytes and float operations a call needs at
its shapes (``*_work``); :func:`bound_us` turns them into the least time an
H100 SXM could take for the call, at its published peaks."""

H100_HBM_BYTES_PER_S = 3.35e12  # device memory rate
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def bound_us(work) -> float:
    """The least µs for ``(bytes, operations)``: the larger of the bytes
    over the memory rate and the operations over the float32 rate."""
    nbytes, ops = work
    return 1e6 * max(nbytes / H100_HBM_BYTES_PER_S, ops / H100_FP32_OPS_PER_S)


def bound_by(work) -> str:
    nbytes, ops = work
    return "bytes" if nbytes / H100_HBM_BYTES_PER_S >= ops / H100_FP32_OPS_PER_S else "operations"
