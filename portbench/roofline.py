"""Peaks of the card and the operation counts that rooflines divide.

Peaks are NVIDIA's H100 SXM5 data sheet (dense rates, no sparsity), which
assume the card's full 700 W power limit; every result line names the
card and the run records its power limit where ``nvidia-smi`` reads it.
"""

from __future__ import annotations

H100_SXM = {
    "fp64_tensor_flops": 67e12,
    "fp64_flops": 34e12,
    "fp32_flops": 67e12,
    "tf32_tensor_flops": 495e12,
    "bf16_tensor_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def cholesky_flops(n: int) -> float:
    """Floating-point operations a Cholesky factorisation of an (n, n)
    matrix needs: n^3 / 3 to leading order."""
    return n ** 3 / 3.0


def cholesky_bytes(n: int, itemsize: int = 8) -> float:
    """Bytes a Cholesky factorisation must move: the matrix read once and
    its lower triangle written once."""
    return 1.5 * n * n * itemsize


def least_seconds(flops: float, bytes_moved: float, peak_flops: float,
                  peak_bytes: float = H100_SXM["hbm_bytes_per_s"]):
    """The least time a kernel could take: the larger of its operations
    over the compute peak and its bytes over the memory peak."""
    return max(flops / peak_flops, bytes_moved / peak_bytes)
