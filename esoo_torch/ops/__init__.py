"""Device kernels: hand-written CUDA (csrc/) with their plain twins."""

from .gemm import (launch_counts, matmul, matmul_plain,
                   reset_launch_counts, rotate_two_body_cuda,
                   rotate_two_body_plain)

__all__ = ["launch_counts", "matmul", "matmul_plain", "reset_launch_counts",
           "rotate_two_body_cuda", "rotate_two_body_plain"]
