"""Device kernels: hand-written CUDA (csrc/) with their plain twins; and
the host operator algebra (Pauli, fermion, Jordan-Wigner and linear
mappers, the active-space Hamiltonian builder), copies of esoo_tpu/ops."""

from ._build import launch_counts, reset_launch_counts
from .fermion import FermionicOp
from .gemm import (matmul, matmul_plain, rotate_two_body_cuda,
                   rotate_two_body_plain)
from .hamiltonian import ActiveSpaceHamiltonianBuilder, hamiltonian_matrix
from .jw import JordanWignerMapper
from .mappers import BravyiKitaevMapper, LinearFermionicMapper, ParityMapper
from .pauli import SparsePauliOp

__all__ = ["ActiveSpaceHamiltonianBuilder", "BravyiKitaevMapper",
           "FermionicOp", "JordanWignerMapper", "LinearFermionicMapper",
           "ParityMapper", "SparsePauliOp", "hamiltonian_matrix",
           "launch_counts", "matmul", "matmul_plain", "reset_launch_counts",
           "rotate_two_body_cuda", "rotate_two_body_plain"]
