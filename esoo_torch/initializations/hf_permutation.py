"""Default initial partial unitary (HF orbital selection); copy of
esoo_tpu/initializations/hf_permutation.py."""

from __future__ import annotations

import numpy as np


def get_HF_permutation_matrix(num_original_spin_orbitals: int,
                              num_spin_orbitals: int) -> np.ndarray:
    """(M/2) x (N/2) identity-like matrix selecting the lowest orbitals."""
    m = num_original_spin_orbitals // 2
    n = num_spin_orbitals // 2
    U = np.zeros((m, n), dtype=np.float64)
    for i in range(n):
        U[i, i] = 1.0
    return U
