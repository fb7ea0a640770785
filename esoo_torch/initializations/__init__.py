"""Determinant enumeration, CIS/CISD/FCI states and the default initial
partial unitary (host NumPy)."""

from .ci import (ci_matrix, enumerate_determinants, get_CIS_energies,
                 get_CIS_states, get_CISD_energies, get_CISD_states,
                 get_FCI_energies, get_FCI_states, hf_determinant)
from .hf_permutation import get_HF_permutation_matrix

__all__ = ["ci_matrix", "enumerate_determinants", "get_CIS_energies",
           "get_CIS_states", "get_CISD_energies", "get_CISD_states",
           "get_FCI_energies", "get_FCI_states", "get_HF_permutation_matrix",
           "hf_determinant"]
