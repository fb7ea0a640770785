"""Parity and Bravyi-Kitaev fermion-to-qubit mappings (host).

The port's copy of esoo_tpu/ops/mappers.py.  The reference accepts any qiskit-nature ``QubitMapper`` wherever a mapper is
consumed (Hamiltonian rebuild and RDM operator construction,
base_opt_orb_solver.py:22,115,268-302); its tests and examples use
JordanWignerMapper, but ParityMapper / BravyiKitaevMapper are part of the
supported surface.  This module provides both, built on one observation:

Every *linear occupation encoding* — qubit j stores the GF(2) sum of a fixed
subset of mode occupations, ``|b> -> |A b>`` for an invertible binary matrix
``A`` — is related to Jordan-Wigner by the basis-permutation Clifford
``U_A |b> = |A b>``.  Conjugation of a Pauli term by ``U_A`` is pure
symplectic algebra on the (x, z) bitmasks:

    U_A  X^x Z^z  U_A^dagger  =  X^{A x}  Z^{A^{-T} z}

(X^x shifts the basis label, so its mask transforms by A; Z^z reads a parity
functional of the label, so its mask transforms by the inverse transpose.)
Applying this to the JW image of an operator term-by-term — with the phase
bookkeeping for our letter convention P = i^{|x&z|} X^x Z^z — yields the
encoded image exactly, for any invertible A.  Mutual (anti)commutation of
terms is preserved, so the UCC commuting-rotation product construction
(sim/ansatz.py) stays exact under these mappers.

  * Parity encoding: A is the prefix-sum matrix (qubit j stores
    n_0 + ... + n_j mod 2).
  * Bravyi-Kitaev: A is the Fenwick-tree matrix (qubit j stores the modes in
    the node covering (j - lowbit(j+1), j] — the standard beta_n, defined for
    every n, power of two or not).

Both mappers expose ``encode_mask`` so occupation-basis preparations
(HartreeFock) can place X gates on the encoded bit pattern.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .fermion import FermionicOp
from .jw import JordanWignerMapper
from .pauli import SparsePauliOp


def _gf2_inverse(A: np.ndarray) -> np.ndarray:
    """Inverse of a binary matrix over GF(2) (Gauss-Jordan)."""
    n = A.shape[0]
    M = np.concatenate([A.astype(np.uint8) % 2, np.eye(n, dtype=np.uint8)],
                       axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if M[row, col]:
                pivot = row
                break
        if pivot is None:
            raise ValueError("encoding matrix is singular over GF(2)")
        if pivot != col:
            M[[col, pivot]] = M[[pivot, col]]
        for row in range(n):
            if row != col and M[row, col]:
                M[row] ^= M[col]
    return M[:, n:]


def _rows_to_masks(A: np.ndarray) -> list:
    """Bitmask of each row (bit i set iff A[j, i] = 1)."""
    n = A.shape[0]
    return [int(sum(int(A[j, i]) << i for i in range(n))) for j in range(n)]


def _popcount(v: int) -> int:
    return bin(v).count("1")


class LinearFermionicMapper:
    """Fermion->qubit mapper defined by an invertible GF(2) occupation
    re-encoding ``|b> -> |A b>`` of the Jordan-Wigner representation.

    Subclasses supply the encoding matrix via ``_matrix(n)``.  ``map`` has
    the same contract as JordanWignerMapper.map (ops/jw.py:42): FermionicOp
    in, SparsePauliOp over ``num_spin_orbitals`` qubits out.
    """

    def __init__(self) -> None:
        self._jw = JordanWignerMapper()
        # per-n caches: row masks of A (for x-mask transform) and column
        # masks of A^{-1} (for the z-mask inverse-transpose transform)
        self._cache: Dict[int, Tuple[list, list]] = {}

    # -- subclass hook -------------------------------------------------------
    def _matrix(self, n: int) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- encoding structure --------------------------------------------------
    def _masks(self, n: int) -> Tuple[list, list]:
        got = self._cache.get(n)
        if got is None:
            A = np.asarray(self._matrix(n), dtype=np.uint8) % 2
            Ainv = _gf2_inverse(A)
            # (A x)_j = parity(row_j(A) & x); (A^{-T} z)_j = parity(col_j(A^{-1}) & z)
            got = (_rows_to_masks(A), _rows_to_masks(Ainv.T))
            self._cache[n] = got
        return got

    def encode_mask(self, mask: int, n: int) -> int:
        """Occupation bitmask b -> encoded qubit bitmask A b."""
        rows, _ = self._masks(n)
        out = 0
        for j in range(n):
            out |= (_popcount(rows[j] & mask) & 1) << j
        return out

    def decode_mask(self, mask: int, n: int) -> int:
        """Encoded qubit bitmask -> occupation bitmask (A^{-1} q)."""
        _, cols_inv = self._masks(n)
        # cols_inv[j] is column j of A^{-1} = row j of A^{-T}; decoding needs
        # rows of A^{-1}, i.e. transpose back
        out = 0
        for j in range(n):
            bit = 0
            for i in range(n):
                if (cols_inv[i] >> j) & 1 and (mask >> i) & 1:
                    bit ^= 1
            out |= bit << j
        return out

    # -- mapping -------------------------------------------------------------
    def map(self, op: FermionicOp) -> SparsePauliOp:
        nq = op.num_spin_orbitals
        rows, cols_inv = self._masks(nq)
        jw_op = self._jw.map(op)
        xs, zs, coeffs = [], [], []
        for x, z, c in zip(jw_op.xs, jw_op.zs, jw_op.coeffs):
            x2 = 0
            z2 = 0
            for j in range(nq):
                x2 |= (_popcount(rows[j] & x) & 1) << j
                z2 |= (_popcount(cols_inv[j] & z) & 1) << j
            # letter convention P = i^{|x&z|} X^x Z^z: re-express the
            # conjugated i^{|x&z|} X^{x'} Z^{z'} in the same convention
            phase = (1j) ** ((_popcount(x & z) - _popcount(x2 & z2)) % 4)
            xs.append(x2)
            zs.append(z2)
            coeffs.append(c * phase)
        return SparsePauliOp((xs, zs), coeffs, num_qubits=nq).simplify()


class ParityMapper(LinearFermionicMapper):
    """Parity encoding: qubit j stores n_0 + ... + n_j (mod 2).

    The dual of JW: occupation becomes two-local (Z_{j-1} Z_j) while the
    ladder-operator string support moves from the parity Z-chain to the
    update X-chain on qubits > j.
    """

    def _matrix(self, n: int) -> np.ndarray:
        return np.tril(np.ones((n, n), dtype=np.uint8))


class BravyiKitaevMapper(LinearFermionicMapper):
    """Bravyi-Kitaev encoding via the Fenwick-tree matrix: qubit j stores
    the modes in (j - lowbit(j+1), j] (0-indexed), giving O(log n) support
    for both occupations and parities.  Defined for every n (the tree is
    the standard binary-indexed-tree shape, not padded to a power of two).
    """

    def _matrix(self, n: int) -> np.ndarray:
        A = np.zeros((n, n), dtype=np.uint8)
        for j in range(n):
            node = j + 1
            low = node & -node
            A[j, node - low:node] = 1  # modes (j - lowbit, j-1]
            A[j, j] = 1                # plus mode j itself
        return A
