"""Second-quantized electronic Hamiltonian construction (host SciPy).

The port's copy of esoo_tpu/ops/hamiltonian.py.  The reference rebuilds its qubit Hamiltonian every outer-loop iteration via
qiskit-nature (ElectronicEnergy.from_raw_integrals -> second_q_op ->
normal_order -> mapper.map; base_opt_orb_solver.py:584-612).  That path costs
O(N^4) symbolic operator mappings per iteration.

Here the JW structure is precomputed ONCE: the Pauli coefficients of

  H(h, g) = sum_pq h[p,q] a+_p a_q  +  sum_pqrs g[p,q,r,s] a+_p a+_q a_s a_r

are linear in (h, g), so we store sparse matrices A1, A2 with
coeffs = A1 @ h.ravel() + A2 @ g.ravel(), making the per-iteration rebuild a
pair of sparse matvecs.

The builder also attaches the raw (h, g) tensors to the emitted
SparsePauliOp (`.fermionic`), enabling the simulator's direct RDM-contraction
energy path which bypasses Pauli decomposition entirely.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from .fermion import FermionicOp
from .jw import JordanWignerMapper
from .pauli import SparsePauliOp


class ActiveSpaceHamiltonianBuilder:
    """Precomputed linear map from (h, g) tensors to JW Pauli coefficients."""

    def __init__(self, num_spin_orbitals: int, mapper: Optional[JordanWignerMapper] = None):
        self.N = num_spin_orbitals
        self.mapper = mapper or JordanWignerMapper()
        self._build_structure()

    def _build_structure(self):
        N = self.N
        mapper = self.mapper
        index = {}          # (x, z) -> pauli index
        xs, zs = [], []

        def key_idx(x, z):
            k = (x, z)
            if k not in index:
                index[k] = len(xs)
                xs.append(x)
                zs.append(z)
            return index[k]

        rows1, cols1, vals1 = [], [], []
        for p in range(N):
            for q in range(N):
                op = mapper.map(FermionicOp({f"+_{p} -_{q}": 1.0}, N))
                col = p * N + q
                for x, z, c in zip(op.xs, op.zs, op.coeffs):
                    rows1.append(key_idx(x, z))
                    cols1.append(col)
                    vals1.append(c)

        rows2, cols2, vals2 = [], [], []
        for p in range(N):
            for q in range(N):
                if p == q:
                    continue
                for r in range(N):
                    for s in range(N):
                        if r == s:
                            continue
                        op = mapper.map(
                            FermionicOp({f"+_{p} +_{q} -_{s} -_{r}": 1.0}, N)
                        )
                        col = ((p * N + q) * N + r) * N + s
                        for x, z, c in zip(op.xs, op.zs, op.coeffs):
                            rows2.append(key_idx(x, z))
                            cols2.append(col)
                            vals2.append(c)

        npauli = len(xs)
        self.xs = xs
        self.zs = zs
        self.A1 = sp.csr_matrix(
            (vals1, (rows1, cols1)), shape=(npauli, N * N), dtype=np.complex128
        )
        self.A2 = sp.csr_matrix(
            (vals2, (rows2, cols2)), shape=(npauli, N ** 4), dtype=np.complex128
        )

    def build(self, h: np.ndarray, g: np.ndarray,
              simplify_atol: float = 1e-12) -> SparsePauliOp:
        """Construct the qubit Hamiltonian for active-space tensors (h, g)."""
        h = np.asarray(h, dtype=np.complex128)
        g = np.asarray(g, dtype=np.complex128)
        coeffs = self.A1 @ h.ravel() + self.A2 @ g.ravel()
        keep = np.abs(coeffs) > simplify_atol
        op = SparsePauliOp(
            ([x for x, k in zip(self.xs, keep) if k],
             [z for z, k in zip(self.zs, keep) if k]),
            coeffs[keep],
            num_qubits=self.N,
        )
        if len(op) == 0:
            op = SparsePauliOp.zero(self.N)
        if isinstance(self.mapper, JordanWignerMapper):
            # the direct RDM/energy contraction paths read statevector
            # amplitudes in the occupation basis, which only the JW
            # encoding preserves — other mappers use the Pauli evaluators
            op.fermionic = (np.real(h).copy(), np.real(g).copy())
        return op


def hamiltonian_matrix(h: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Dense Fock-space matrix of H(h, g) — test oracle for small N."""
    N = h.shape[0]
    builder = ActiveSpaceHamiltonianBuilder(N)
    return builder.build(h, g).to_matrix()
