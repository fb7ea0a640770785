"""Jordan-Wigner fermion-to-qubit mapping (host).

The port's copy of esoo_tpu/ops/jw.py, a replacement for qiskit_nature's JordanWignerMapper (used by the
reference for both Hamiltonian construction and RDM operator measurement,
base_opt_orb_solver.py:268-302, README.md:34).

Convention: spin-orbital p maps to qubit p; occupied = |1>.

  a_p   = 1/2 (X_p + i Y_p) . Z_{p-1} ... Z_0
  a+_p  = 1/2 (X_p - i Y_p) . Z_{p-1} ... Z_0
"""

from __future__ import annotations

from .fermion import FermionicOp
from .pauli import SparsePauliOp


def _ladder(p: int, creation: bool, num_qubits: int) -> SparsePauliOp:
    lower = (1 << p) - 1
    bit = 1 << p
    # X-term: X_p Z_lower ; Y-term: Y_p Z_lower
    xs = [bit, bit]
    zs = [lower, lower | bit]
    sign = -0.5j if creation else 0.5j
    coeffs = [0.5, sign]
    return SparsePauliOp((xs, zs), coeffs, num_qubits=num_qubits)


class JordanWignerMapper:
    """Maps FermionicOp -> SparsePauliOp under the JW transform."""

    def __init__(self):
        self._ladder_cache = {}

    def _get_ladder(self, p: int, creation: bool, nq: int) -> SparsePauliOp:
        key = (p, creation, nq)
        if key not in self._ladder_cache:
            self._ladder_cache[key] = _ladder(p, creation, nq)
        return self._ladder_cache[key]

    def map(self, op: FermionicOp) -> SparsePauliOp:
        nq = op.num_spin_orbitals
        total = SparsePauliOp.zero(nq)
        for term, coeff in op.terms.items():
            if not term:
                total = total + SparsePauliOp.identity(nq) * coeff
                continue
            prod = None
            for action, mode in term:
                lad = self._get_ladder(mode, action == "+", nq)
                prod = lad if prod is None else prod.compose(lad)
            total = total + prod * coeff
        return total.simplify()
