"""Sparse second-quantized fermionic operators (host).

The port's copy of esoo_tpu/ops/fermion.py: a minimal equivalent of qiskit_nature's FermionicOp, sufficient for the
RDM element operators '+_p -_q' / '+_p +_q -_s -_r' and excitation generators
the reference constructs (base_opt_orb_solver.py:268-302, UCCSD generators).

A term is a tuple of (action, mode) pairs, action '+' or '-', applied left to
right as written (leftmost operator acts last on the ket, standard notation).
"""

from __future__ import annotations

from typing import Dict, Tuple

Term = Tuple[Tuple[str, int], ...]


class FermionicOp:
    """Weighted sum of normal products of fermionic ladder operators."""

    def __init__(self, data: Dict, num_spin_orbitals: int):
        """`data` maps label -> coeff; labels like '+_0 -_1' or term tuples."""
        self.num_spin_orbitals = num_spin_orbitals
        self.terms: Dict[Term, complex] = {}
        for key, coeff in data.items():
            term = self._parse(key) if isinstance(key, str) else tuple(key)
            self.terms[term] = self.terms.get(term, 0.0) + coeff

    @staticmethod
    def _parse(label: str) -> Term:
        ops = []
        for tok in label.split():
            action, mode = tok.split("_")
            ops.append((action, int(mode)))
        return tuple(ops)

    def adjoint(self) -> "FermionicOp":
        data = {}
        for term, coeff in self.terms.items():
            conj_term = tuple(
                ("+" if a == "-" else "-", m) for a, m in reversed(term)
            )
            data[conj_term] = data.get(conj_term, 0.0) + complex(coeff).conjugate()
        return FermionicOp(data, self.num_spin_orbitals)

    def __add__(self, other: "FermionicOp") -> "FermionicOp":
        data = dict(self.terms)
        for t, c in other.terms.items():
            data[t] = data.get(t, 0.0) + c
        return FermionicOp(data, self.num_spin_orbitals)

    def __mul__(self, scalar) -> "FermionicOp":
        return FermionicOp(
            {t: c * scalar for t, c in self.terms.items()},
            self.num_spin_orbitals,
        )

    __rmul__ = __mul__

    def __sub__(self, other):
        return self + other * (-1.0)

    def __repr__(self):
        parts = [
            " ".join(f"{a}_{m}" for a, m in t) + f": {c:.6g}"
            for t, c in list(self.terms.items())[:6]
        ]
        return f"FermionicOp({{{', '.join(parts)}}}, so={self.num_spin_orbitals})"
