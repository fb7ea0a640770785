"""Drop-in interop with the qiskit-nature object surface (optional).

The port's copy of esoo_tpu/interop.py.  The reference consumes
qiskit-nature ``ElectronicStructureProblem`` instances and qiskit
``QubitMapper`` objects directly (reference
base_opt_orb_solver.py:22,87-91,115).  This module converts those into
the framework's native problem/mapper types so a reference example runs
with only the package import changed.  qiskit / qiskit-nature are
OPTIONAL — nothing here imports them at module load;
conversion is duck-typed on the qiskit-nature attribute surface, so the
adapter also works on structurally-compatible fakes (used by the tests,
which skip the real-qiskit assertions when qiskit is absent).
"""

from __future__ import annotations

import numpy as np

_QISKIT_MAPPER_NAMES = {
    "JordanWignerMapper": "JordanWignerMapper",
    "ParityMapper": "ParityMapper",
    "BravyiKitaevMapper": "BravyiKitaevMapper",
}


def _to_physicist(two_body: np.ndarray) -> np.ndarray:
    """qiskit-nature's ``to_physicist_ordering`` when importable, else the
    equivalent index transpose (chemist (pr|qs) -> physicist <pq|rs>)."""
    try:
        from qiskit_nature.second_q.operators.tensor_ordering import (
            IndexType, find_index_order, to_physicist_ordering)
        if find_index_order(two_body) == IndexType.PHYSICIST:
            return np.asarray(two_body)
        return np.asarray(to_physicist_ordering(two_body))
    except ImportError:
        return np.asarray(two_body).transpose(0, 2, 1, 3)


class AdaptedProblem:
    """Native problem view over a qiskit-nature ElectronicStructureProblem.

    Exposes ``integral_tensors()`` in the reference's convention — the
    exact two lines of reference base_opt_orb_solver.py:89-90:
    ``h = coeffs["+-"]``, ``g = -1 * to_physicist_ordering(coeffs["++--"])``.
    """

    def __init__(self, qn_problem):
        ham = qn_problem.hamiltonian
        coeffs = ham.electronic_integrals.second_q_coeffs()
        h = np.asarray(coeffs["+-"])
        g = -1.0 * _to_physicist(np.asarray(coeffs["++--"]))
        self._h = np.real(h).astype(np.float64)
        self._g = np.real(g).astype(np.float64)
        parts = getattr(qn_problem, "num_particles", None)
        if parts is not None:
            parts = (int(parts[0]), int(parts[1]))
        self.num_particles = parts
        self.nuclear_repulsion_energy = float(
            getattr(ham, "nuclear_repulsion_energy", 0.0) or 0.0)
        self.source = qn_problem

    @property
    def num_spin_orbitals(self) -> int:
        return self._h.shape[0]

    def integral_tensors(self):
        return self._h, self._g


def is_qiskit_nature_problem(obj) -> bool:
    """Duck-typed detection: qiskit-nature problems carry a .hamiltonian
    with .electronic_integrals and no native integral_tensors()."""
    return (not hasattr(obj, "integral_tensors")
            and hasattr(obj, "hamiltonian")
            and hasattr(getattr(obj, "hamiltonian"), "electronic_integrals"))


def from_qiskit_nature(qn_problem) -> AdaptedProblem:
    """qiskit-nature ElectronicStructureProblem -> native problem view."""
    return AdaptedProblem(qn_problem)


def is_qiskit_mapper(obj) -> bool:
    """A qiskit-nature QubitMapper instance (by module provenance)."""
    mod = type(obj).__module__ or ""
    return mod.startswith("qiskit_nature") and \
        type(obj).__name__ in _QISKIT_MAPPER_NAMES


def wrap_qiskit_mapper(mapper):
    """qiskit-nature JW/Parity/BK mapper -> the native equivalent.

    The three library encodings are reimplemented natively (ops/jw.py,
    ops/mappers.py, spectrum-equality tested); other QubitMapper
    subclasses have no native counterpart and raise."""
    name = type(mapper).__name__
    if name == "JordanWignerMapper":
        from .ops.jw import JordanWignerMapper
        return JordanWignerMapper()
    if name == "ParityMapper":
        if getattr(mapper, "num_particles", None) is not None:
            raise ValueError(
                "ParityMapper two-qubit reduction is not supported; "
                "construct it without num_particles")
        from .ops.mappers import ParityMapper
        return ParityMapper()
    if name == "BravyiKitaevMapper":
        from .ops.mappers import BravyiKitaevMapper
        return BravyiKitaevMapper()
    raise ValueError(
        f"no native equivalent for qiskit mapper {name!r}; use one of "
        f"JordanWignerMapper / ParityMapper / BravyiKitaevMapper, or a "
        f"native esoo_torch mapper")


def adapt(problem=None, mapper=None):
    """(problem, mapper) with any qiskit-nature objects converted."""
    if problem is not None and is_qiskit_nature_problem(problem):
        problem = from_qiskit_nature(problem)
    if mapper is not None and is_qiskit_mapper(mapper):
        mapper = wrap_qiskit_mapper(mapper)
    return problem, mapper
