"""Quantum circuit IR for the statevector simulator (host).

The port's copy of esoo_tpu/sim/circuit.py: the qiskit.QuantumCircuit
surface the reference uses (ansatz circuits, initial states,
`assign_parameters`, `compose`).  Gates are stored as a flat list;
parameterized angles are linear expressions ``mult * theta[idx] +
offset``, which is what UCCSD Pauli-rotation products and
hardware-efficient ansaetze need, and keeps the compiled simulation a
function of the parameter vector alone.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np


class Parameter:
    """A symbolic angle; arithmetic yields linear ParamExpr objects."""

    __slots__ = ("idx", "name")

    def __init__(self, idx: int, name: Optional[str] = None):
        self.idx = idx
        self.name = name or f"theta[{idx}]"

    def __mul__(self, k):
        return ParamExpr(self.idx, float(k), 0.0)

    __rmul__ = __mul__

    def __neg__(self):
        return ParamExpr(self.idx, -1.0, 0.0)

    def __add__(self, c):
        return ParamExpr(self.idx, 1.0, float(c))

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class ParamExpr:
    idx: int
    mult: float = 1.0
    offset: float = 0.0

    def __mul__(self, k):
        return ParamExpr(self.idx, self.mult * float(k), self.offset * float(k))

    __rmul__ = __mul__

    def __neg__(self):
        return ParamExpr(self.idx, -self.mult, -self.offset)

    def __add__(self, c):
        return ParamExpr(self.idx, self.mult, self.offset + float(c))

    __radd__ = __add__

    def __sub__(self, c):
        return ParamExpr(self.idx, self.mult, self.offset - float(c))


AngleLike = Union[float, Parameter, ParamExpr]


def _as_expr(angle: AngleLike):
    """Normalize to ('const', value) or ('param', idx, mult, offset)."""
    if isinstance(angle, Parameter):
        return ("param", angle.idx, 1.0, 0.0)
    if isinstance(angle, ParamExpr):
        return ("param", angle.idx, angle.mult, angle.offset)
    return ("const", float(angle))


@dataclasses.dataclass(frozen=True)
class Gate:
    name: str
    qubits: Tuple[int, ...]
    angle: Optional[tuple] = None      # output of _as_expr, or None
    data: Optional[tuple] = None       # extra static data (e.g. pauli masks)


class QuantumCircuit:
    """Minimal parameterized circuit with a qiskit-like construction API."""

    def __init__(self, num_qubits: int):
        self.num_qubits = num_qubits
        self.gates: List[Gate] = []
        self._num_parameters = 0
        # optional per-parameter (low, high) bounds, as on qiskit ansatz
        # circuits (consumed by SSVQE._validate_bounds, reference
        # ssvqe.py:596-640); None = unbounded
        self.parameter_bounds = None

    # -- parameters ------------------------------------------------------
    @property
    def num_parameters(self) -> int:
        return self._num_parameters

    def parameter(self) -> Parameter:
        p = Parameter(self._num_parameters)
        self._num_parameters += 1
        return p

    def parameters_vector(self, n: int) -> List[Parameter]:
        return [self.parameter() for _ in range(n)]

    def _register_angle(self, angle: AngleLike):
        expr = _as_expr(angle)
        if expr[0] == "param":
            self._num_parameters = max(self._num_parameters, expr[1] + 1)
        return expr

    # -- gate constructors -------------------------------------------------
    def _add(self, name, qubits, angle=None, data=None):
        self.gates.append(
            Gate(name, tuple(qubits),
                 self._register_angle(angle) if angle is not None else None,
                 data)
        )
        return self

    def x(self, q): return self._add("x", [q])
    def y(self, q): return self._add("y", [q])
    def z(self, q): return self._add("z", [q])
    def h(self, q): return self._add("h", [q])
    def s(self, q): return self._add("s", [q])
    def sdg(self, q): return self._add("sdg", [q])
    def t(self, q): return self._add("t", [q])
    def rx(self, angle, q): return self._add("rx", [q], angle)
    def ry(self, angle, q): return self._add("ry", [q], angle)
    def rz(self, angle, q): return self._add("rz", [q], angle)
    def p(self, angle, q): return self._add("p", [q], angle)
    def cx(self, c, t): return self._add("cx", [c, t])
    def cz(self, c, t): return self._add("cz", [c, t])
    def cy(self, c, t): return self._add("cy", [c, t])
    def swap(self, a, b): return self._add("swap", [a, b])
    def crx(self, angle, c, t): return self._add("crx", [c, t], angle)
    def cry(self, angle, c, t): return self._add("cry", [c, t], angle)
    def crz(self, angle, c, t): return self._add("crz", [c, t], angle)
    def cp(self, angle, c, t): return self._add("cp", [c, t], angle)

    def barrier(self, *args):
        return self

    def pauli_rot(self, angle: AngleLike, x_mask: int, z_mask: int):
        """exp(-i angle/2 * P) with P given by letter bitmasks."""
        y = bin(x_mask & z_mask).count("1")
        return self._add("prot", [], angle, data=(x_mask, z_mask, y))

    def initialize_statevector(self, vec: np.ndarray):
        """Set the state to an explicit vector (must be the first operation)."""
        if self.gates:
            raise ValueError("initialize_statevector must come first")
        return self._add("init_sv", [], data=(np.asarray(vec, dtype=np.complex128),))

    # -- composition -------------------------------------------------------
    def compose(self, other: "QuantumCircuit", front: bool = False) -> "QuantumCircuit":
        """Concatenate circuits. Parameter indices of `other` are shifted past
        this circuit's parameters (distinct parameter spaces, like qiskit)."""
        if other.num_qubits != self.num_qubits:
            raise ValueError("qubit count mismatch in compose")
        out = QuantumCircuit(self.num_qubits)
        shift = self._num_parameters  # other's params always follow self's

        def shifted(gates, offset):
            res = []
            for gt in gates:
                ang = gt.angle
                if ang is not None and ang[0] == "param":
                    ang = ("param", ang[1] + offset, ang[2], ang[3])
                res.append(Gate(gt.name, gt.qubits, ang, gt.data))
            return res

        if front:
            out.gates = shifted(other.gates, shift) + shifted(self.gates, 0)
        else:
            out.gates = shifted(self.gates, 0) + shifted(other.gates, shift)
        out._num_parameters = self._num_parameters + other._num_parameters
        # a non-occupation encoding on either side poisons the composite
        # (direct-RDM/sector consumers treat missing/'jw' as occupation basis)
        enc_a = getattr(self, "_encoding", None)
        enc_b = getattr(other, "_encoding", None)
        non_jw = [e for e in (enc_a, enc_b) if e is not None and e != "jw"]
        if non_jw:
            out._encoding = non_jw[0]
        elif enc_a is not None or enc_b is not None:
            out._encoding = "jw"
        if self.parameter_bounds is not None or other.parameter_bounds is not None:
            mine = self.parameter_bounds or [(None, None)] * self._num_parameters
            theirs = (other.parameter_bounds
                      or [(None, None)] * other._num_parameters)
            out.parameter_bounds = (list(theirs) + list(mine) if front
                                    else list(mine) + list(theirs))
        return out

    def copy(self) -> "QuantumCircuit":
        out = QuantumCircuit(self.num_qubits)
        out.gates = list(self.gates)
        out._num_parameters = self._num_parameters
        if hasattr(self, "_encoding"):
            out._encoding = self._encoding
        return out

    def assign_parameters(self, values) -> "QuantumCircuit":
        """Bind parameters to numeric values; returns a parameter-free circuit."""
        if isinstance(values, dict):
            arr = np.zeros(self._num_parameters)
            for k, v in values.items():
                idx = k.idx if isinstance(k, Parameter) else int(k)
                arr[idx] = v
            values = arr
        values = np.asarray(values, dtype=np.float64)
        if values.shape[0] != self._num_parameters:
            raise ValueError(
                f"expected {self._num_parameters} values, got {values.shape[0]}")
        out = QuantumCircuit(self.num_qubits)
        for gt in self.gates:
            ang = gt.angle
            if ang is not None and ang[0] == "param":
                ang = ("const", float(ang[2] * values[ang[1]] + ang[3]))
            out.gates.append(Gate(gt.name, gt.qubits, ang, gt.data))
        out._num_parameters = 0
        if hasattr(self, "_encoding"):
            out._encoding = self._encoding
        return out

    # -- identity for caching ----------------------------------------------
    def fingerprint(self) -> tuple:
        fp = []
        for gt in self.gates:
            data = gt.data
            if data is not None and gt.name == "init_sv":
                data = (data[0].tobytes(),)
            fp.append((gt.name, gt.qubits, gt.angle, data))
        return (self.num_qubits, self._num_parameters, tuple(fp))

    def __repr__(self):
        return (f"QuantumCircuit(qubits={self.num_qubits}, "
                f"gates={len(self.gates)}, params={self._num_parameters})")
