"""Bitmask-based Pauli operator algebra (host NumPy).

The port's copy of esoo_tpu/ops/pauli.py: a replacement for
qiskit.quantum_info.SparsePauliOp.  Terms are stored as integer bitmasks
(x, z) plus complex coefficients, the representation the statevector
kernels (sim/statevector.py) read:

  P = i^{|x & z|} * X^x * Z^z      (letter convention: Y on bits of x & z)
  (P s)[c] = i^{|x&z|} * (-1)^{popcount((c ^ x) & z)} * s[c ^ x]

Qubit j corresponds to bit j (little-endian); string labels follow the qiskit
convention of qubit n-1 leftmost.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

_PAULI_XZ = {"I": (0, 0), "X": (1, 0), "Y": (1, 1), "Z": (0, 1)}
_XZ_PAULI = {v: k for k, v in _PAULI_XZ.items()}


def label_to_masks(label: str) -> Tuple[int, int]:
    x = z = 0
    n = len(label)
    for i, ch in enumerate(label):
        q = n - 1 - i
        xb, zb = _PAULI_XZ[ch]
        x |= xb << q
        z |= zb << q
    return x, z


def masks_to_label(x: int, z: int, num_qubits: int) -> str:
    return "".join(
        _XZ_PAULI[((x >> q) & 1, (z >> q) & 1)]
        for q in range(num_qubits - 1, -1, -1)
    )


def _popcount(v: int) -> int:
    return bin(v).count("1")


def pauli_mul(x1: int, z1: int, x2: int, z2: int) -> Tuple[int, int, complex]:
    """Product of two letter-Paulis: returns (x, z, phase)."""
    x, z = x1 ^ x2, z1 ^ z2
    k = (
        _popcount(x1 & z1)
        + _popcount(x2 & z2)
        - _popcount(x & z)
        + 2 * _popcount(z1 & x2)
    ) % 4
    return x, z, (1j) ** k


class SparsePauliOp:
    """Weighted sum of Pauli strings over `num_qubits` qubits."""

    __slots__ = ("num_qubits", "xs", "zs", "coeffs", "fermionic",
                 "_fermionic_tensors")

    def __init__(self, data, coeffs=None, num_qubits: int | None = None):
        """Accepts a label, list of labels, or (xs, zs) mask arrays."""
        self.fermionic = None  # optional (h, g) active-space tensors fast path
        # the same (h, g) as device tensors, when an OptOrb solver made them
        self._fermionic_tensors = None
        if isinstance(data, str):
            data = [data]
            if coeffs is None:
                coeffs = [1.0]
        if isinstance(data, (list, tuple)) and data and isinstance(data[0], str):
            self.num_qubits = len(data[0])
            masks = [label_to_masks(lb) for lb in data]
            self.xs = [m[0] for m in masks]
            self.zs = [m[1] for m in masks]
            self.coeffs = np.asarray(
                coeffs if coeffs is not None else np.ones(len(data)),
                dtype=np.complex128,
            )
        else:
            xs, zs = data
            assert num_qubits is not None
            self.num_qubits = num_qubits
            self.xs = list(xs)
            self.zs = list(zs)
            self.coeffs = np.asarray(coeffs, dtype=np.complex128)

    # -- constructors --------------------------------------------------
    @classmethod
    def from_list(cls, items: Iterable[Tuple[str, complex]]) -> "SparsePauliOp":
        labels, coeffs = zip(*items)
        return cls(list(labels), list(coeffs))

    @classmethod
    def identity(cls, num_qubits: int) -> "SparsePauliOp":
        return cls(([0], [0]), [1.0], num_qubits=num_qubits)

    @classmethod
    def zero(cls, num_qubits: int) -> "SparsePauliOp":
        return cls(([], []), [], num_qubits=num_qubits)

    # -- views ----------------------------------------------------------
    def to_list(self) -> List[Tuple[str, complex]]:
        return [
            (masks_to_label(x, z, self.num_qubits), complex(c))
            for x, z, c in zip(self.xs, self.zs, self.coeffs)
        ]

    @property
    def labels(self) -> List[str]:
        return [masks_to_label(x, z, self.num_qubits) for x, z in zip(self.xs, self.zs)]

    def mask_arrays(self):
        """(xs, zs, ycounts, coeffs) as numpy arrays for the kernels."""
        xs = np.asarray(self.xs, dtype=np.int64)
        zs = np.asarray(self.zs, dtype=np.int64)
        ys = np.array([_popcount(x & z) for x, z in zip(self.xs, self.zs)],
                      dtype=np.int64)
        return xs, zs, ys, np.asarray(self.coeffs, dtype=np.complex128)

    def __len__(self):
        return len(self.xs)

    def __repr__(self):
        items = ", ".join(
            f"{lb}: {c:.6g}" for lb, c in self.to_list()[:8]
        )
        more = "" if len(self) <= 8 else f", ... ({len(self)} terms)"
        return f"SparsePauliOp([{items}{more}], qubits={self.num_qubits})"

    # -- algebra ----------------------------------------------------------
    def __add__(self, other: "SparsePauliOp") -> "SparsePauliOp":
        assert self.num_qubits == other.num_qubits
        out = SparsePauliOp(
            (self.xs + other.xs, self.zs + other.zs),
            np.concatenate([self.coeffs, other.coeffs]),
            num_qubits=self.num_qubits,
        )
        return out

    def __mul__(self, scalar: complex) -> "SparsePauliOp":
        return SparsePauliOp(
            (list(self.xs), list(self.zs)),
            self.coeffs * scalar,
            num_qubits=self.num_qubits,
        )

    __rmul__ = __mul__

    def __sub__(self, other):
        return self + (other * (-1.0))

    def compose(self, other: "SparsePauliOp") -> "SparsePauliOp":
        """Operator product self @ other."""
        assert self.num_qubits == other.num_qubits
        xs, zs, cs = [], [], []
        for x1, z1, c1 in zip(self.xs, self.zs, self.coeffs):
            for x2, z2, c2 in zip(other.xs, other.zs, other.coeffs):
                x, z, ph = pauli_mul(x1, z1, x2, z2)
                xs.append(x)
                zs.append(z)
                cs.append(c1 * c2 * ph)
        return SparsePauliOp((xs, zs), cs, num_qubits=self.num_qubits).simplify()

    def __matmul__(self, other):
        return self.compose(other)

    def adjoint(self) -> "SparsePauliOp":
        return SparsePauliOp(
            (list(self.xs), list(self.zs)),
            np.conj(self.coeffs),
            num_qubits=self.num_qubits,
        )

    def simplify(self, atol: float = 1e-13) -> "SparsePauliOp":
        """Combine duplicate terms and drop near-zero coefficients."""
        acc = {}
        for x, z, c in zip(self.xs, self.zs, self.coeffs):
            key = (x, z)
            acc[key] = acc.get(key, 0.0) + c
        xs, zs, cs = [], [], []
        for (x, z), c in acc.items():
            if abs(c) > atol:
                xs.append(x)
                zs.append(z)
                cs.append(c)
        if not xs:  # keep a zero identity so the op stays well formed
            xs, zs, cs = [0], [0], [0.0]
        return SparsePauliOp((xs, zs), cs, num_qubits=self.num_qubits)

    def equiv(self, other: "SparsePauliOp", atol: float = 1e-10) -> bool:
        d = (self - other).simplify(atol=atol)
        return len(d) == 1 and d.xs[0] == 0 and d.zs[0] == 0 and abs(d.coeffs[0]) <= atol

    def is_hermitian(self, atol: float = 1e-10) -> bool:
        return self.equiv(self.adjoint(), atol=atol)

    # -- dense matrix (small-n testing / exact solvers) ------------------
    def to_matrix(self) -> np.ndarray:
        from ..sim.strings import _bitcount
        n = self.num_qubits
        dim = 1 << n
        idx = np.arange(dim)
        H = np.zeros((dim, dim), dtype=np.complex128)
        for x, z, c in zip(self.xs, self.zs, self.coeffs):
            y = _popcount(x & z)
            cols = idx ^ x
            signs = 1 - 2 * (_bitcount(np.bitwise_and(cols, z)) % 2)
            H[idx, cols] += c * (1j) ** y * signs
        return H
