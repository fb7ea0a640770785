"""Ansatz circuit library (host).

The port's copy of esoo_tpu/sim/ansatz.py: the qiskit / qiskit-nature
circuit pieces the reference relies on, built as `sim.circuit`
circuits:
  - HartreeFock initial state (and `OccupationState`, any X-only
    occupation preparation)
  - UCCSD / UCC (excitation-based chemistry ansatz; generators mapped by JW
    or a linear mapper and implemented as exact products of commuting
    Pauli rotations)
  - RealAmplitudes / EfficientSU2 / TwoLocal hardware-efficient circuits

UCCSD exactness note: the JW image of a single anti-Hermitian excitation
generator T - T^dagger is i * sum_k w_k P_k with all P_k mutually commuting,
so exp(theta (T - T+)) equals the *product* of the individual Pauli
rotations — no Trotter error within one excitation (same construction qiskit
uses).  Ordering between excitations matches the enumeration order below,
and defines the parameter order the sector simulator (sim/sector.py)
reads from `_ucc_excitations`.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple

from ..ops.fermion import FermionicOp
from ..ops.jw import JordanWignerMapper
from .circuit import QuantumCircuit


def _encoding_of(mapper) -> str:
    """Encoding tag for circuits: 'jw' iff amplitudes are in the occupation
    basis (the assumption behind every direct-RDM / sector fast path)."""
    if mapper is None or isinstance(mapper, JordanWignerMapper):
        return "jw"
    return type(mapper).__name__.lower()


def hartree_fock_bitmask(num_spatial_orbitals: int,
                         num_particles: Tuple[int, int]) -> int:
    """Occupation bitmask: alpha 0..na-1, beta n..n+nb-1 (block ordering)."""
    n = num_spatial_orbitals
    na, nb = num_particles
    mask = 0
    for i in range(na):
        mask |= 1 << i
    for i in range(nb):
        mask |= 1 << (n + i)
    return mask


def HartreeFock(num_spatial_orbitals: int, num_particles: Tuple[int, int],
                qubit_mapper=None) -> QuantumCircuit:
    """X-gate preparation of the HF determinant (cf. qiskit-nature HartreeFock).

    For linear-encoding mappers (parity / Bravyi-Kitaev, ops/mappers.py) the
    occupation bitmask is re-encoded, matching qiskit-nature's mapper-aware
    HartreeFock behavior."""
    nq = 2 * num_spatial_orbitals
    qc = QuantumCircuit(nq)
    mask = hartree_fock_bitmask(num_spatial_orbitals, num_particles)
    if qubit_mapper is not None and hasattr(qubit_mapper, "encode_mask"):
        mask = qubit_mapper.encode_mask(mask, nq)
    for q in range(nq):
        if (mask >> q) & 1:
            qc.x(q)
    qc._encoding = _encoding_of(qubit_mapper)
    return qc


def OccupationState(num_qubits: int, mask: int) -> QuantumCircuit:
    """X-gate preparation of the occupation-basis state |mask> (the form
    of an initial state the sector simulator reads; JW encoding)."""
    qc = QuantumCircuit(num_qubits)
    for q in range(num_qubits):
        if (int(mask) >> q) & 1:
            qc.x(q)
    qc._encoding = "jw"
    return qc


def generate_excitations(num_spatial_orbitals: int,
                         num_particles: Tuple[int, int],
                         excitations: str = "sd",
                         generalized: bool = False):
    """Spin-conserving excitation list.

    Returns list of (occ_tuple, virt_tuple) in spin-orbital indices
    (alpha block first).  Mirrors qiskit-nature's default UCC behavior:
    singles preserve spin; doubles preserve total Sz.
    """
    n = num_spatial_orbitals
    na, nb = num_particles
    occ_a = list(range(na))
    vir_a = list(range(na, n))
    occ_b = [n + i for i in range(nb)]
    vir_b = [n + i for i in range(nb, n)]
    if generalized:
        occ_a = vir_a = list(range(n))
        occ_b = vir_b = [n + i for i in range(n)]

    singles = [
        ((i,), (a,)) for i, a in itertools.product(occ_a, vir_a)
    ] + [
        ((i,), (a,)) for i, a in itertools.product(occ_b, vir_b)
    ]

    occ_all = occ_a + occ_b
    vir_all = vir_a + vir_b

    def spin(so):
        return 0 if so < n else 1

    doubles = []
    for i, j in itertools.combinations(occ_all, 2):
        for a, b in itertools.combinations(vir_all, 2):
            if spin(i) + spin(j) == spin(a) + spin(b):
                doubles.append(((i, j), (a, b)))

    out = []
    if "s" in excitations:
        out += singles
    if "d" in excitations:
        out += doubles
    return out


def UCC(num_spatial_orbitals: int,
        num_particles: Tuple[int, int],
        excitations: str = "sd",
        qubit_mapper: Optional[JordanWignerMapper] = None,
        initial_state: Optional[QuantumCircuit] = None,
        reps: int = 1,
        generalized: bool = False) -> QuantumCircuit:
    """Unitary coupled-cluster ansatz: prod_k exp(theta_k (T_k - T_k+))."""
    nq = 2 * num_spatial_orbitals
    mapper = qubit_mapper if qubit_mapper is not None \
        else JordanWignerMapper()
    qc = QuantumCircuit(nq)
    if initial_state is not None:
        qc = initial_state.copy()
        if qc.num_parameters:
            raise ValueError("initial_state must be parameter free")

    excs = generate_excitations(num_spatial_orbitals, num_particles,
                                excitations, generalized)
    pool = []          # rotation groups, one per (rep, excitation)
    for _ in range(reps):
        for occ, vir in excs:
            theta = qc.parameter()
            group = excitation_rotation_group(occ, vir, nq, mapper)
            pool.append(group)
            for x, z, w in group:
                # exp(i theta w P) == exp(-i (-2 w theta)/2 P)
                qc.pauli_rot(theta * (-2.0 * w), x, z)
    # metadata consumed by AdaptVQE (operator pool + excitation labels)
    qc._ucc_pool = pool
    qc._ucc_excitations = excs * reps
    qc._ucc_initial_state = initial_state
    # amplitudes are occupation-basis only under JW; direct-RDM/sector
    # consumers check this tag (a parity/BK-mapped UCC state must go
    # through per-Pauli measurement, cf. base.py rdm_measurement guard)
    qc._encoding = _encoding_of(mapper)
    if initial_state is not None:
        init_enc = getattr(initial_state, "_encoding", "jw")
        if init_enc != qc._encoding:
            raise ValueError(
                f"initial_state encoding {init_enc!r} does not match the "
                f"UCC mapper encoding {qc._encoding!r}")
    return qc


def excitation_rotation_group(occ, vir, num_qubits: int,
                              mapper: Optional[JordanWignerMapper] = None):
    """JW image of T - T+ for one excitation as [(x, z, w), ...], w real.

    exp(theta (T - T+)) = prod_k exp(i theta w_k P_k) exactly (commuting set).
    """
    mapper = mapper or JordanWignerMapper()
    ops = " ".join(f"+_{a}" for a in vir) + " " + \
          " ".join(f"-_{i}" for i in reversed(occ))
    T = FermionicOp({ops: 1.0}, num_qubits)
    gen = T - T.adjoint()
    pauli = mapper.map(gen)      # = i * sum_k w_k P_k with real w_k
    group = []
    for x, z, c in zip(pauli.xs, pauli.zs, pauli.coeffs):
        if abs(c.real) > 1e-12:
            # every linear encoding (JW/parity/BK) keeps the image of an
            # anti-Hermitian generator purely imaginary; a real residue
            # means the supplied mapper is inconsistent
            raise ValueError(
                "mapper produced a non-imaginary excitation-generator "
                f"coefficient {c}; cannot build exact rotation product")
        w = c.imag
        if abs(w) > 1e-14:
            group.append((x, z, w))
    return group


def UCCSD(num_spatial_orbitals: int,
          num_particles: Tuple[int, int],
          qubit_mapper=None,
          initial_state: Optional[QuantumCircuit] = None,
          reps: int = 1,
          generalized: bool = False) -> QuantumCircuit:
    return UCC(num_spatial_orbitals, num_particles, "sd", qubit_mapper,
               initial_state, reps, generalized)


def _entangler_pairs(num_qubits: int, entanglement: str):
    if entanglement == "linear":
        return [(i, i + 1) for i in range(num_qubits - 1)]
    if entanglement == "reverse_linear":
        return [(i, i + 1) for i in range(num_qubits - 2, -1, -1)]
    if entanglement == "circular":
        pairs = [(num_qubits - 1, 0)] if num_qubits > 2 else []
        return pairs + [(i, i + 1) for i in range(num_qubits - 1)]
    if entanglement == "full":
        return list(itertools.combinations(range(num_qubits), 2))
    raise ValueError(f"unknown entanglement {entanglement!r}")


def TwoLocal(num_qubits: int,
             rotation_blocks="ry",
             entanglement_blocks="cx",
             entanglement: str = "full",
             reps: int = 3,
             skip_final_rotation_layer: bool = False) -> QuantumCircuit:
    """Layered rotation + entanglement circuit (cf. qiskit TwoLocal)."""
    if isinstance(rotation_blocks, str):
        rotation_blocks = [rotation_blocks]
    qc = QuantumCircuit(num_qubits)

    def rotation_layer():
        for name in rotation_blocks:
            for q in range(num_qubits):
                getattr(qc, name)(qc.parameter(), q)

    pairs = _entangler_pairs(num_qubits, entanglement)
    for _ in range(reps):
        rotation_layer()
        for (a, b) in pairs:
            getattr(qc, entanglement_blocks)(a, b)
    if not skip_final_rotation_layer:
        rotation_layer()
    # rotation angles are 2*pi-periodic (qiskit TwoLocal exposes the same)
    qc.parameter_bounds = [(-2 * math.pi, 2 * math.pi)] * qc.num_parameters
    return qc


def RealAmplitudes(num_qubits: int, reps: int = 3,
                   entanglement: str = "reverse_linear") -> QuantumCircuit:
    return TwoLocal(num_qubits, "ry", "cx", entanglement, reps)


def EfficientSU2(num_qubits: int, reps: int = 3,
                 entanglement: str = "reverse_linear") -> QuantumCircuit:
    return TwoLocal(num_qubits, ["ry", "rz"], "cx", entanglement, reps)
