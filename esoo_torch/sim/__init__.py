"""Simulation: the full-space 2^N statevector simulator (circuits,
statevector, direct RDMs, Estimator), the particle-number-sector
simulation of UCC ansaetze, and the gate-free sector of exact CASSCF."""

from .ansatz import (UCC, UCCSD, EfficientSU2, HartreeFock, OccupationState,
                     RealAmplitudes, TwoLocal, generate_excitations,
                     hartree_fock_bitmask)
from .circuit import Parameter, ParamExpr, QuantumCircuit
from .estimator import ComputeUncompute, Estimator, Sampler
from .rdm import one_rdm, rdm_energy, two_rdm
from .sector import SectorCI, SectorUCC
from .statevector import CompiledCircuit, compile_circuit, statevector

__all__ = [
    "UCC", "UCCSD", "EfficientSU2", "HartreeFock", "OccupationState",
    "RealAmplitudes", "TwoLocal", "generate_excitations",
    "hartree_fock_bitmask",
    "Parameter", "ParamExpr", "QuantumCircuit",
    "ComputeUncompute", "Estimator", "Sampler",
    "one_rdm", "rdm_energy", "two_rdm",
    "SectorCI", "SectorUCC",
    "CompiledCircuit", "compile_circuit", "statevector",
]
