"""Energy / gradient evaluators shared by the eigensolvers.

Port of esoo_tpu/solvers/energy.py.  The hot path is theta -> state ->
energy on the eigensolver's device, differentiated by autograd, with the
Hamiltonian's (h, g) as runtime tensors so that an outer-loop rebuild
(new rotated integrals every iteration) reuses the compiled circuit and
the sector tables: the circuit structure is the only cached key, together
with the dtype and the device.

Three routes, as in the JAX package:
  * sector:     a UCC-family circuit over an occupation-basis initial state
                runs in its particle-number sector (sim/sector.py, string
                kernels); the sector Hamiltonian's sigma operators are
                built once per operator;
  * fermionic:  any other Jordan-Wigner circuit: the full statevector and
                the direct RDM contraction (sim/rdm.py::rdm_energy);
  * pauli:      operators without (h, g) (or non-JW circuits): the Pauli
                sum on the statevector, each term's parity by XOR folds
                (PyTorch has no population_count), tables built once per
                call on the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.pauli import SparsePauliOp
from ..orbital_optimization.stiefel import value_and_grad
from ..sim.circuit import QuantumCircuit
from ..sim.rdm import rdm_energy
from ..sim.statevector import CompiledCircuit, _parity, compile_circuit
from ..utils.config import real_dtype, same_device

_FERMI_CACHE: Dict[tuple, tuple] = {}
_SECTOR_CACHE: Dict[tuple, object] = {}


def _sector_for(circuit: QuantumCircuit):
    """SectorUCC for a UCC-family circuit with its own occupation-basis
    initial state, or None when the circuit is not sector-eligible (or
    its sector does not factorize over strings, the one kernel ported).
    Cached on the circuit fingerprint; the SectorUCC keeps its device
    tables per dtype and device."""
    key = circuit.fingerprint()
    if key in _SECTOR_CACHE:
        return _SECTOR_CACHE[key]
    sec = None
    try:
        from ..sim.sector import SectorUCC
        sec = SectorUCC(circuit, circuit.num_qubits)
        if sec.init_index is None:
            sec = None
    except (ValueError, AssertionError):
        sec = None
    _SECTOR_CACHE[key] = sec
    return sec


def _sector_fns(sec) -> tuple:
    """(build_values, energy, value_and_grad) of a SectorUCC, made once."""
    fns = getattr(sec, "_class_fns", None)
    if fns is None:
        fns = sec._class_fns = (sec.build_values, sec.energy_values,
                                value_and_grad(sec.energy_values))
    return fns


def operator_tensors(operator, dtype: torch.dtype, device) -> tuple:
    """The operator's spin-orbital (h, g) as tensors of `dtype` on
    `device`: the rotated tensors an OptOrb solver attached
    (`_fermionic_tensors`) when they already sit there, else its host
    `.fermionic` pair uploaded."""
    cached = getattr(operator, "_fermionic_tensors", None)
    if cached is not None and cached[0].dtype == dtype and \
            same_device(cached[0].device, device):
        return cached
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.float64),
                                 device=device).to(dtype)
                 for a in operator.fermionic)


def fermionic_evaluators(compiled: CompiledCircuit, fingerprint,
                         dtype: torch.dtype, device) -> tuple:
    """(energy, value_and_grad) functions of (theta, h, g) on the full
    statevector, cached on (fingerprint, realness, dtype, device)."""
    key = (fingerprint, compiled.is_real, dtype, str(torch.device(device)))
    hit = _FERMI_CACHE.get(key)
    if hit is not None:
        return hit
    state_fn = compiled.state_fn

    def energy(theta, h, g):
        return rdm_energy(state_fn(theta), h, g)

    _FERMI_CACHE[key] = (energy, value_and_grad(energy))
    return _FERMI_CACHE[key]


def pauli_tables(op: SparsePauliOp, dim: int, real: bool, device) -> tuple:
    """(perm, sign, weights) of a Pauli sum on `dim` amplitudes:
    perm[k, c] = c ^ x_k, sign[k, c] = (-1)^popcount((c ^ x_k) & z_k),
    weights = coeff_k * i^y_k.  For a real state only the even-Y strings
    contribute and the weights are real."""
    xs, zs, ys, coeffs = op.mask_arrays()
    phases = np.power(1j, ys % 4)
    if real:
        keep = ys % 2 == 0
        xs, zs = xs[keep], zs[keep]
        w = torch.as_tensor(np.real(coeffs[keep] * phases[keep]),
                            device=device)
    else:
        w = torch.as_tensor(coeffs * phases, device=device)
    idx = torch.arange(dim, device=device)
    xs_t = torch.as_tensor(np.asarray(xs, dtype=np.int64), device=device)
    zs_t = torch.as_tensor(np.asarray(zs, dtype=np.int64), device=device)
    perm = idx[None, :] ^ xs_t[:, None]
    sign = 1 - 2 * _parity(perm & zs_t[:, None], dim.bit_length())
    return perm, sign, w


def pauli_expectation(s: torch.Tensor, tables: tuple) -> torch.Tensor:
    """<s| sum_k w_k P_k |s> (real part) from pauli_tables; leading batch
    axes on s give one value per state."""
    perm, sign, w = tables
    if s.is_complex():
        q = torch.sum(torch.conj(s)[..., None, :] * sign.to(s.real.dtype)
                      * s[..., perm], dim=-1)
        return torch.real(q @ w.to(s.dtype))
    q = torch.sum(s[..., None, :] * sign.to(s.dtype) * s[..., perm], dim=-1)
    return q @ w.to(s.dtype)


def pauli_evaluators(compiled: CompiledCircuit, op: SparsePauliOp,
                     device) -> tuple:
    """(energy, value_and_grad) functions of theta for a fixed Hermitian
    Pauli sum."""
    tables = pauli_tables(op, 1 << compiled.num_qubits, compiled.is_real,
                          device)
    state_fn = compiled.state_fn

    def energy(theta):
        return pauli_expectation(state_fn(theta), tables)

    return energy, value_and_grad(energy)


def _theta(theta, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(theta, dtype=np.float64),
                           device=device).to(real_dtype())


def make_evaluators(circuit: QuantumCircuit, operator: SparsePauliOp,
                    device):
    """Host-facing (energy_fn(theta) -> float, vag_fn(theta) -> (float,
    grad ndarray)) evaluated on `device`: the sector route for a
    sector-eligible circuit under a chemistry operator, the full
    statevector with the RDM contraction for other JW circuits, else the
    Pauli sum."""
    compiled = compile_circuit(circuit)
    device = torch.device(device)
    dtype = real_dtype()
    # the fermionic fast path contracts RDMs from occupation-basis
    # amplitudes, which only the Jordan-Wigner encoding preserves;
    # parity/BK-encoded circuits take the per-Pauli path (the operator's
    # Pauli terms already carry the right encoding)
    occupation_basis = getattr(circuit, "_encoding", "jw") == "jw"
    if getattr(operator, "fermionic", None) is not None and occupation_basis:
        h, g = operator_tensors(operator, dtype, device)
        sec = _sector_for(circuit)
        if sec is not None:
            # the dense sector operators are built once per operator (once
            # per OptOrb outer iteration); every optimizer iterate is the
            # gate scan plus one sigma in the sector
            build, e_s, vag_s = _sector_fns(sec)
            vals = build(h, g)
            e_fn = (lambda th: e_s(th, vals))
            vag_fn = (lambda th: vag_s(th, vals))
        else:
            e_f, vag_f = fermionic_evaluators(compiled,
                                              circuit.fingerprint(), dtype,
                                              device)
            e_fn = (lambda th: e_f(th, h, g))
            vag_fn = (lambda th: vag_f(th, h, g))
    else:
        e_fn, vag_fn = pauli_evaluators(compiled, operator, device)

    def energy(theta):
        with torch.no_grad():
            return float(e_fn(_theta(theta, device)))

    def vag(theta):
        v, gr = vag_fn(_theta(theta, device))
        return float(v), gr.detach().cpu().numpy()

    return energy, vag
