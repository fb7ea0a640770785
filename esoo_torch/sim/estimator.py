"""Estimator / Sampler / fidelity primitives backed by the statevector
simulator.

Port of esoo_tpu/sim/estimator.py: the API surface of the qiskit
primitives the reference consumes:
  - Estimator.run(circuits, observables, parameter_values) -> job.result().values
    (reference usage: ssvqe.py:356-360, opt_orb_minimum_eigensolver.py:187-202)
  - ComputeUncompute(sampler).run(circs1, circs2, vals1, vals2)
    -> job.result().fidelities    (vqd.py:405-411)

Exact expectation values; a `shots` option adds Gaussian sampling noise,
drawn from a torch.Generator seeded by `seed`.  Each primitive takes
`device` ("cuda" by default; "cpu" runs on the host).

Observables carrying a `.fermionic = (h, g)` tag (produced by
ActiveSpaceHamiltonianBuilder) are evaluated through the direct RDM
contraction path (sim/rdm.py) instead of per-Pauli reduction.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..ops.pauli import SparsePauliOp
from ..utils.config import resolve_device
from .circuit import QuantumCircuit
from .rdm import rdm_energy
from .statevector import compile_circuit, expectation_pauli


@dataclasses.dataclass
class EstimatorResult:
    values: np.ndarray
    metadata: List[dict]


@dataclasses.dataclass
class SamplerResult:
    quasi_dists: List[dict]
    metadata: List[dict]


class _Job:
    def __init__(self, result):
        self._result = result

    def result(self):
        return self._result


def _state(circuit: QuantumCircuit, params, device) -> torch.Tensor:
    """The circuit's statevector at `params` (None: zeros) on `device`."""
    return compile_circuit(circuit).state(
        None if params is None else np.asarray(params, dtype=np.float64),
        device=device)


def _expectation(circuit: QuantumCircuit, observable: SparsePauliOp,
                 params, device) -> complex:
    state = _state(circuit, params, device)
    if getattr(observable, "fermionic", None) is not None:
        h, g = (torch.as_tensor(np.asarray(a, dtype=np.float64),
                                device=device) for a in observable.fermionic)
        return complex(rdm_energy(state, h, g))
    xs, zs, ys, coeffs = observable.mask_arrays()
    return complex(expectation_pauli(state, xs, zs, ys, coeffs))


def _variance(circuit: QuantumCircuit, observable: SparsePauliOp,
              params, mean: float, device) -> float:
    """<H^2> - <H>^2 via |phi> = H|psi> (per-term Pauli action, host)."""
    from .strings import _bitcount
    state = _state(circuit, params, device).cpu().numpy().astype(complex)
    if getattr(observable, "fermionic", None) is not None:
        from ..ops.hamiltonian import ActiveSpaceHamiltonianBuilder
        # materialize the Pauli form once for variance purposes
        h, g = observable.fermionic
        observable = ActiveSpaceHamiltonianBuilder(
            observable.num_qubits).build(h, g)
    xs, zs, ys, coeffs = observable.mask_arrays()
    idx = np.arange(state.shape[0])
    phi = np.zeros_like(state)
    for x, z, y, cf in zip(xs, zs, ys, coeffs):
        perm = idx ^ x
        sign = 1.0 - 2.0 * (_bitcount(np.bitwise_and(perm, z)) & 1)
        phi += cf * ((1j) ** (y % 4)) * sign * state[perm]
    return float(np.real(np.vdot(phi, phi)) - mean * mean)


class Estimator:
    """Exact-statevector expectation-value primitive.

    Accepts and ignores Aer-style kwargs (approximation=..., etc.) so that
    reference scripts run unchanged.  Shot noise is drawn on the host from
    a torch.Generator seeded by `seed`.
    """

    def __init__(self, approximation: bool = True, shots: Optional[int] = None,
                 seed: Optional[int] = None, device="cuda", **_ignored):
        self.shots = shots
        self.device = resolve_device(device)
        self._gen = torch.Generator()
        if seed is None:
            self._gen.seed()
        else:
            self._gen.manual_seed(int(seed))

    def run(self, circuits, observables, parameter_values=None, **_ignored):
        if isinstance(circuits, QuantumCircuit):
            circuits = [circuits]
        if isinstance(observables, SparsePauliOp):
            observables = [observables]
        n = max(len(circuits), len(observables))
        if len(circuits) == 1:
            circuits = list(circuits) * n
        if len(observables) == 1:
            observables = list(observables) * n
        if len(circuits) != len(observables):
            raise ValueError(
                f"cannot broadcast {len(circuits)} circuits against "
                f"{len(observables)} observables")
        if parameter_values is None:
            parameter_values = [None] * n
        elif len(parameter_values) and not isinstance(
                parameter_values[0], (list, tuple, np.ndarray, torch.Tensor)):
            # a single flat parameter set
            parameter_values = [parameter_values] * n
        values = np.empty(n, dtype=np.float64)
        meta: List[dict] = []
        for i, (c, o, p) in enumerate(zip(circuits, observables, parameter_values)):
            v = _expectation(c, o, p, self.device).real
            variance = 0.0
            if self.shots is not None:
                # exact shot noise: var(H) = <H^2> - <H>^2 from the
                # statevector, sampled as Gaussian of width sqrt(var/shots)
                variance = max(0.0, _variance(c, o, p, v, self.device))
                noise = torch.randn((), dtype=torch.float64,
                                    generator=self._gen)
                v = v + float(noise) * np.sqrt(variance / self.shots)
            values[i] = v
            meta.append({"shots": self.shots, "variance": variance})
        return _Job(EstimatorResult(values=values, metadata=meta))


class Sampler:
    """Exact quasi-probability sampler (API parity for ComputeUncompute)."""

    def __init__(self, shots: Optional[int] = None, seed: Optional[int] = None,
                 device="cuda", **_ignored):
        self.shots = shots
        self.device = resolve_device(device)

    def run(self, circuits, parameter_values=None, **_ignored):
        if isinstance(circuits, QuantumCircuit):
            circuits = [circuits]
        if parameter_values is None:
            parameter_values = [None] * len(circuits)
        dists, meta = [], []
        for c, p in zip(circuits, parameter_values):
            probs = np.abs(_state(c, p, self.device).cpu().numpy()) ** 2
            dists.append({i: float(pr) for i, pr in enumerate(probs) if pr > 1e-16})
            meta.append({"shots": self.shots})
        return _Job(SamplerResult(quasi_dists=dists, metadata=meta))


@dataclasses.dataclass
class FidelityResult:
    fidelities: np.ndarray
    metadata: List[dict]


class ComputeUncompute:
    """State fidelity |<psi_1|psi_2>|^2 computed directly from statevectors."""

    def __init__(self, sampler: Optional[Sampler] = None, device=None,
                 **_ignored):
        self.sampler = sampler
        # the sampler's device unless one is given ("cuda" without either)
        self.device = resolve_device(
            device if device is not None
            else getattr(sampler, "device", "cuda"))

    def run(self, circuits_1, circuits_2, values_1=None, values_2=None,
            **_ignored):
        if isinstance(circuits_1, QuantumCircuit):
            circuits_1 = [circuits_1]
        if isinstance(circuits_2, QuantumCircuit):
            circuits_2 = [circuits_2]
        n = max(len(circuits_1), len(circuits_2))
        if len(circuits_1) == 1:
            circuits_1 = list(circuits_1) * n
        if len(circuits_2) == 1:
            circuits_2 = list(circuits_2) * n
        if len(circuits_1) != len(circuits_2):
            raise ValueError(
                f"cannot broadcast {len(circuits_1)} against "
                f"{len(circuits_2)} circuits")
        if values_1 is None:
            values_1 = [None] * n
        if values_2 is None:
            values_2 = [None] * n
        fids = np.empty(n)
        for i, (c1, c2, v1, v2) in enumerate(
                zip(circuits_1, circuits_2, values_1, values_2)):
            s1 = _state(c1, v1, self.device)
            s2 = _state(c2, v2, self.device)
            fids[i] = float(torch.abs(torch.vdot(
                s1.to(torch.complex128), s2.to(torch.complex128))) ** 2)
        return _Job(FidelityResult(fidelities=fids, metadata=[{}] * n))
