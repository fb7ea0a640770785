"""The client: issues a request through the port's public API.

A traffic mix names the solver class of `esoo_torch`, its options, the
ansatz (a class of `esoo_torch` and its initial state) where the solver
takes one, the entry point, and which fields of the result the reference
reads.  A request constructs a new solver from the configuration's
problem and the request's start, runs the entry point to its stopping
rule, and copies what the check reads to the host, under three spans:
request.construct, request.solve and request.fetch.
"""

from __future__ import annotations

import time

import numpy as np


def problem(inputs: dict):
    """The configuration's problem as bare MO integral tensors
    (esoo_torch.chem.ElectronicStructureProblem)."""
    from esoo_torch.chem import ElectronicStructureProblem
    return ElectronicStructureProblem(
        num_particles=tuple(inputs["num_particles"]),
        num_spatial_orbitals=inputs["h"].shape[0],
        nuclear_repulsion_energy=inputs["nuclear_repulsion"],
        hcore_mo=inputs["h"], eri_mo=inputs["eri"])


def _ansatz(T, spec: dict, n: int, particles):
    make = getattr(T, spec["name"])
    init = spec.get("initial_state")
    kw = {}
    if init is not None:
        kw["initial_state"] = getattr(T, init)(n, particles)
    return make(n, particles, **kw)


class Client:
    """Issues the requests of one traffic mix on `device` at `dtype`."""

    def __init__(self, T, torch, prob, traffic: dict, dtype, device):
        self.torch = torch
        self.problem, self.traffic = prob, traffic
        self.dtype, self.device = dtype, device
        self.cls = getattr(T, traffic["solver"])
        self.n_spin = traffic["active_spin_orbitals"]
        self.ansatz = None
        if traffic.get("ansatz"):
            self.ansatz = _ansatz(T, traffic["ansatz"], self.n_spin // 2,
                                  tuple(prob.num_particles))

    def _sync(self):
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def issue(self, req: dict, spans: list) -> dict:
        """Run one request; returns {"outputs", "start" (the request's U0,
        which the check reads beside the outputs), "outer_iterations",
        "stage_stats"}.  `spans` gets (name, start_ns, end_ns) on the
        host's wall clock (the profiler's time base)."""
        tr = self.traffic
        kw = dict(tr.get("options", {}))
        if self.ansatz is not None:
            kw["ansatz"] = self.ansatz
            if tr.get("initial_point") == "zeros":
                kw["initial_point"] = np.zeros(self.ansatz.num_parameters)
        t0 = time.time_ns()
        solver = self.cls(num_spin_orbitals=self.n_spin,
                          problem=self.problem,
                          initial_partial_unitary=req["U0"],
                          dtype=self.dtype, device=self.device, **kw)
        self._sync()
        t1 = time.time_ns()
        result = getattr(solver, tr["entry"])()
        t2 = time.time_ns()
        del solver
        self._sync()
        outputs = {k: np.array(getattr(result, attr))
                   for k, attr in tr["outputs"].items()}
        stats = {k: v for k, v in (result.stage_stats or {}).items()
                 if isinstance(v, (int, float))}
        t3 = time.time_ns()
        spans += [("request.construct", t0, t1), ("request.solve", t1, t2),
                  ("request.fetch", t2, t3)]
        return {"outputs": outputs, "start": req["U0"],
                "outer_iterations": int(result.outer_iterations),
                "stage_stats": stats}
