"""The check of a UCCSD-VQE request: FusedOptOrbVQE's energy, partial
unitary, parameters and 1-RDM against the plain reference.

Numbers (each the worst over the requests checked):
  energy_gap_ha  |E - <psi(theta)| H(U) |psi(theta)>|, the reported energy
                 against the UCCSD state's energy in the integrals rotated
                 at the returned U (covers the transform, the sector
                 Hamiltonian, the state and the energy);
  rdm_gap        max |gamma - gamma_ref| of the returned spin-summed 1-RDM;
  optimum_gap_ha |E - min over theta' of E(theta')| at U, the minimum
                 found by L-BFGS at float64 from the returned theta: the
                 reported energy is the ansatz's optimum at U (the
                 eigensolver finished, and its energy is right);
  theta_grad     max |dE/dtheta_k| at the returned theta;
  theta_excess_ha  E(theta) - min E(theta') (second order in the gradient);
  ortho_gap      max |U^T U - 1|;
  orbital_grad_ratio  the state's orbital gradient at the returned U over
                 the one at the request's start U0 (orbitals.py): the
                 orbital step moved U towards its optimum (1 where it
                 left U at its start);
  orbital_grad   the orbital gradient at U itself.
"""

from __future__ import annotations

import torch

from . import orbitals, ucc
from .sector import Sector


class Check:
    def __init__(self, inputs: dict, n_active: int, device):
        na, nb = inputs["num_particles"]
        self.device = torch.device(device)
        self.h = torch.as_tensor(inputs["h"], device=self.device)
        self.eri = torch.as_tensor(inputs["eri"], device=self.device)
        self.sector = Sector(n_active, na, nb, self.device)
        self.G = ucc.generators(self.sector)

    def _energy(self, theta, h1, g):
        psi = ucc.state(self.sector, self.G, theta)
        return (psi * self.sector.sigma(psi, h1, g)).sum(), psi

    def _minimum(self, theta0, h1, g) -> float:
        """min_theta E(theta) at float64, from theta0."""
        theta = theta0.clone().requires_grad_(True)
        opt = torch.optim.LBFGS([theta], lr=1, max_iter=500,
                                tolerance_grad=1e-12,
                                tolerance_change=1e-15,
                                history_size=50,
                                line_search_fn="strong_wolfe")

        def closure():
            opt.zero_grad()
            E, _ = self._energy(theta, h1, g)
            E.backward()
            return E

        with torch.enable_grad():
            opt.step(closure)
        with torch.no_grad():
            return float(self._energy(theta, h1, g)[0])

    def readings(self, out: dict, start) -> dict:
        f64 = dict(dtype=torch.float64, device=self.device)
        U = torch.as_tensor(out["U"], **f64)
        theta = torch.as_tensor(out["theta"], **f64)
        h1, g = orbitals.rotate(self.h, self.eri, U)
        theta = theta.clone().requires_grad_(True)
        with torch.enable_grad():
            E, psi = self._energy(theta, h1, g)
            (dtheta,) = torch.autograd.grad(E, theta)
        psi = psi.detach()
        e_min = self._minimum(theta.detach(), h1, g)
        excess = float(E.detach()) - e_min
        gamma, P = self.sector.rdm12(psi)
        grad, ratio = orbitals.gradient_ratio(
            self.h, self.eri, U, torch.as_tensor(start, **f64), gamma, P)
        eye = torch.eye(U.shape[1], **f64)
        return {
            "energy_gap_ha": abs(float(out["energy"]) - float(E.detach())),
            "rdm_gap": float((torch.as_tensor(out["one_rdm"], **f64)
                              - gamma).abs().max()),
            "optimum_gap_ha": abs(float(out["energy"]) - e_min),
            "theta_grad": float(dtheta.abs().max()),
            "theta_excess_ha": excess,
            "ortho_gap": float((U.T @ U - eye).abs().max()),
            "orbital_grad_ratio": ratio,
            "orbital_grad": grad,
        }
