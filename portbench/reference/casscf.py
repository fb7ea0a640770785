"""The check of a CASSCF request: FusedOptOrbCASSCF's energy, partial
unitary, CI vector and 1-RDM against the plain reference.

Numbers (each the worst over the requests checked):
  energy_gap_ha  |E - v^T H(U) v / v^T v|, the reported energy against the
                 returned vector's energy in the integrals rotated at the
                 returned U (the transform, the sector Hamiltonian, sigma);
  residual_ha    ||H(U) v - E_ref v|| / ||v||: the vector is an eigenvector
                 (the eigensolver finished);
  rdm_gap        max |gamma - gamma_ref| of the returned spin-summed 1-RDM;
  ortho_gap      max |U^T U - 1|;
  orbital_grad_ratio  the vector's orbital gradient at the returned U over
                 the one at the request's start U0 (orbitals.py): the
                 orbital step moved U towards its optimum (1 where it
                 left U at its start);
  orbital_grad   the orbital gradient at U itself.
"""

from __future__ import annotations

import torch

from . import orbitals
from .sector import Sector


class Check:
    def __init__(self, inputs: dict, n_active: int, device):
        na, nb = inputs["num_particles"]
        self.device = torch.device(device)
        self.h = torch.as_tensor(inputs["h"], device=self.device)
        self.eri = torch.as_tensor(inputs["eri"], device=self.device)
        self.sector = Sector(n_active, na, nb, self.device)

    def readings(self, out: dict, start) -> dict:
        f64 = dict(dtype=torch.float64, device=self.device)
        sec = self.sector
        U = torch.as_tensor(out["U"], **f64)
        v = torch.as_tensor(out["ci"], **f64).reshape(sec.nB, sec.nA)
        v = v / torch.linalg.vector_norm(v)
        h1, g = orbitals.rotate(self.h, self.eri, U)
        s = sec.sigma(v, h1, g)
        E = float((v * s).sum())
        residual = float(torch.linalg.vector_norm(s - E * v))
        del s
        gamma, P = sec.rdm12(v)
        grad, ratio = orbitals.gradient_ratio(
            self.h, self.eri, U, torch.as_tensor(start, **f64), gamma, P)
        eye = torch.eye(U.shape[1], **f64)
        return {
            "energy_gap_ha": abs(float(out["energy"]) - E),
            "residual_ha": residual,
            "rdm_gap": float((torch.as_tensor(out["one_rdm"], **f64)
                              - gamma).abs().max()),
            "ortho_gap": float((U.T @ U - eye).abs().max()),
            "orbital_grad_ratio": ratio,
            "orbital_grad": grad,
        }
