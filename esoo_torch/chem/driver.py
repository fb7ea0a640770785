"""Molecular problem driver: geometry + basis -> MO-basis integral tensors.

The part of esoo_tpu/chem/driver.py that FusedOptOrbVQE consumes:
`MoleculeDriver(atom=..., basis=...).run()` builds the AO integrals
(chem/integrals.py, native C++ ERI when g++ can build it), runs RHF (ROHF
for spin > 0) and emits an `ElectronicStructureProblem` whose
`spatial_integral_tensors()` are the framework's convention:

  E = sum_pq h[p,q] <a+_p a_q> + sum_pqrs g[p,q,r,s] <a+_p a+_q a_s a_r>

with g[p,q,r,s] = 1/2 <pq|rs> (physicist notation).  Spin-orbital
ordering is block: alpha spatial orbitals 0..n-1, then beta n..2n-1.
Dipoles, AO metadata and active-space reductions are still to be ported
(ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

import numpy as np

from .basis import ATOMIC_NUMBERS, build_shells
from .integrals import IntegralEngine
from .scf import SCFResult, rhf, rohf


@dataclasses.dataclass
class ElectronicStructureProblem:
    """Container for the electronic-structure problem in the MO basis."""

    num_particles: Tuple[int, int]          # (n_alpha, n_beta)
    num_spatial_orbitals: int
    nuclear_repulsion_energy: float
    hcore_mo: np.ndarray                    # (n, n) spatial MO one-body
    eri_mo: np.ndarray                      # (n, n, n, n) chemist (pq|rs) MO
    scf: Optional[SCFResult] = None
    atom: str = ""
    basis: str = ""
    eri_engine: str = ""                    # "native" or "python"

    @property
    def num_spin_orbitals(self) -> int:
        return 2 * self.num_spatial_orbitals

    def one_body_tensor(self) -> np.ndarray:
        """Spin-orbital one-body tensor h[p,q] (block spin ordering)."""
        n = self.num_spatial_orbitals
        h = np.zeros((2 * n, 2 * n))
        h[:n, :n] = self.hcore_mo
        h[n:, n:] = self.hcore_mo
        return h

    def two_body_tensor(self) -> np.ndarray:
        """Spin-orbital two-body tensor g[p,q,r,s] = 1/2 <pq|rs>, with
        <pq|rs> = (pr|qs) delta(sigma_p,sigma_r) delta(sigma_q,sigma_s)."""
        n = self.num_spatial_orbitals
        g = np.zeros((2 * n,) * 4)
        phys = self.eri_mo.transpose(0, 2, 1, 3)  # phys[p,q,r,s] = (pr|qs)
        for sp in (0, 1):          # spin of p (= spin of r)
            for sq in (0, 1):      # spin of q (= spin of s)
                sl_p = slice(sp * n, sp * n + n)
                sl_q = slice(sq * n, sq * n + n)
                g[sl_p, sl_q, sl_p, sl_q] += 0.5 * phys
        return g

    def integral_tensors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(one_body, two_body) spin-orbital tensors."""
        return self.one_body_tensor(), self.two_body_tensor()

    def spatial_integral_tensors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(h_sp, g_sp) SPATIAL tensors (h_sp = MO core Hamiltonian;
        g_sp = 1/2 <pq|rs> physicist), without materializing the 16x
        larger spin-orbital intermediate."""
        phys = self.eri_mo.transpose(0, 2, 1, 3)
        return self.hcore_mo.copy(), 0.5 * phys


class MoleculeDriver:
    """Compute integrals + RHF for a molecule and emit the problem object.

    Example:
        problem = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735",
                                 basis="6-31g").run()
    """

    def __init__(self, atom: str, basis: str = "sto-3g", charge: int = 0,
                 spin: int = 0, custom_basis: Optional[dict] = None):
        """spin: 2S = n_alpha - n_beta; 0 runs RHF, > 0 ROHF (one set of
        spatial orbitals shared by both spins)."""
        if spin < 0:
            raise ValueError("spin (= n_alpha - n_beta) must be >= 0")
        self.atom = atom
        self.basis = basis
        self.charge = charge
        self.spin = spin
        self.custom_basis = custom_basis

    def run(self) -> ElectronicStructureProblem:
        shells, symbols, coords = build_shells(
            self.atom, self.basis, self.custom_basis)
        charges = np.array([ATOMIC_NUMBERS[s] for s in symbols],
                           dtype=np.float64)
        n_electrons = int(charges.sum()) - self.charge
        if (n_electrons - self.spin) % 2:
            raise ValueError(
                f"{n_electrons} electrons cannot have spin (2S) = {self.spin}")
        n_a = (n_electrons + self.spin) // 2
        n_b = n_electrons - n_a

        engine = IntegralEngine(shells, charges, coords)
        S, T, V = engine.one_electron()
        eri = engine.eri()
        print(f"esoo_torch.chem: {self.atom!r} {self.basis}: "
              f"{engine.nbf} basis functions, ERI engine "
              f"{engine.eri_engine}", file=sys.stderr, flush=True)
        hcore = T + V

        if self.spin == 0:
            scf = rhf(S, hcore, eri, n_electrons, charges, coords)
        else:
            scf = rohf(S, hcore, eri, n_a, n_b, charges, coords)

        C = scf.mo_coeff
        h_mo = C.T @ hcore @ C
        # AO->MO quarter transforms, chemist order (pq|rs)
        tmp = np.einsum("pqrs,pi->iqrs", eri, C, optimize=True)
        tmp = np.einsum("iqrs,qj->ijrs", tmp, C, optimize=True)
        tmp = np.einsum("ijrs,rk->ijks", tmp, C, optimize=True)
        eri_mo = np.einsum("ijks,sl->ijkl", tmp, C, optimize=True)
        return ElectronicStructureProblem(
            num_particles=(n_a, n_b),
            num_spatial_orbitals=C.shape[1],
            nuclear_repulsion_energy=scf.nuclear_repulsion,
            hcore_mo=h_mo,
            eri_mo=eri_mo,
            scf=scf,
            atom=self.atom,
            basis=self.basis,
            eri_engine=engine.eri_engine,
        )
