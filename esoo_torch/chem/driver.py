"""Molecular problem driver: geometry + basis -> MO-basis integral tensors.

Copy of esoo_tpu/chem/driver.py: `MoleculeDriver(atom=..., basis=...)
.run()` builds the AO integrals (chem/integrals.py, native C++ ERI when
g++ can build it), runs RHF (ROHF for spin > 0) and emits an `ElectronicStructureProblem` whose
`spatial_integral_tensors()` are the framework's convention:

  E = sum_pq h[p,q] <a+_p a_q> + sum_pqrs g[p,q,r,s] <a+_p a+_q a_s a_r>

with g[p,q,r,s] = 1/2 <pq|rs> (physicist notation).  Spin-orbital
ordering is block: alpha spatial orbitals 0..n-1, then beta n..2n-1.
The problem also carries the MO-basis dipole and second-moment
matrices and the AO metadata (`AOBasisInfo`) that chem/properties.py,
chem/localize.py and chem/cube.py read, and `active_space()` folds a
frozen core into `core_energy` and an effective one-body operator.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

import numpy as np

from .basis import ATOMIC_NUMBERS, build_shells
from .integrals import IntegralEngine
from .scf import SCFResult, rhf, rohf

# chemical-core spatial-orbital counts by atomic number (frozen-core
# convention: 1s for Li-Ne; 1s2s2p for Na-Ar)
_CORE_ORBITALS = {z: (0 if z <= 2 else 1 if z <= 10 else 5)
                  for z in range(1, 19)}


@dataclasses.dataclass
class AOBasisInfo:
    """Atomic-orbital-level metadata for population analysis and AO-basis
    property evaluation (the `mol` object role PySCF plays for the
    reference; the reference itself never inspects AO structure).
    Immutable under active-space reductions — the AO basis never
    changes, only the MO window does."""

    overlap: np.ndarray          # (nbf, nbf) AO overlap matrix
    ao_atoms: np.ndarray         # (nbf,) owning-atom index of each AO
    symbols: list                # (natom,) element symbols
    atomic_numbers: np.ndarray   # (natom,)
    coords: np.ndarray           # (natom, 3) in bohr
    shells: Optional[list] = None  # the Shell objects (AO order) — for
    # real-space evaluation (chem.cube); None for bare-tensor problems


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
    core_energy: float = 0.0      # frozen-core mean-field energy (active-
    # space problems: total electronic = solver energy + core_energy)
    # dipole-operator ⟨p|r_d|q⟩ matrices in the MO basis, (3, n, n), and
    # the nuclear dipole Σ_A Z_A R_A (origin at 0).  Populated by
    # MoleculeDriver (the PySCF `int1e_r` role); None for problems built
    # from bare integral tensors.  dipole_core accumulates the frozen-
    # core electronic ⟨r⟩ under active_space reductions.
    dipole_mo: Optional[np.ndarray] = None
    nuclear_dipole: Optional[np.ndarray] = None
    dipole_core: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    # second-moment ⟨p|(r_a r_b)|q⟩ matrices in the MO basis, (6, n, n)
    # in IntegralEngine.QUAD_COMPS order (xx, xy, xz, yy, yz, zz), with
    # the frozen-core accumulation — same lifecycle as dipole_mo
    quadrupole_mo: Optional[np.ndarray] = None
    quadrupole_core: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(6))
    # AO-level metadata for population analysis (chem.properties
    # mulliken/lowdin): the AO basis itself (shared, never reduced),
    # the AO coefficients of the problem's CURRENT MO window
    # (nbf, num_spatial_orbitals), and the accumulated frozen-core AO
    # density 2 Σ_core c_i c_iᵀ from active_space reductions.
    ao_basis: Optional[AOBasisInfo] = None
    mo_coeff_ao: Optional[np.ndarray] = None
    density_core_ao: Optional[np.ndarray] = None
    eri_engine: str = ""          # "native" or "python"

    @property
    def num_spin_orbitals(self) -> int:
        return 2 * self.num_spatial_orbitals

    def active_space(self, n_frozen: Optional[int] = None,
                     n_active_orbitals: Optional[int] = None
                     ) -> "ElectronicStructureProblem":
        """Frozen-core / active-space reduction (the qiskit-nature
        ActiveSpaceTransformer role the reference relies on for heavy
        atoms; cf. reference base_opt_orb_solver.py:87-91 consuming the
        transformed problem).

        The lowest `n_frozen` (doubly occupied) MOs are folded into an
        effective one-body operator and a scalar `core_energy`:

            E_core    = 2 sum_i h_ii + sum_ij [2(ii|jj) - (ij|ji)]
            h_eff[pq] = h[pq] + sum_i [2(pq|ii) - (pi|iq)]

        (chemist-notation (pq|rs) integrals, i/j over frozen MOs).  With
        `n_active_orbitals`, high virtuals beyond the window are dropped
        too.  `n_frozen=None` freezes the standard chemical core per atom
        (He: 0 / first row: 1 / second row: 5).

        Solver energies on the returned problem are ACTIVE-space
        electronic energies; the physical total is
        ``result + problem.core_energy + problem.nuclear_repulsion_energy``.
        """
        if n_frozen is None:
            from .basis import element_symbol, is_ghost, parse_geometry
            symbols, _ = parse_geometry(self.atom)
            n_frozen = sum(
                _CORE_ORBITALS[ATOMIC_NUMBERS[element_symbol(s)]]
                for s in symbols if not is_ghost(s))
        na, nb = self.num_particles
        if n_frozen > min(na, nb):
            raise ValueError(
                f"cannot freeze {n_frozen} orbitals with only "
                f"({na}, {nb}) electrons per spin")
        nc = int(n_frozen)
        stop = (self.num_spatial_orbitals if n_active_orbitals is None
                else nc + int(n_active_orbitals))
        if stop > self.num_spatial_orbitals or stop <= nc:
            raise ValueError(
                f"active window [{nc}:{stop}] out of range for "
                f"{self.num_spatial_orbitals} orbitals")
        h = self.hcore_mo
        eri = self.eri_mo
        core = slice(0, nc)
        act = slice(nc, stop)
        e_core = (2.0 * np.trace(h[core, core])
                  + 2.0 * np.einsum("iijj->", eri[core, core, core, core])
                  - np.einsum("ijji->", eri[core, core, core, core]))
        h_eff = (h[act, act]
                 + 2.0 * np.einsum("pqii->pq", eri[act, act, core, core])
                 - np.einsum("piiq->pq", eri[act, core, core, act]))
        dip_act, dip_core, nuc_dip = None, self.dipole_core, None
        if self.dipole_mo is not None:
            dip_act = np.ascontiguousarray(self.dipole_mo[:, act, act])
            dip_core = self.dipole_core + 2.0 * np.einsum(
                "dii->d", self.dipole_mo[:, core, core])
            nuc_dip = self.nuclear_dipole
        quad_act, quad_core = None, self.quadrupole_core
        if self.quadrupole_mo is not None:
            quad_act = np.ascontiguousarray(self.quadrupole_mo[:, act, act])
            quad_core = self.quadrupole_core + 2.0 * np.einsum(
                "dii->d", self.quadrupole_mo[:, core, core])
        c_act, p_core = None, self.density_core_ao
        if self.mo_coeff_ao is not None:
            c_act = np.ascontiguousarray(self.mo_coeff_ao[:, act])
            c_core = self.mo_coeff_ao[:, core]
            p_core = ((0.0 if p_core is None else p_core)
                      + 2.0 * c_core @ c_core.T)
        return ElectronicStructureProblem(
            num_particles=(na - nc, nb - nc),
            num_spatial_orbitals=stop - nc,
            nuclear_repulsion_energy=self.nuclear_repulsion_energy,
            hcore_mo=h_eff,
            eri_mo=eri[act, act, act, act].copy(),
            scf=self.scf,
            atom=self.atom,
            basis=self.basis,
            core_energy=self.core_energy + float(e_core),
            dipole_mo=dip_act,
            nuclear_dipole=nuc_dip,
            dipole_core=dip_core,
            quadrupole_mo=quad_act,
            quadrupole_core=quad_core,
            ao_basis=self.ao_basis,
            mo_coeff_ao=c_act,
            density_core_ao=p_core,
            eri_engine=self.eri_engine,
        )

    def one_body_tensor(self) -> np.ndarray:
        """Spin-orbital one-body tensor h[p,q] (block spin ordering)."""
        n = self.num_spatial_orbitals
        h = np.zeros((2 * n, 2 * n))
        h[:n, :n] = self.hcore_mo
        h[n:, n:] = self.hcore_mo
        return h

    def two_body_tensor(self) -> np.ndarray:
        """Spin-orbital two-body tensor g[p,q,r,s] = 1/2 <pq|rs>.

        <pq|rs> = (pr|qs)_chemist * delta(sigma_p,sigma_r) * delta(sigma_q,sigma_s).
        """
        n = self.num_spatial_orbitals
        g = np.zeros((2 * n,) * 4)
        # physicist <pq|rs> from chemist (pr|qs)
        phys = self.eri_mo.transpose(0, 2, 1, 3)  # phys[p,q,r,s] = (pr|qs)
        for sp in (0, 1):          # spin of p (= spin of r)
            for sq in (0, 1):      # spin of q (= spin of s)
                sl_p = slice(sp * n, sp * n + n)
                sl_q = slice(sq * n, sq * n + n)
                g[sl_p, sl_q, sl_p, sl_q] += 0.5 * phys
        return g

    def integral_tensors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(one_body, two_body) spin-orbital tensors, reference convention."""
        return self.one_body_tensor(), self.two_body_tensor()

    def spatial_integral_tensors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(h_sp, g_sp) SPATIAL tensors — the framework's internal
        convention (h_sp = MO core Hamiltonian; g_sp = 1/2 <pq|rs>
        physicist).  Identical to spatial_blocks(*integral_tensors()) but
        never materializes the 16x-larger spin-orbital intermediate —
        essential beyond ~100 spatial orbitals (the M^4 spin tensor is
        16 m^4 doubles)."""
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
        """Args:
            spin: 2S = n_alpha - n_beta.  spin == 0 runs RHF; spin > 0
                runs ROHF, which keeps ONE set of spatial orbitals shared
                by both spins — the form the OptOrb partial-unitary
                machinery requires (U is spatial and spin-expanded via
                block_diag, reference base_opt_orb_solver.py:549).  For a
                standalone unrestricted SCF use `esoo_torch.chem.scf.uhf`.
        """
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
        from .basis import element_symbol, is_ghost
        charges = np.array(
            [0.0 if is_ghost(s) else ATOMIC_NUMBERS[element_symbol(s)]
             for s in symbols], dtype=np.float64)
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

        n_mo = C.shape[1]
        dip_ao = engine.dipole()
        dip_mo = np.einsum("dpq,pi,qj->dij", dip_ao, C, C, optimize=True)
        nuc_dip = np.einsum("a,ad->d", charges, coords)
        quad_ao = engine.quadrupole()
        quad_mo = np.einsum("dpq,pi,qj->dij", quad_ao, C, C,
                            optimize=True)
        # AO -> owning-atom map (shells are emitted per atom; match by
        # center since Shell carries no atom index)
        ao_atoms = np.empty(engine.nbf, dtype=np.int64)
        for sh, off in zip(engine.shells, engine._offsets):
            a = int(np.argmin(np.linalg.norm(coords - sh.center, axis=1)))
            ao_atoms[off: off + sh.nfunc] = a
        ao_basis = AOBasisInfo(overlap=S, ao_atoms=ao_atoms,
                               symbols=list(symbols),
                               atomic_numbers=charges.astype(np.int64),
                               coords=coords, shells=list(engine.shells))
        return ElectronicStructureProblem(
            num_particles=(n_a, n_b),
            num_spatial_orbitals=n_mo,
            nuclear_repulsion_energy=scf.nuclear_repulsion,
            hcore_mo=h_mo,
            eri_mo=eri_mo,
            scf=scf,
            atom=self.atom,
            basis=self.basis,
            dipole_mo=dip_mo,
            nuclear_dipole=nuc_dip,
            quadrupole_mo=quad_mo,
            ao_basis=ao_basis,
            mo_coeff_ao=C,
            eri_engine=engine.eri_engine,
        )
