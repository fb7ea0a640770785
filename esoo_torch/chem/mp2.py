"""Closed-shell MP2 from the problem's MO-basis tensors.

Copy of esoo_tpu/chem/mp2.py (host NumPy).

Second-order Møller–Plesset correlation energy and the UNRELAXED MP2
one-particle density — the standard cheap correlated baseline, and (via
its natural orbitals) the classic active-space selection tool: MP2-NO
occupations tell you which orbitals carry correlation before any
expensive OptOrb/CASSCF run chooses `num_spin_orbitals`.

Everything is computed from `hcore_mo`/`eri_mo` alone (orbital energies
are rebuilt as the diagonal of the MO-basis Fock operator), so problems
reconstructed from FCIDUMP files work as well as driver-built ones.
The reference has no correlated method of its own at all — it delegates
every classical energy to PySCF.
"""

from __future__ import annotations

import numpy as np


def mp2(problem, n_frozen: int = 0) -> dict:
    """MP2 for a closed-shell problem.

    Returns a dict:
      e_corr          — the MP2 correlation energy (Hartree)
      e_hf            — the HF energy of the reference determinant,
                        recomputed from the tensors (electronic)
      e_total         — e_hf + e_corr + nuclear repulsion + core_energy
      one_rdm_spatial — UNRELAXED MP2 1-RDM (n, n), trace = n_electrons
      natural_occupations / natural_occupation_orbitals — eigen-
                        decomposition of the 1-RDM (descending), in the
                        problem's MO basis: the active-space selector
      mo_energy       — the Fock diagonal used for the denominators

    `n_frozen` freezes the lowest spatial orbitals out of the
    correlation treatment (their 1-RDM rows stay exactly 2).
    """
    n_a, n_b = problem.num_particles
    if n_a != n_b:
        raise ValueError("mp2 requires a closed-shell problem "
                         f"(num_particles={problem.num_particles})")
    nocc = n_a
    h = np.asarray(problem.hcore_mo, dtype=np.float64)
    eri = np.asarray(problem.eri_mo, dtype=np.float64)   # (pq|rs)
    n = h.shape[0]
    if not 0 <= n_frozen < nocc:
        raise ValueError(f"n_frozen={n_frozen} out of range for "
                         f"{nocc} occupied orbitals")
    if nocc >= n:
        raise ValueError("no virtual orbitals — MP2 needs nocc < norb")

    o = slice(0, nocc)
    # canonical (or semi-canonical) orbital energies: the Fock diagonal
    F = (h + 2.0 * np.einsum("pqjj->pq", eri[:, :, o, o])
         - np.einsum("pjjq->pq", eri[:, o, o, :]))
    eps = np.diag(F).copy()

    e_hf = float(2.0 * np.trace(h[o, o])
                 + 2.0 * np.einsum("iijj->", eri[o, o, o, o])
                 - np.einsum("ijji->", eri[o, o, o, o]))

    oc = slice(n_frozen, nocc)
    v = slice(nocc, n)
    ov = eri[oc, v, oc, v]                      # (ia|jb)
    denom = (eps[oc, None, None, None] + eps[None, None, oc, None]
             - eps[None, v, None, None] - eps[None, None, None, v])
    t = ov / denom                              # t[i, a, j, b]
    e_corr = float(np.einsum("iajb,iajb->", t, 2.0 * ov)
                   - np.einsum("iajb,ibja->", t, ov))

    # unrelaxed MP2 density (spatial, closed-shell):
    #   D_ab = +2 Σ_ijc t_ij^ac (2 t_ij^bc − t_ij^cb)
    #   D_ij = −2 Σ_kab t_ik^ab (2 t_jk^ab − t_jk^ba)
    tt = 2.0 * t - np.transpose(t, (0, 3, 2, 1))   # 2 t^ab − t^ba
    D_vv = 2.0 * np.einsum("iajc,ibjc->ab", t, tt, optimize=True)
    D_oo = -2.0 * np.einsum("iakb,jakb->ij", t, tt, optimize=True)
    gamma = np.zeros((n, n))
    gamma[o, o] = 2.0 * np.eye(nocc)
    gamma[oc, oc] += D_oo
    gamma[v, v] += D_vv

    occs, V = np.linalg.eigh(0.5 * (gamma + gamma.T))
    order = np.argsort(occs)[::-1]
    return {
        "e_corr": e_corr,
        "e_hf": e_hf,
        "e_total": (e_hf + e_corr + problem.nuclear_repulsion_energy
                    + getattr(problem, "core_energy", 0.0)),
        "one_rdm_spatial": gamma,
        "natural_occupations": occs[order],
        "natural_occupation_orbitals": V[:, order],
        "mo_energy": eps,
    }
