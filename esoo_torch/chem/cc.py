"""Spin-orbital CCSD and CCSD(T) from the problem's MO tensors.

Copy of esoo_tpu/chem/cc.py (host NumPy).

Coupled cluster with singles and doubles (plus the standard
perturbative-triples correction) over antisymmetrized spin-orbital
integrals — the canonical high-accuracy classical ladder rung between
MP2 and exact diagonalization.  The amplitude equations follow the
standard intermediate formulation (Stanton, Gauss, Watts & Bartlett,
J. Chem. Phys. 94, 4334 (1991)); everything is built from
`hcore_mo`/`eri_mo` alone, so FCIDUMP-read problems work.

Exactness anchors enforced by tests/test_cc.py: for a TWO-electron
system CCSD is exact (== the package's own full CI to 1e-9) and (T)
vanishes identically; at iteration zero the energy equals MP2.

Dense o²v²/o³v³ intermediates — intended for the active-space sizes
this package targets, not for large-molecule production CC.
"""

from __future__ import annotations

import numpy as np


def _spin_orbital_blocks(problem, n_frozen: int = 0):
    """Antisymmetrized spin-orbital integrals ⟨pq||rs⟩ (physicist),
    Fock matrix, and the occupied/virtual split.  Spin-orbital order:
    (spatial, spin) interleaved as 2p+σ.

    Open shells (n_alpha > n_beta, ROHF orbitals — one spatial set, the
    form the driver provides) are handled by the NON-canonical CC
    equations: the ROHF Fock is not diagonal, but its off-diagonal
    occupied/virtual blocks enter through the Foo/Fvv intermediates and
    the iteration converges to the same fixed point (H3 doublet lands
    on FCI to 1e-10, tests/test_cc.py)."""
    n_a, n_b = problem.num_particles
    h = np.asarray(problem.hcore_mo, dtype=np.float64)
    eri = np.asarray(problem.eri_mo, dtype=np.float64)   # (pq|rs) chem
    n = h.shape[0]
    if not 0 <= n_frozen <= n_b:
        raise ValueError(f"n_frozen={n_frozen} out of range for "
                         f"{n_b} doubly occupied orbitals")
    if n_a >= n:
        raise ValueError("no virtual orbitals")

    N = 2 * n
    sp = np.arange(N) // 2          # spatial index of each spin orbital
    sz = np.arange(N) % 2           # spin of each spin orbital
    hso = h[np.ix_(sp, sp)] * (sz[:, None] == sz[None, :])
    # <pq|rs> physicist = (pr|qs) chemist with spin deltas
    phys = (eri[np.ix_(sp, sp, sp, sp)].transpose(0, 2, 1, 3)
            * (sz[:, None, None, None] == sz[None, None, :, None])
            * (sz[None, :, None, None] == sz[None, None, None, :]))
    anti = phys - phys.transpose(0, 1, 3, 2)

    occ = np.array(sorted([2 * p for p in range(n_a)]
                          + [2 * p + 1 for p in range(n_b)]))
    f = hso + np.einsum("piqi->pq", anti[:, occ][:, :, :, occ])
    e_hf = float(np.sum(hso[np.ix_(occ, occ)].diagonal())
                 + 0.5 * np.einsum(
                     "ijij->", anti[np.ix_(occ, occ, occ, occ)]))

    # frozen cores are doubly occupied spatials < n_frozen — exactly
    # the first 2*n_frozen entries of the sorted occ list
    o = occ[2 * n_frozen:]
    v = np.array(sorted(set(range(N)) - set(occ.tolist())))
    return anti, f, o, v, e_hf


def ccsd(problem, n_frozen: int = 0, max_iter: int = 100,
         conv_tol: float = 1e-10, amp_tol: float = 1e-8,
         diis_size: int = 8, triples: bool = False) -> dict:
    """CCSD (spin-orbital formulation; closed AND open shells — ROHF
    references use the non-canonical equations) with optional
    perturbative triples ((T) on open shells is the non-canonical
    variant: the f_ov·t2 disconnected term is included).

    Returns a dict: e_corr (CCSD correlation), e_hf, e_total (incl.
    nuclear repulsion + core_energy), n_iter, converged, t1/t2
    amplitudes, and — with triples=True — e_triples and
    e_total_ccsd_t."""
    anti, f, o, v, e_hf = _spin_orbital_blocks(problem, n_frozen)
    no, nv = len(o), len(v)
    eps = np.diag(f)
    fo, fv = eps[o], eps[v]
    D1 = fo[:, None] - fv[None, :]
    D2 = (fo[:, None, None, None] + fo[None, :, None, None]
          - fv[None, None, :, None] - fv[None, None, None, :])

    oo = np.ix_(o, o)
    ov = np.ix_(o, v)
    OOVV = np.ix_(o, o, v, v)
    oovv = anti[OOVV]
    t1 = np.zeros((no, nv))
    t2 = oovv / D2                           # MP2 start

    def energy(t1, t2):
        e = np.einsum("ia,ia->", f[ov], t1)
        e += 0.25 * np.einsum("ijab,ijab->", oovv, t2)
        e += 0.5 * np.einsum("ijab,ia,jb->", oovv, t1, t1,
                             optimize=True)
        return float(e)

    # slices of the antisymmetrized integrals used by the equations
    W = {
        "oovv": anti[OOVV],
        "ovvv": anti[np.ix_(o, v, v, v)],
        "ooov": anti[np.ix_(o, o, o, v)],
        "oooo": anti[np.ix_(o, o, o, o)],
        "vvvv": anti[np.ix_(v, v, v, v)],
        "ovvo": anti[np.ix_(o, v, v, o)],
    }
    # <mb||ij> = <ij||mb> and <ab||ej> = -<je||ab> (real integrals):
    # derived views instead of more (2n)^4-tensor slices
    W["ovoo"] = W["ooov"].transpose(2, 3, 0, 1)
    W["vvvo"] = -W["ovvv"].transpose(2, 3, 1, 0)
    del anti        # the (2n)^4 tensor is no longer needed
    foo = f[oo] - np.diag(fo)
    fvv = f[np.ix_(v, v)] - np.diag(fv)
    fov = f[ov]

    diis_t, diis_e = [], []
    e_old = energy(t1, t2)
    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        taut = t2 + 0.5 * (np.einsum("ia,jb->ijab", t1, t1)
                           - np.einsum("ib,ja->ijab", t1, t1))
        tau = t2 + (np.einsum("ia,jb->ijab", t1, t1)
                    - np.einsum("ib,ja->ijab", t1, t1))

        Fae = (fvv - 0.5 * np.einsum("me,ma->ae", fov, t1)
               + np.einsum("mf,mafe->ae", t1, W["ovvv"])
               - 0.5 * np.einsum("mnaf,mnef->ae", taut, W["oovv"], optimize=True))
        Fmi = (foo + 0.5 * np.einsum("me,ie->mi", fov, t1)
               + np.einsum("ne,mnie->mi", t1, W["ooov"])
               + 0.5 * np.einsum("inef,mnef->mi", taut, W["oovv"], optimize=True))
        Fme = fov + np.einsum("nf,mnef->me", t1, W["oovv"])

        Wmnij = (W["oooo"]
                 + np.einsum("je,mnie->mnij", t1, W["ooov"])
                 - np.einsum("ie,mnje->mnij", t1, W["ooov"])
                 + 0.25 * np.einsum("ijef,mnef->mnij", tau, W["oovv"], optimize=True))
        Wabef = (W["vvvv"]
                 - np.einsum("mb,amef->abef", t1, -W["ovvv"]
                             .transpose(1, 0, 2, 3))
                 + np.einsum("ma,bmef->abef", t1, -W["ovvv"]
                             .transpose(1, 0, 2, 3))
                 + 0.25 * np.einsum("mnab,mnef->abef", tau, W["oovv"], optimize=True))
        Wmbej = (W["ovvo"]
                 + np.einsum("jf,mbef->mbej", t1, W["ovvv"])
                 - np.einsum("nb,mnej->mbej", t1,
                             -W["ooov"].transpose(0, 1, 3, 2))
                 - np.einsum("jnfb,mnef->mbej",
                             0.5 * t2 + np.einsum("jf,nb->jnfb", t1, t1),
                             W["oovv"], optimize=True))

        rhs1 = (fov + np.einsum("ie,ae->ia", t1, Fae)
                - np.einsum("ma,mi->ia", t1, Fmi)
                + np.einsum("imae,me->ia", t2, Fme)
                - np.einsum("nf,naif->ia", t1,
                            W["ovvo"].transpose(0, 1, 3, 2) * -1.0)
                - 0.5 * np.einsum("imef,maef->ia", t2, W["ovvv"], optimize=True)
                - 0.5 * np.einsum("mnae,nmie->ia", t2,
                                  W["ooov"].transpose(1, 0, 2, 3)))

        FmeT = Fme
        P_ab_1 = np.einsum("ijae,be->ijab", t2,
                           Fae - 0.5 * np.einsum("mb,me->be", t1, FmeT))
        P_ij_1 = np.einsum("imab,mj->ijab", t2,
                           Fmi + 0.5 * np.einsum("je,me->mj", t1, FmeT))
        P_ijab = np.einsum("imae,mbej->ijab", t2, Wmbej, optimize=True) \
            - np.einsum("ie,ma,mbej->ijab", t1, t1, W["ovvo"],
                        optimize=True)
        P_ij_2 = np.einsum("ie,abej->ijab", t1, W["vvvo"])
        P_ab_2 = np.einsum("ma,mbij->ijab", t1, W["ovoo"])

        rhs2 = (W["oovv"]
                + (P_ab_1 - P_ab_1.transpose(0, 1, 3, 2))
                - (P_ij_1 - P_ij_1.transpose(1, 0, 2, 3))
                + 0.5 * np.einsum("mnab,mnij->ijab", tau, Wmnij, optimize=True)
                + 0.5 * np.einsum("ijef,abef->ijab", tau, Wabef, optimize=True)
                + (P_ijab - P_ijab.transpose(1, 0, 2, 3)
                   - P_ijab.transpose(0, 1, 3, 2)
                   + P_ijab.transpose(1, 0, 3, 2))
                + (P_ij_2 - P_ij_2.transpose(1, 0, 2, 3))
                - (P_ab_2 - P_ab_2.transpose(0, 1, 3, 2)))

        t1_new = rhs1 / D1
        t2_new = rhs2 / D2

        # amplitude DIIS
        vec = np.concatenate([t1_new.ravel(), t2_new.ravel()])
        err = np.concatenate([(t1_new - t1).ravel(),
                              (t2_new - t2).ravel()])
        diis_t.append(vec)
        diis_e.append(err)
        if len(diis_t) > diis_size:
            diis_t.pop(0)
            diis_e.pop(0)
        if len(diis_t) > 1:
            m = len(diis_t)
            B = -np.ones((m + 1, m + 1))
            B[m, m] = 0.0
            for a in range(m):
                for b in range(m):
                    B[a, b] = diis_e[a] @ diis_e[b]
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            try:
                w = np.linalg.lstsq(B, rhs, rcond=1e-12)[0][:m]
                if np.all(np.isfinite(w)) and np.abs(w).max() < 1e6:
                    vec = sum(wi * vi for wi, vi in zip(w, diis_t))
            except np.linalg.LinAlgError:
                pass
        t1 = vec[: no * nv].reshape(no, nv)
        t2 = vec[no * nv:].reshape(no, no, nv, nv)

        e_new = energy(t1, t2)
        if (abs(e_new - e_old) < conv_tol
                and np.linalg.norm(err) < amp_tol):
            converged = True
            e_old = e_new
            break
        e_old = e_new

    out = {
        "e_corr": e_old,
        "e_hf": e_hf,
        "e_total": (e_hf + e_old + problem.nuclear_repulsion_energy
                    + getattr(problem, "core_energy", 0.0)),
        "n_iter": it,
        "converged": converged,
        "t1": t1,
        "t2": t2,
    }
    if triples:
        et = _triples_correction(W, fov, t1, t2, fo, fv)
        out["e_triples"] = et
        out["e_total_ccsd_t"] = out["e_total"] + et
    return out


def _triples_correction(W, fov, t1, t2, fo, fv) -> float:
    """Perturbative (T): disconnected + connected triples (standard
    CCSD(T) formula; vanishes identically for two electrons)."""
    D3 = (fo[:, None, None, None, None, None]
          + fo[None, :, None, None, None, None]
          + fo[None, None, :, None, None, None]
          - fv[None, None, None, :, None, None]
          - fv[None, None, None, None, :, None]
          - fv[None, None, None, None, None, :])

    def p_i(jk_term):
        # antisymmetrize i with j and k (i/jk)
        return (jk_term - jk_term.transpose(1, 0, 2, 3, 4, 5)
                - jk_term.transpose(2, 1, 0, 3, 4, 5))

    def p_a(bc_term):
        return (bc_term - bc_term.transpose(0, 1, 2, 4, 3, 5)
                - bc_term.transpose(0, 1, 2, 5, 4, 3))

    # disconnected: t1_ia <jk||bc>
    d = np.einsum("ia,jkbc->ijkabc", t1, W["oovv"])
    d = d + np.einsum("ia,jkbc->ijkabc", fov, t2)
    t_d = p_i(p_a(d)) / D3

    # connected: sum_e t2_jkae <ei||bc> - sum_m t2_imbc <ma||jk>
    # (<ei||bc> = -<ie||bc> by bra antisymmetry)
    c = (-np.einsum("jkae,iebc->ijkabc", t2, W["ovvv"])
         - np.einsum("imbc,majk->ijkabc", t2, W["ovoo"]))
    t_c = p_i(p_a(c)) / D3

    return float(np.einsum("ijkabc,ijkabc->", t_c * D3, t_c + t_d) / 36.0)
