"""Configuration-interaction state construction (CIS / CISD / FCI) and
determinant enumeration (host NumPy).

Copy of esoo_tpu/initializations/ci.py: determinants are enumerated
combinatorially, matrix elements come from Slater-Condon rules with
ladder-operator parities that match the Jordan-Wigner bit conventions
(block ordering: alpha 0..n-1, beta n..2n-1).  Integral conventions:
  H = sum h[p,q] a+_p a_q + sum g[p,q,r,s] a+_p a+_q a_s a_r,
  g = 1/2 <pq|rs>  =>  <pq||rs> = 2*(g[p,q,r,s] - g[p,q,s,r]).
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import numpy as np


def _occupied(det: int, n: int) -> List[int]:
    return [p for p in range(n) if (det >> p) & 1]


def _parity(det: int, mask: int) -> int:
    return bin(det & mask).count("1") & 1


def excite(det: int, i: int, a: int) -> Tuple[int, float]:
    """Apply a+_a a_i with JW sign convention; returns (new_det, phase)."""
    if not (det >> i) & 1 or (det >> a) & 1:
        return det, 0.0
    s1 = -1.0 if _parity(det, (1 << i) - 1) else 1.0
    d1 = det & ~(1 << i)
    s2 = -1.0 if _parity(d1, (1 << a) - 1) else 1.0
    return d1 | (1 << a), s1 * s2


def hf_determinant(num_spin_orbitals: int, num_particles: Tuple[int, int]) -> int:
    """HF occupation bitmask — single source of truth lives in sim.ansatz
    so the CI determinant convention can never drift from the HartreeFock
    circuit's."""
    from ..sim.ansatz import hartree_fock_bitmask
    return hartree_fock_bitmask(num_spin_orbitals // 2, num_particles)


def enumerate_determinants(num_spin_orbitals: int,
                           num_particles: Tuple[int, int],
                           max_excitation: int) -> List[int]:
    """HF determinant plus all spin-conserving excitations up to the order."""
    n = num_spin_orbitals // 2
    na, nb = num_particles
    occ_a = list(range(na))
    vir_a = list(range(na, n))
    occ_b = [n + p for p in range(nb)]
    vir_b = [n + p for p in range(nb, n)]
    hf = hf_determinant(num_spin_orbitals, num_particles)

    dets = {hf}
    # excitation of ka alpha electrons and kb beta electrons, ka+kb <= order
    for ka in range(0, max_excitation + 1):
        for kb in range(0, max_excitation + 1 - ka):
            if ka == 0 and kb == 0:
                continue
            if ka > min(len(occ_a), len(vir_a)):
                continue
            if kb > min(len(occ_b), len(vir_b)):
                continue
            for oa in itertools.combinations(occ_a, ka):
                for va in itertools.combinations(vir_a, ka):
                    for ob in itertools.combinations(occ_b, kb):
                        for vb in itertools.combinations(vir_b, kb):
                            d = hf
                            for i in oa + ob:
                                d &= ~(1 << i)
                            for a in va + vb:
                                d |= 1 << a
                            dets.add(d)
    return sorted(dets)


def ci_matrix(dets: List[int], h: np.ndarray, g: np.ndarray,
              vectorized: bool = True) -> np.ndarray:
    """Hamiltonian matrix in the given determinant basis (Slater-Condon).

    `vectorized=True` (default) uses the boolean-occupancy batch
    implementation (no per-pair Python work, supports > 64 spin orbitals);
    False runs the scalar reference implementation used as its oracle.
    """
    if vectorized:
        return _ci_matrix_vectorized(dets, h, g)
    return _ci_matrix_scalar(dets, h, g)


def _occupancy_matrix(dets: List[int], n: int) -> np.ndarray:
    occ = np.zeros((len(dets), n), dtype=bool)
    for m, d in enumerate(dets):
        for p in range(n):
            if (d >> p) & 1:
                occ[m, p] = True
    return occ


def slater_condon_structure(dets: List[int], n: int) -> dict:
    """(h, g)-independent index/phase structure of the determinant-basis
    Hamiltonian: occupancies, single- and double-connected pair indices,
    the excitation orbitals, fermionic phases, and the shared-occupation
    masks needed for the singles values.

    Used by the numpy Slater-Condon assembly below.
    """
    from ..sim.strings import _bitcount
    nd = len(dets)
    occ = _occupancy_matrix(dets, n)                   # (nd, n) bool
    occf = occ.astype(np.float64)

    # pairwise excitation degree via packed-uint64 XOR+popcount, computed
    # blockwise (never materializing an (nd, nd, n) tensor)
    W = -(-n // 64)
    packed = np.zeros((nd, W), dtype=np.uint64)
    for w in range(W):
        for b in range(min(64, n - 64 * w)):
            packed[:, w] |= occ[:, 64 * w + b].astype(np.uint64) << np.uint64(b)
    ndiff = np.empty((nd, nd), dtype=np.int16)
    block = max(1, (1 << 24) // max(nd, 1))            # ~128 MB per chunk
    for lo in range(0, nd, block):
        hi = min(lo + block, nd)
        x = packed[lo:hi, None, :] ^ packed[None, :, :]
        ndiff[lo:hi] = _bitcount(x).sum(axis=2, dtype=np.int16)
    # parity helper: cumulative occupied count below each orbital, per det
    cum = np.cumsum(occf, axis=1)                      # inclusive
    cum_excl = cum - occf                              # strictly below p

    out = {"occf": occf}

    # -- singles (ndiff == 2) ----------------------------------------------
    su, sv = np.nonzero(np.triu(ndiff == 2, k=1))
    out["su"], out["sv"] = su, sv
    if len(su):
        pair_diff = occ[su] ^ occ[sv]                  # (pairs, n)
        d_from = occ[su] & pair_diff                   # i occupied in D
        d_to = occ[sv] & pair_diff                     # a occupied in D'
        i_idx = d_from.argmax(axis=1)
        a_idx = d_to.argmax(axis=1)
        # phase: (-1)^{#occupied strictly between i and a in D}
        lo = np.minimum(i_idx, a_idx)
        hi = np.maximum(i_idx, a_idx)
        between = (cum_excl[su, hi] - cum[su, lo])
        phase = 1.0 - 2.0 * (between.astype(np.int64) & 1)
        common = (occ[su] & occ[sv]).astype(np.float64)
        out.update(s_i=i_idx, s_a=a_idx, s_phase=phase, s_common=common)

    # -- doubles (ndiff == 4) -----------------------------------------------
    du, dv = np.nonzero(np.triu(ndiff == 4, k=1))
    out["du"], out["dv"] = du, dv
    if len(du):
        pair_diff = occ[du] ^ occ[dv]
        d_from = occ[du] & pair_diff
        d_to = occ[dv] & pair_diff
        # i < j removed, a < b added (argmax finds first True = lowest index)
        i_idx = d_from.argmax(axis=1)
        j_idx = (n - 1) - d_from[:, ::-1].argmax(axis=1)
        a_idx = d_to.argmax(axis=1)
        b_idx = (n - 1) - d_to[:, ::-1].argmax(axis=1)
        # phase: product of the two single-excitation parities computed in
        # sequence (i->a on D, then j->b on D with i,a already toggled)
        lo1 = np.minimum(i_idx, a_idx)
        hi1 = np.maximum(i_idx, a_idx)
        t1 = (cum_excl[du, hi1] - cum[du, lo1]).astype(np.int64)
        # after i->a: occupancy of D changes at i (off) and a (on)
        # correction to the between-count for the second excitation
        lo2 = np.minimum(j_idx, b_idx)
        hi2 = np.maximum(j_idx, b_idx)
        t2 = (cum_excl[du, hi2] - cum[du, lo2]).astype(np.int64)
        # adjust t2 for the i->a toggle if i or a lies strictly between j,b
        in_range_i = (lo2 < i_idx) & (i_idx < hi2)
        in_range_a = (lo2 < a_idx) & (a_idx < hi2)
        t2 = t2 - in_range_i.astype(np.int64) + in_range_a.astype(np.int64)
        phase = 1.0 - 2.0 * ((t1 + t2) & 1)
        out.update(d_i=i_idx, d_j=j_idx, d_a=a_idx, d_b=b_idx, d_phase=phase)
    return out


def _ci_matrix_vectorized(dets: List[int], h: np.ndarray,
                          g: np.ndarray) -> np.ndarray:
    """Batch Slater-Condon: all diagonal/single/double elements at once."""
    n = h.shape[0]
    nd = len(dets)
    st = slater_condon_structure(dets, n)
    occf = st["occf"]

    # <pq||rs> = 2*(g[pqrs] - g[pqsr]); gathered lazily from g (never
    # materialized: at N >= 100 the full antisymmetrized copy is GBs)

    H = np.zeros((nd, nd))
    # -- diagonal: sum_p h_pp + 1/2 sum_{p!=q} <pq||pq> --------------------
    hdiag = np.diag(h)
    J = 2.0 * (np.einsum("pqpq->pq", g) - np.einsum("pqqp->pq", g))
    H[np.diag_indices(nd)] = occf @ hdiag + 0.5 * np.einsum(
        "mp,pq,mq->m", occf, J, occf)

    su, sv = st["su"], st["sv"]
    if len(su):
        i_idx, a_idx = st["s_i"], st["s_a"]
        # value: h[i,a] + sum_{r in D∩D'} <ir||ar>
        # C[p,q,r] = <p r||q r> precomputed once (n^3), then gathered
        C = 2.0 * (np.einsum("prqr->pqr", g) - np.einsum("prrq->pqr", g))
        Air = C[i_idx, a_idx]                          # (pairs, r)
        val = h[i_idx, a_idx] + np.einsum("kr,kr->k", Air, st["s_common"])
        H[su, sv] = st["s_phase"] * val
        H[sv, su] = H[su, sv]

    du, dv = st["du"], st["dv"]
    if len(du):
        i_idx, j_idx = st["d_i"], st["d_j"]
        a_idx, b_idx = st["d_a"], st["d_b"]
        vals = 2.0 * (g[i_idx, j_idx, a_idx, b_idx]
                      - g[i_idx, j_idx, b_idx, a_idx])
        H[du, dv] = st["d_phase"] * vals
        H[dv, du] = H[du, dv]
    return H


def _ci_matrix_scalar(dets: List[int], h: np.ndarray,
                      g: np.ndarray) -> np.ndarray:
    """Scalar Slater-Condon reference implementation (oracle)."""
    n = h.shape[0]
    nd = len(dets)

    def anti(p, q, r, s):
        # <pq||rs> = 2*(g[p,q,r,s] - g[p,q,s,r])
        return 2.0 * (g[p, q, r, s] - g[p, q, s, r])

    H = np.zeros((nd, nd))
    occ_lists = [_occupied(d, n) for d in dets]
    index = {d: m for m, d in enumerate(dets)}

    for m, D in enumerate(dets):
        occ = occ_lists[m]
        # diagonal
        e = sum(h[p, p] for p in occ)
        for ii in range(len(occ)):
            for jj in range(ii + 1, len(occ)):
                p, q = occ[ii], occ[jj]
                e += anti(p, q, p, q)
        H[m, m] = e

        # singles and doubles reachable from D (upper triangle only)
        for mm in range(m + 1, nd):
            Dp = dets[mm]
            diff = D ^ Dp
            nd_diff = bin(diff).count("1")
            if nd_diff == 2:
                i = (diff & D).bit_length() - 1
                a = (diff & Dp).bit_length() - 1
                _, ph = excite(D, i, a)
                common = _occupied(D & Dp, n)
                val = h[i, a] + sum(anti(i, r, a, r) for r in common)
                H[m, mm] = H[mm, m] = ph * val
            elif nd_diff == 4:
                rem = _occupied(diff & D, n)      # i < j removed
                add = _occupied(diff & Dp, n)     # a < b added
                i, j = rem
                a, b = add
                d1, s1 = excite(D, i, a)
                if s1 == 0.0:
                    d1, s1 = excite(D, i, b)
                    d2, s2 = excite(d1, j, a)
                else:
                    d2, s2 = excite(d1, j, b)
                    if d2 != Dp:
                        d1, s1 = excite(D, i, b)
                        d2, s2 = excite(d1, j, a)
                ph = s1 * s2
                H[m, mm] = H[mm, m] = ph * anti(i, j, a, b)
    return H


def _states_from_eigvecs(dets, vecs, num_spin_orbitals, representation,
                         truncation_threshold):
    dim = 1 << num_spin_orbitals
    out = []
    for k in range(vecs.shape[1]):
        v = vecs[:, k]
        v = np.where(np.abs(v) < truncation_threshold, 0.0, v)
        nrm = np.linalg.norm(v)
        if nrm > 0:
            v = v / nrm
        if representation == "dense":
            sv = np.zeros(dim)
            for d, c in zip(dets, v):
                sv[d] = c
            out.append(sv)
        else:
            out.append({d: c for d, c in zip(dets, v) if c != 0.0})
    return out


def _ci_states(one_body_integrals, two_body_integrals, num_particles,
               max_excitation, state_representation, truncation_threshold):
    h = np.asarray(one_body_integrals, dtype=np.float64)
    g = np.asarray(two_body_integrals, dtype=np.float64)
    N = h.shape[0]
    dets = enumerate_determinants(N, num_particles, max_excitation)
    H = ci_matrix(dets, h, g)
    w, v = np.linalg.eigh(H)
    states = _states_from_eigvecs(dets, v, N, state_representation,
                                  truncation_threshold)
    return states, w


def get_CIS_states(one_body_integrals, two_body_integrals, num_particles,
                   state_representation: Optional[str] = "sparse",
                   truncation_threshold: Optional[float] = 1e-10):
    """CIS eigenstates (reference: configuration_interaction_states.py:156)."""
    states, _ = _ci_states(one_body_integrals, two_body_integrals,
                           num_particles, 1, state_representation,
                           truncation_threshold)
    return states


def get_CISD_states(one_body_integrals, two_body_integrals, num_particles,
                    state_representation: Optional[str] = "sparse",
                    truncation_threshold: Optional[float] = 1e-10):
    """CISD eigenstates (reference: configuration_interaction_states.py:354)."""
    states, _ = _ci_states(one_body_integrals, two_body_integrals,
                           num_particles, 2, state_representation,
                           truncation_threshold)
    return states


def get_CIS_energies(one_body_integrals, two_body_integrals, num_particles):
    _, w = _ci_states(one_body_integrals, two_body_integrals, num_particles,
                      1, "sparse", 1e-10)
    return w


def get_CISD_energies(one_body_integrals, two_body_integrals, num_particles):
    _, w = _ci_states(one_body_integrals, two_body_integrals, num_particles,
                      2, "sparse", 1e-10)
    return w


def get_FCI_states(one_body_integrals, two_body_integrals, num_particles,
                   state_representation: Optional[str] = "sparse",
                   truncation_threshold: Optional[float] = 1e-10):
    """Full-CI eigenstates of the (n_alpha, n_beta) sector.

    Beyond-reference capability: exact diagonalization in the determinant
    basis of the sector (dimension C(n, n_a) * C(n, n_b), NOT 2^N), built
    on the same vectorized Slater-Condon machinery as CIS/CISD.  This is
    the exact answer the eigensolvers approximate inside an active space —
    the natural quality oracle for OptOrb runs."""
    na, nb = num_particles
    states, _ = _ci_states(one_body_integrals, two_body_integrals,
                           num_particles, na + nb, state_representation,
                           truncation_threshold)
    return states


def get_FCI_energies(one_body_integrals, two_body_integrals, num_particles):
    """Full-CI eigenvalues of the (n_alpha, n_beta) sector (see
    get_FCI_states)."""
    na, nb = num_particles
    _, w = _ci_states(one_body_integrals, two_body_integrals,
                      num_particles, na + nb, "sparse", 1e-10)
    return w
