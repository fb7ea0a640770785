"""The UCCSD state of a parameter vector, in plain PyTorch, over a Sector.

The ansatz as the port's `UCCSD(n, (na, nb), initial_state=HartreeFock(n,
(na, nb)))` defines it: from the Hartree-Fock determinant (alpha orbitals
0..na-1, beta n..n+nb-1 in block spin order), one factor
exp(theta_k (T_k - T_k^+)) per excitation, the first excitation applied
first.  The excitations are the spin-preserving singles (alpha, then beta;
occupied outer, virtual inner) and then the doubles over pairs i < j of
occupied and a < b of virtual spin orbitals (occupied pairs outer) whose
total spin projection is kept.  T for occupied (i, j) and virtual (a, b)
is a+_a a+_b a_j a_i (a single: a+_a a_i).  Since G = T - T^+ has G^3 = -G
on the sector, exp(theta G) = 1 + sin(theta) G + (1 - cos(theta)) G^2.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .sector import Sector, _popcount


def excitations(n: int, na: int, nb: int) -> list:
    occ_a, vir_a = list(range(na)), list(range(na, n))
    occ_b, vir_b = [n + i for i in range(nb)], [n + i for i in range(nb, n)]
    singles = ([((i,), (a,)) for i in occ_a for a in vir_a]
               + [((i,), (a,)) for i in occ_b for a in vir_b])

    def sz(k):
        return 0 if k < n else 1

    doubles = [((i, j), (a, b))
               for i, j in itertools.combinations(occ_a + occ_b, 2)
               for a, b in itertools.combinations(vir_a + vir_b, 2)
               if sz(i) + sz(j) == sz(a) + sz(b)]
    return singles + doubles


def _apply(det: int, occ, vir):
    """(det', sign) of T|det>, or None where T|det> = 0."""
    sign = 1
    for k in occ:                       # a_i acts first, then a_j
        if not (det >> k) & 1:
            return None
        sign *= (-1) ** _popcount(det & ((1 << k) - 1))
        det ^= 1 << k
    for k in reversed(vir):             # then a+_b, then a+_a
        if (det >> k) & 1:
            return None
        sign *= (-1) ** _popcount(det & ((1 << k) - 1))
        det |= 1 << k
    return det, sign


def generators(sector: Sector) -> torch.Tensor:
    """(K, nd, nd) float64: G_k = T_k - T_k^+ over the sector's grid."""
    dets = sector.determinants()
    index = {int(d): i for i, d in enumerate(dets)}
    excs = excitations(sector.n, sector.na, sector.nb)
    G = np.zeros((len(excs), len(dets), len(dets)))
    for k, (occ, vir) in enumerate(excs):
        for c, d in enumerate(dets):
            hit = _apply(int(d), occ, vir)
            if hit is not None:
                r = index[hit[0]]
                G[k, r, c] += hit[1]
                G[k, c, r] -= hit[1]
    return torch.as_tensor(G, device=sector.device)


def state(sector: Sector, G: torch.Tensor, theta: torch.Tensor):
    """The UCCSD state at theta as an (nB, nA) matrix."""
    psi = torch.zeros(sector.dim, dtype=G.dtype, device=G.device)
    b, a = sector.hf_index()
    psi[b * sector.nA + a] = 1.0
    for k in range(G.shape[0]):
        x = G[k] @ psi
        psi = psi + torch.sin(theta[k]) * x + (1 - torch.cos(theta[k])) * (
            G[k] @ x)
    return psi.reshape(sector.nB, sector.nA)
