"""The active integrals at a partial unitary, in plain PyTorch.

For a partial unitary U (m, n) over the configuration's MO basis, the
active integrals are h(U) = U^T h U and (pq|rs)(U) = sum_abcd U_ap U_bq
U_cr U_ds (ab|cd).  A state held fixed (its gamma and P, sector.py) has the
energy E(U) in them; the orbital step minimizes E over U, and its gradient
on the partial unitaries vanishes where that step is done.
"""

from __future__ import annotations

import torch


def rotate(h: torch.Tensor, eri: torch.Tensor, U: torch.Tensor):
    """(h(U), (pq|rs)(U)) by four one-index contractions."""
    m, n = U.shape
    g = (U.T @ eri.reshape(m, -1)).reshape(n, m, m, m)
    g = torch.einsum("pbcd,bq->pqcd", g, U)
    g = torch.einsum("pqcd,cr->pqrd", g, U)
    g = torch.einsum("pqrd,ds->pqrs", g, U)
    return U.T @ h @ U, g


def energy(h, eri, U, gamma, P):
    """E(U) = sum h'(U)_pq gamma_pq + 1/2 sum (pq|rs)(U) P_pqrs, with
    h'_pq = h_pq - 1/2 sum_r (pr|rq) (sector.py's Hamiltonian)."""
    h1, g = rotate(h, eri, U)
    h1 = h1 - 0.5 * torch.einsum("prrq->pq", g)
    return (h1 * gamma).sum() + 0.5 * (g * P).sum()


def gradient_norm(h, eri, U, gamma, P) -> float:
    """||G - U sym(U^T G)||_F with G = dE/dU at the fixed (gamma, P): the
    gradient on the partial unitaries (embedded metric).  It vanishes
    where orth(U - t G) = U for small t, the fixed point of the port's
    projected BB step."""
    with torch.enable_grad():
        X = U.detach().clone().requires_grad_(True)
        (G,) = torch.autograd.grad(energy(h, eri, X, gamma, P), X)
    S = U.T @ G
    return float(torch.linalg.matrix_norm(G - 0.5 * U @ (S + S.T)))


def gradient_ratio(h, eri, U, U0, gamma, P) -> tuple:
    """(|grad E(U)|, |grad E(U)| / |grad E(U0)|) of one fixed state: the
    orbital gradient left at the returned U, against the one at the
    request's start.  An orbital step that leaves U at its start reads 1."""
    at_u = gradient_norm(h, eri, U, gamma, P)
    return at_u, at_u / gradient_norm(h, eri, U0, gamma, P)
