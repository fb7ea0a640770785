"""The determinant sector of an active space, in plain PyTorch.

A determinant is an alpha string and a beta string, each a bitmask of the
n active spatial orbitals it occupies (orbital p is bit p).  A sector
vector is laid out as an (nB, nA) matrix over the ascending beta and alpha
bitmasks: the layout in which the port returns a CASSCF eigenvector.
Spin orbitals follow the block order (alpha 0..n-1, beta n..2n-1) and the
Jordan-Wigner sign convention: a ladder operator on spin orbital k picks up
(-1) to the number of occupied spin orbitals below k.

The Hamiltonian of real chemist integrals (pq|rs) and one-body h is

    H = sum_pq h'_pq E_pq + 1/2 sum_pqrs (pq|rs) E_pq E_rs,
    h'_pq = h_pq - 1/2 sum_r (pr|rq),

with E_pq = sum_sigma a+_p,sigma a_q,sigma.  Every product below is
formed from these definitions over a table of single excitations, in the
precision of its inputs (the checks run it at float64).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def strings(n: int, k: int) -> np.ndarray:
    """Ascending bitmasks of the k-subsets of n orbitals."""
    return np.array(sorted(sum(1 << i for i in c)
                           for c in itertools.combinations(range(n), k)),
                    dtype=np.int64)


def _popcount(x: int) -> int:
    return bin(x).count("1")


def excitation_table(strs: np.ndarray, n: int):
    """Every nonzero <I| a+_p a_q |J> over one spin's strings, as arrays
    (pq = p * n + q, I, J, sign)."""
    index = {int(s): i for i, s in enumerate(strs)}
    rows = []
    for j, s in enumerate(strs):
        s = int(s)
        for q in range(n):
            if not (s >> q) & 1:
                continue
            sq = (-1) ** _popcount(s & ((1 << q) - 1))
            t0 = s ^ (1 << q)
            for p in range(n):
                if (t0 >> p) & 1:
                    continue
                sp = (-1) ** _popcount(t0 & ((1 << p) - 1))
                rows.append((p * n + q, index[t0 | (1 << p)], j, sq * sp))
    return np.array(rows, dtype=np.int64).T


class Sector:
    """The (na, nb) sector of n spatial orbitals on `device`."""

    def __init__(self, n: int, na: int, nb: int, device="cpu"):
        self.n, self.na, self.nb = n, na, nb
        self.A, self.B = strings(n, na), strings(n, nb)
        self.nA, self.nB = len(self.A), len(self.B)
        self.dim = self.nA * self.nB
        self.device = torch.device(device)
        self._tables = {}
        for spin, strs in (("a", self.A), ("b", self.B)):
            pq, i, j, sg = excitation_table(strs, n)
            self._tables[spin] = tuple(
                torch.as_tensor(x, device=self.device) for x in (pq, i, j)
            ) + (torch.as_tensor(sg, device=self.device,
                                 dtype=torch.float64),)

    def hf_index(self):
        """(beta, alpha) grid position of the lowest-orbital determinant."""
        return (int(np.searchsorted(self.B, (1 << self.nb) - 1)),
                int(np.searchsorted(self.A, (1 << self.na) - 1)))

    def determinants(self) -> np.ndarray:
        """Full spin-orbital bitmasks (beta string << n | alpha string) in
        the row-major (beta, alpha) grid order."""
        return ((self.B[:, None] << self.n) | self.A[None, :]).reshape(-1)

    def apply_all(self, v: torch.Tensor) -> torch.Tensor:
        """D[pq] = E_pq v for every pq: (n^2, nB, nA) from v (nB, nA)."""
        n2 = self.n * self.n
        pq, i, j, sg = self._tables["a"]
        sg = sg.to(v.dtype)
        Da = torch.zeros(n2 * self.nA, self.nB, dtype=v.dtype,
                         device=v.device)
        Da.index_add_(0, pq * self.nA + i, sg[:, None] * v.T[j])
        D = Da.view(n2, self.nA, self.nB).transpose(1, 2)
        pq, i, j, sg = self._tables["b"]
        sg = sg.to(v.dtype)
        Db = torch.zeros(n2 * self.nB, self.nA, dtype=v.dtype,
                         device=v.device)
        Db.index_add_(0, pq * self.nB + i, sg[:, None] * v[j])
        return D + Db.view(n2, self.nB, self.nA)

    def apply_each(self, W: torch.Tensor) -> torch.Tensor:
        """sum_pq E_pq W[pq]: (nB, nA) from W (n^2, nB, nA)."""
        pq, i, j, sg = self._tables["a"]
        sg = sg.to(W.dtype)
        Wt = W.transpose(1, 2)                      # (n^2, nA, nB)
        out_a = torch.zeros(self.nA, self.nB, dtype=W.dtype,
                            device=W.device)
        out_a.index_add_(0, i, sg[:, None] * Wt[pq, j])
        pq, i, j, sg = self._tables["b"]
        sg = sg.to(W.dtype)
        out_b = torch.zeros(self.nB, self.nA, dtype=W.dtype,
                            device=W.device)
        out_b.index_add_(0, i, sg[:, None] * W[pq, j])
        return out_a.T + out_b

    def sigma(self, v: torch.Tensor, h: torch.Tensor,
              eri: torch.Tensor) -> torch.Tensor:
        """H v for the active integrals h (n, n) and chemist eri (n^4)."""
        n = self.n
        D = self.apply_all(v)
        h1 = h - 0.5 * torch.einsum("prrq->pq", eri)
        W = (0.5 * eri.reshape(n * n, n * n)) @ D.reshape(n * n, -1)
        W = W.reshape(D.shape) + h1.reshape(-1, 1, 1) * v
        return self.apply_each(W)

    def rdm12(self, v: torch.Tensor):
        """(gamma, P) of the normalized v: the spin-summed 1-RDM
        gamma_pq = <E_pq> and P_pqrs = <E_pq E_rs> = (E_qp v) . (E_rs v),
        so that <H> = sum h'_pq gamma_pq + 1/2 sum (pq|rs) P_pqrs."""
        n = self.n
        v = v / torch.linalg.vector_norm(v)
        D = self.apply_all(v).reshape(n * n, -1)
        gamma = (D @ v.reshape(-1)).reshape(n, n)
        P = (D @ D.T).reshape(n, n, n, n).transpose(0, 1)
        return gamma, P
