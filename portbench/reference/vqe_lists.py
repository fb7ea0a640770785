"""The check of a UCCSD-VQE request in a sector past the reach of vqe.py:
the same readings, with the UCCSD state built from each excitation's list
of nonzeros instead of a dense generator.

vqe.py holds every G_k = T_k - T_k^+ as a dense (K, nd, nd) tensor, which
at 360 excitations over 4,900 determinants (UCCSD(8, (4, 4))) is 69 GB.
Here T_k is the list of its nonzeros over the sector's determinants,
T_k |c> = s |r> (ucc._apply), so that G_k x is one gather and one
index_add_: (G_k x)[r] += s x[c] and (G_k x)[c] -= s x[r].  The state is
ucc.state's product, exp(theta_k G_k) = 1 + sin(theta_k) G_k
+ (1 - cos(theta_k)) G_k^2 from the Hartree-Fock determinant, the first
excitation applied first, with G_k x and G_k (G_k x) each taken from the
list.

The optimum search (optimum_gap_ha, theta_excess_ha) is vqe.py's f64
L-BFGS from the returned theta with a budget of its own (Check.max_iter
iterations): an evaluation here launches some ten small operations a gate
each way, thousands at 360 gates, so vqe.py's 500 iterations would hold
the check of a 51-s run (~25 requests) for many minutes on an H100.  From
the float32 program's theta at H8 -> 16, 20 iterations end within 5e-12
Ha of 500 (PERF.md section 2).
"""

from __future__ import annotations

import torch

from . import ucc, vqe
from .sector import Sector


def excitation_lists(sector: Sector) -> list:
    """[(dst, src, sign)] an excitation, on the sector's device: the
    nonzeros of G_k as G_k x = zeros.index_add_(0, dst, sign * x[src]),
    i.e. (r <- c, +s) and (c <- r, -s) for each T_k |c> = s |r>."""
    dets = sector.determinants().tolist()
    index = {d: i for i, d in enumerate(dets)}
    out = []
    for occ, vir in ucc.excitations(sector.n, sector.na, sector.nb):
        rows, cols, signs = [], [], []
        for c, d in enumerate(dets):
            hit = ucc._apply(d, occ, vir)
            if hit is not None:
                rows.append(index[hit[0]])
                cols.append(c)
                signs.append(hit[1])
        dst = torch.tensor(rows + cols, device=sector.device)
        src = torch.tensor(cols + rows, device=sector.device)
        sign = torch.tensor(signs + [-s for s in signs],
                            dtype=torch.float64, device=sector.device)
        out.append((dst, src, sign))
    return out


def _apply_generator(x: torch.Tensor, dst, src, sign) -> torch.Tensor:
    """G_k x from G_k's list."""
    return torch.zeros_like(x).index_add_(0, dst,
                                          sign * x.index_select(0, src))


def state(sector: Sector, lists: list, theta: torch.Tensor):
    """The UCCSD state at theta as an (nB, nA) matrix (ucc.state)."""
    psi = torch.zeros(sector.dim, dtype=torch.float64, device=sector.device)
    b, a = sector.hf_index()
    psi[b * sector.nA + a] = 1.0
    sines = torch.sin(theta).unbind()
    versines = (1 - torch.cos(theta)).unbind()
    for (dst, src, sign), s, c in zip(lists, sines, versines):
        x = _apply_generator(psi, dst, src, sign)
        psi = psi + s * x + c * _apply_generator(x, dst, src, sign)
    return psi.reshape(sector.nB, sector.nA)


class Check(vqe.Check):
    """vqe.Check's readings over excitation lists (no dense generators)."""

    max_iter = 20           # L-BFGS iterations of the optimum search

    def __init__(self, inputs: dict, n_active: int, device):
        na, nb = inputs["num_particles"]
        self.device = torch.device(device)
        self.h = torch.as_tensor(inputs["h"], device=self.device)
        self.eri = torch.as_tensor(inputs["eri"], device=self.device)
        self.sector = Sector(n_active, na, nb, self.device)
        self.lists = excitation_lists(self.sector)

    def _energy(self, theta, h1, g):
        psi = state(self.sector, self.lists, theta)
        return (psi * self.sector.sigma(psi, h1, g)).sum(), psi

    def _minimum(self, theta0, h1, g) -> float:
        """min_theta E(theta) at float64, from theta0, within the budget."""
        theta = theta0.clone().requires_grad_(True)
        opt = torch.optim.LBFGS([theta], lr=1, max_iter=self.max_iter,
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
