"""Integral-rotation and energy-functional kernels.

Port of esoo_tpu/orbital_optimization/kernels.py: rotating the spatial
one/two-electron integrals of the m-orbital starting basis into the
n-orbital active basis by a partial unitary u, and the energy

    E(u) = sum_pq h[p,q] (u gamma u^T)[p,q]
         + sum_pqrs g[p,q,r,s] (u (x) u (x) u (x) u  Gamma)[p,q,r,s]

evaluated in the spatial basis (the spin-block factorization of the JAX
package: one m-sized transform instead of a 2m-sized one).

`rotate_two_body` on a CUDA tensor runs the hand-written transform
(ops/gemm.py::rotate_two_body_cuda, four CUDA GEMM launches); on a CPU
tensor it runs the plain tensordot chain.  The energy path
(`rotated_energy_spatial`) stays plain PyTorch — matmul/tensordot, as the
JAX package leaves it to XLA — and its gradient comes from autograd.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import gemm


# ---------------------------------------------------------------------------
# spin-structure utilities (host, run once at ingestion)
# ---------------------------------------------------------------------------


def expand_spin(u: torch.Tensor) -> torch.Tensor:
    """Spatial (m, n) partial unitary -> spin-orbital (2m, 2n) block
    diagonal (torch.block_diag(u, u))."""
    return torch.block_diag(u, u)


def spin_blocks_consistent(h_so: np.ndarray, g_so: np.ndarray,
                           atol: float = 1e-12) -> bool:
    """True iff (h, g) have the RHF spin-block structure enabling the
    spatial fast path:

      h = blockdiag(h_sp, h_sp);
      g[p+sig*m, q+tau*m, r+sig'*m, s+tau'*m] = delta(sig,sig') delta(tau,tau') b[pqrs]
      with the same spatial b for all four (sig, tau) patterns.
    """
    M = h_so.shape[0]
    m = M // 2
    if not np.allclose(h_so[:m, :m], h_so[m:, m:], atol=atol):
        return False
    if np.abs(h_so[:m, m:]).max(initial=0.0) > atol:
        return False
    if np.abs(h_so[m:, :m]).max(initial=0.0) > atol:
        return False
    b = g_so[:m, :m, :m, :m]
    sl = [slice(0, m), slice(m, 2 * m)]
    for sig in (0, 1):
        for tau in (0, 1):
            for sigp in (0, 1):
                for taup in (0, 1):
                    blk = g_so[sl[sig], sl[tau], sl[sigp], sl[taup]]
                    if sig == sigp and tau == taup:
                        if not np.allclose(blk, b, atol=atol):
                            return False
                    elif np.abs(blk).max(initial=0.0) > atol:
                        return False
    return True


def spatial_blocks(h_so: np.ndarray, g_so: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the spatial blocks (h_sp, g_sp) from spin-orbital tensors."""
    m = h_so.shape[0] // 2
    return np.ascontiguousarray(h_so[:m, :m]), \
        np.ascontiguousarray(g_so[:m, :m, :m, :m])


def spin_reduce_rdms_complex(gamma: torch.Tensor, Gamma: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Active-space spin-summed RDMs, kept in the RDMs' own dtype:

      gamma_s[i,j]     = sum_sig gamma[i sig, j sig]
      Gamma_s[i,j,k,l] = sum_{sig,tau} Gamma[i sig, j tau, k sig, l tau]

    (block ordering: alpha 0..n-1, beta n..2n-1)."""
    N = gamma.shape[0]
    n = N // 2
    a, b = slice(0, n), slice(n, N)
    gamma_s = gamma[a, a] + gamma[b, b]
    Gamma_s = (Gamma[a, a, a, a] + Gamma[a, b, a, b]
               + Gamma[b, a, b, a] + Gamma[b, b, b, b])
    return gamma_s, Gamma_s


def spin_reduce_rdms(gamma: torch.Tensor, Gamma: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """spin_reduce_rdms_complex with the real part taken."""
    gamma_s, Gamma_s = spin_reduce_rdms_complex(gamma, Gamma)
    if gamma_s.is_complex():
        return gamma_s.real, Gamma_s.real
    return gamma_s, Gamma_s


# ---------------------------------------------------------------------------
# rotation kernels
# ---------------------------------------------------------------------------


def rotate_one_body(h: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h_rot[i,j] = sum_pq h[p,q] u[p,i] u[q,j]  =  u^T h u."""
    return u.T @ h @ u


def rotate_two_body_kron(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """4-index transform as ONE GEMM sandwich W^T G2 W with
    W = u (x) u (Kronecker, (m^2, n^2)) and G2 = g.reshape(m^2, m^2):
    O(m^4 n^2) FLOPs but a single pass over the m^4 tensor."""
    m = g.shape[0]
    n = u.shape[1]
    W = torch.einsum("pi,qj->pqij", u, u).reshape(m * m, n * n)
    G2 = g.reshape(m * m, m * m)
    return (W.T @ (G2 @ W)).reshape(n, n, n, n)


def rotate_two_body_minor(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """4-index transform contracting the MINOR axis first (stage 1 is
    g.reshape(m^3, m) @ u, reading g in layout order)."""
    t = torch.tensordot(g, u, dims=([3], [0]))      # (p, q, r, l)
    t = torch.tensordot(t, u, dims=([2], [0]))      # (p, q, l, k)
    t = torch.tensordot(t, u, dims=([1], [0]))      # (p, l, k, j)
    t = torch.tensordot(t, u, dims=([0], [0]))      # (l, k, j, i)
    return t.permute(3, 2, 1, 0)


def rotate_two_body(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """4-index transform as four staged GEMMs, contracting the leading
    axis each time:

        g_rot[i,j,k,l] = sum_pqrs g[p,q,r,s] u[p,i] u[q,j] u[r,k] u[s,l]

    O(m^4 n + m^3 n^2 + m^2 n^3 + m n^4).  CUDA tensors run the
    hand-written kernel (ops/gemm.py::rotate_two_body_cuda), which runs
    the plain tensordot chain for CPU tensors."""
    return gemm.rotate_two_body_cuda(g, u)


def rotate_two_body_auto(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Dispatch for the energy path's transform: the kron sandwich while
    n^2 <= 2m, the minor-axis staged chain beyond (the JAX package's rule,
    kept for parity; whether it is the right rule on an H100 is for
    measurement to decide)."""
    n = u.shape[1]
    m = g.shape[0]
    if n * n <= 2 * m:
        return rotate_two_body_kron(g, u)
    return rotate_two_body_minor(g, u)


# ---------------------------------------------------------------------------
# energy functionals
# ---------------------------------------------------------------------------


def rotated_energy_spatial(u: torch.Tensor,
                           gamma_s: torch.Tensor,
                           Gamma_s: torch.Tensor,
                           h_sp: torch.Tensor,
                           g_sp: torch.Tensor) -> torch.Tensor:
    """E(u) on the spatial fast path.

    Args:
        u: (m, n_active) spatial partial unitary.
        gamma_s/Gamma_s: spin-summed active-space RDMs (n, n) / (n,n,n,n).
        h_sp/g_sp: spatial blocks of the starting-basis integrals.
    """
    e1 = torch.sum(rotate_one_body(h_sp, u) * gamma_s)
    e2 = torch.sum(rotate_two_body_auto(g_sp, u) * Gamma_s)
    return e1 + e2


def rotated_energy_spatial_complex(u: torch.Tensor,
                                   gamma_s: torch.Tensor,
                                   Gamma_s: torch.Tensor,
                                   h_sp: torch.Tensor,
                                   g_sp: torch.Tensor) -> torch.Tensor:
    """E(u) with complex spin-summed RDMs kept complex through the
    contraction; the energy is the real part of E1 + E2."""
    e1 = torch.sum(rotate_one_body(h_sp, u) * gamma_s)
    e2 = torch.sum(rotate_two_body_auto(g_sp, u) * Gamma_s)
    return torch.real(e1 + e2)


def _real(t: torch.Tensor) -> torch.Tensor:
    return t.real if t.is_complex() else t


def rotated_energy_so(U_spatial: torch.Tensor,
                      gamma: torch.Tensor,
                      Gamma: torch.Tensor,
                      h_so: torch.Tensor,
                      g_so: torch.Tensor) -> torch.Tensor:
    """Oracle: the full spin-orbital contraction."""
    U = expand_spin(U_spatial)
    e1 = torch.sum(rotate_one_body(h_so, U) * _real(gamma))
    e2 = torch.sum(gemm.rotate_two_body_plain(g_so, U) * _real(Gamma))
    return e1 + e2


def rotated_energy_so_complex(U_spatial: torch.Tensor,
                              gamma: torch.Tensor,
                              Gamma: torch.Tensor,
                              h_so: torch.Tensor,
                              g_so: torch.Tensor) -> torch.Tensor:
    """Spin-orbital complex-RDM objective (real part of E1 + E2)."""
    U = expand_spin(U_spatial)
    e1 = torch.sum(rotate_one_body(h_so, U) * gamma)
    e2 = torch.sum(gemm.rotate_two_body_plain(g_so, U) * Gamma)
    return torch.real(e1 + e2)


def rotated_integrals_spatial(u: torch.Tensor, h_sp: torch.Tensor,
                              g_sp: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Active-space spatial integral tensors after rotation by u."""
    return rotate_one_body(h_sp, u), rotate_two_body(g_sp, u)


def expand_spin_tensors(h_sp: torch.Tensor, g_sp: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial (n-sized) integral tensors -> spin-orbital (2n-sized), with
    the chemistry block structure (both spins identical)."""
    n = h_sp.shape[0]
    N = 2 * n
    h = torch.zeros((N, N), dtype=h_sp.dtype, device=h_sp.device)
    h[:n, :n] = h_sp
    h[n:, n:] = h_sp
    g = torch.zeros((N, N, N, N), dtype=g_sp.dtype, device=g_sp.device)
    for sig in (0, 1):
        for tau in (0, 1):
            sp = slice(sig * n, sig * n + n)
            sq = slice(tau * n, tau * n + n)
            g[sp, sq, sp, sq] += g_sp
    return h, g


def spin_squared_from_rdms(gamma: torch.Tensor,
                           Gamma: torch.Tensor) -> torch.Tensor:
    """<S^2> from spin-orbital RDMs (gamma_pq = <a+_p a_q>,
    Gamma_pqrs = <a+_p a+_q a_s a_r>, alpha block first):
    S^2 = S_- S_+ + S_z (S_z + 1) with
    <S_- S_+> = N_beta - sum_ij Gamma[i_b, j_a, j_b, i_a]; exact for
    fixed-(n_alpha, n_beta) states."""
    n = gamma.shape[0] // 2
    n_a = torch.trace(gamma[:n, :n])
    n_b = torch.trace(gamma[n:, n:])
    sz = 0.5 * (n_a - n_b)
    cross = torch.einsum("ijji->", Gamma[n:, :n, n:, :n])
    return n_b - cross + sz * (sz + 1.0)
