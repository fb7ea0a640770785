"""Direct reduced-density-matrix extraction from statevectors.

Port of esoo_tpu/sim/rdm.py.  The RDMs come from annihilated states

    Phi[p]      = a_p |psi>                    (N x 2^n)
    B[(r<s)]    = a_s a_r |psi>                (N(N-1)/2 x 2^n)

and two matrix products:

    gamma[p,q]        = (Phi* Phi^T)[p,q]       =  <a+_p a_q>
    C[(p,q),(r,s)]    = (B* B^T)                =  <a+_p a+_q a_s a_r>, p<q, r<s

followed by the antisymmetric unpacking Gamma = T C T^T.  PyTorch has no
popcount, so each annihilation is a gather through a source-index table
and a product with a sign table (zero where the mode is empty), both
built once per (N, 2^n, dtype, device) on the host; a pair's two
annihilations are one gather.  The products are plain torch.matmul, as
they are XLA dots outside Pallas in the JAX package.  Every function
takes leading batch axes on the state.

Fermionic convention: JW little-endian, a_p |b> =
  delta(b_p = 1) * (-1)^{popcount(b & (2^p - 1))} |b ^ 2^p>.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .strings import _bitcount


def _sign_below(idx: np.ndarray, p: int) -> np.ndarray:
    return 1 - 2 * (_bitcount(idx & ((1 << p) - 1)) & 1)


def annihilate(state: torch.Tensor, p: int) -> torch.Tensor:
    """Apply a_p to a statevector."""
    src, sign = _annihilation_tables(1, state.shape[-1], p)
    src, sign = _on(src, sign, state)
    return state[..., src[0]] * sign[0]


@lru_cache(maxsize=None)
def _annihilation_tables(num_modes: int, dim: int, first: int = 0):
    """(src, sign) (num_modes, dim) host tables of a_p for p = first ..
    first + num_modes - 1: (a_p psi)[c] = sign[p, c] * psi[src[p, c]]."""
    idx = np.arange(dim, dtype=np.int64)
    src = np.empty((num_modes, dim), dtype=np.int64)
    sign = np.empty((num_modes, dim), dtype=np.float64)
    for k in range(num_modes):
        p = first + k
        bit = 1 << p
        src[k] = idx | bit
        sign[k] = np.where((idx & bit) == 0, _sign_below(idx, p), 0)
    return src, sign


@lru_cache(maxsize=None)
def _pair_tables(num_modes: int, dim: int):
    """(src, sign) (P, dim) host tables of a_s a_r for the pairs r < s:
    (a_s a_r psi)[c] = sign * psi[c | 2^r | 2^s], zero unless bits r and
    s of c are clear."""
    idx = np.arange(dim, dtype=np.int64)
    pairs = _pair_indices(num_modes)
    src = np.empty((len(pairs), dim), dtype=np.int64)
    sign = np.empty((len(pairs), dim), dtype=np.float64)
    for k, (r, s) in enumerate(pairs):
        both = (1 << r) | (1 << s)
        src[k] = idx | both
        sign[k] = np.where((idx & both) == 0,
                           _sign_below(idx, s) * _sign_below(idx, r), 0)
    return src, sign


_device_tables: dict = {}


def _on(src: np.ndarray, sign: np.ndarray, state: torch.Tensor):
    """The host tables as tensors on the state's device (sign at its
    dtype), cached."""
    key = (id(src), state.dtype, str(state.device))
    hit = _device_tables.get(key)
    if hit is None:
        hit = (torch.as_tensor(src, device=state.device),
               torch.as_tensor(sign, device=state.device).to(state.dtype))
        _device_tables[key] = hit
    return hit


def annihilation_states(state: torch.Tensor, num_modes: int
                        ) -> torch.Tensor:
    """Phi[p] = a_p |state> for p = 0..num_modes-1, shape (..., N, dim)."""
    src, sign = _on(*_annihilation_tables(num_modes, state.shape[-1]), state)
    return state[..., src] * sign


@lru_cache(maxsize=None)
def _pair_indices(num_modes: int):
    pairs = [(r, s) for r in range(num_modes) for s in range(num_modes) if r < s]
    return np.array(pairs, dtype=np.int64)


@lru_cache(maxsize=None)
def pair_unpack_matrix(num_modes: int) -> np.ndarray:
    """T[(p*N+q), k] with +1 for (p<q) pairs and -1 for the swapped entry.

    Unpacks packed pair-indexed matrices to the full antisymmetric tensor:
      Gamma.reshape(N^2, N^2) = T @ C @ T.T
    """
    N = num_modes
    pairs = _pair_indices(N)
    P = len(pairs)
    T = np.zeros((N * N, P))
    for k, (r, s) in enumerate(pairs):
        T[r * N + s, k] = 1.0
        T[s * N + r, k] = -1.0
    return T


def pair_annihilation_states(state: torch.Tensor, num_modes: int
                             ) -> torch.Tensor:
    """B[k] = a_s a_r |state> for the k-th pair (r<s), shape (..., P, dim)."""
    src, sign = _on(*_pair_tables(num_modes, state.shape[-1]), state)
    return state[..., src] * sign


def _gram(B: torch.Tensor) -> torch.Tensor:
    return torch.conj(B) @ B.transpose(-1, -2)


def _unpack(num_modes: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(pair_unpack_matrix(num_modes),
                           device=like.device).to(like.dtype)


def one_rdm(state: torch.Tensor, num_modes: int) -> torch.Tensor:
    """gamma[p,q] = <psi| a+_p a_q |psi>."""
    return _gram(annihilation_states(state, num_modes))


def two_rdm(state: torch.Tensor, num_modes: int) -> torch.Tensor:
    """Gamma[p,q,r,s] = <psi| a+_p a+_q a_s a_r |psi>."""
    N = num_modes
    C = _gram(pair_annihilation_states(state, N))
    T = _unpack(N, C)
    full = T @ C @ T.T
    return full.reshape(C.shape[:-2] + (N, N, N, N))


def rdm_energy(state: torch.Tensor, h: torch.Tensor, g: torch.Tensor
               ) -> torch.Tensor:
    """E = sum h*gamma + sum g*Gamma, computed without materializing Gamma.

    Contracts the packed pair matrix against the pair-packed g tensor:
      E2 = sum_{(p<q),(r<s)} [g_pqrs - g_qprs - g_pqsr + g_qpsr] * C[(pq),(rs)]
    """
    N = h.shape[0]
    gamma = one_rdm(state, N)
    C = _gram(pair_annihilation_states(state, N))
    T = _unpack(N, C)
    g_packed = T.T @ g.reshape(N * N, N * N).to(C.dtype) @ T
    e1 = torch.sum(h.to(C.dtype) * gamma, dim=(-2, -1))
    e2 = torch.sum(g_packed * C, dim=(-2, -1))
    e = e1 + e2
    return e.real if e.is_complex() else e
