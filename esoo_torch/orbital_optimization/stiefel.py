"""Projected-gradient optimization over partial unitaries (Stiefel manifold).

Port of esoo_tpu/orbital_optimization/stiefel.py: projected gradient
descent with alternating Barzilai-Borwein step sizes
(https://epubs.siam.org/doi/10.1137/16M1098759) and the EMA stopping
criterion  S_t = (1 - d)*|dE_t| + d*S_{t-1}.

The JAX package runs the loop as one `lax.while_loop` on the device.  In
eager PyTorch it is a Python loop: every stop test reads S on the host
(one device-to-host sync per iteration).  The arithmetic is the JAX
loop's, step for step.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch


def orth(V: torch.Tensor) -> torch.Tensor:
    """Project onto the Stiefel manifold: the orthogonal polar factor.

    orth(V) = V Q diag(lam^-1/2) Q^T with (lam, Q) = eigh(V^T V).  The
    n x n eigendecomposition is tiny (active-space sized)."""
    lam, Q = torch.linalg.eigh(V.T @ V)
    lam = torch.clamp_min(lam, 1e-14)
    return V @ (Q * torch.rsqrt(lam)) @ Q.T


def value_and_grad(fun: Callable) -> Callable:
    """vag(x, *args) -> (fun(x, *args), d fun / d x), both detached."""
    def vag(x, *args):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = fun(xg, *args)
            (g,) = torch.autograd.grad(f, xg)
        return f.detach(), g
    return vag


def _bb_loop(vag_fn: Callable, U0: torch.Tensor, data: tuple,
             stepsize: torch.Tensor, tol: torch.Tensor,
             decay: torch.Tensor, maxiter: int
             ) -> Tuple[torch.Tensor, int, torch.Tensor, List[torch.Tensor]]:
    """The BB projected-descent loop shared by `_bb_projected_descent`
    and fused._inner_bb.  Returns (U, k, S, energies of iterates
    0..k-1).  k starts at 1; the loop runs while S > tol and
    k <= maxiter; odd k take the BB1 step uu/(ug+eps), even k BB2
    ug/(gg+eps)."""
    dtype = U0.dtype
    U0 = orth(U0)
    E0, G0 = vag_fn(U0, *data)
    U = orth(U0 - stepsize * G0)
    U_prev, G_prev, E_prev = U0, G0, E0
    S = 1.5 * tol
    eps = torch.tensor(1e-30, dtype=dtype, device=U0.device)
    trace = [E0]
    k = 1
    while k <= maxiter and bool(S > tol):
        E, G = vag_fn(U, *data)
        trace.append(E)
        S = (1.0 - decay) * torch.abs(E - E_prev) + decay * S
        dU = U - U_prev
        dG = G - G_prev
        uu = torch.sum(dU * dU)
        ug = torch.abs(torch.sum(dU * dG))
        gg = torch.sum(dG * dG)
        tau = uu / (ug + eps) if k % 2 == 1 else ug / (gg + eps)
        U_prev, G_prev, E_prev = U, G, E
        U = orth(U - tau * G)
        k += 1
    return U, k, S, trace


def _bb_projected_descent(vag_fn: Callable, U0: torch.Tensor, data: tuple,
                          initial_stepsize: torch.Tensor,
                          stopping_tolerance: torch.Tensor,
                          decay_factor: torch.Tensor, maxiter: int):
    """BB projected gradient descent from U0 (esoo_tpu stiefel.py:59).

    vag_fn(U, *data) -> (energy, grad_U).  Returns
    (U_opt, E_opt, iterations, S_final, energy trace of iterates
    0..iterations)."""
    U, k, S, trace = _bb_loop(vag_fn, U0, data, initial_stepsize,
                              stopping_tolerance, decay_factor, maxiter)
    E_final, _ = vag_fn(U, *data)      # the final iterate's energy
    trace.append(E_final)
    return U, E_final, k, S, torch.stack(trace)
