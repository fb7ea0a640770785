"""Projected-gradient optimization over partial unitaries (Stiefel manifold).

Port of esoo_tpu/orbital_optimization/stiefel.py: projected gradient
descent with alternating Barzilai-Borwein step sizes
(https://epubs.siam.org/doi/10.1137/16M1098759) and the EMA stopping
criterion  S_t = (1 - d)*|dE_t| + d*S_{t-1}.

The JAX package runs the loop as one `lax.while_loop` on the device.  In
eager PyTorch it is a Python loop: every stop test reads S on the host
(one device-to-host sync per iteration).  The arithmetic is the JAX
loop's, step for step.  Each pass of the loop body, with the stop test
that follows it, is a `bb.iter` span (utils/profiling.py; counted in a
running solve's stage_stats as bb_iterations).

`PartialUnitaryProjectionOptimizer` is the reference's constructor
surface (partial_unitary_projection_optimizer.py:15-48) over that loop:
the objective and its data live on the optimizer's `device`, and the
per-iteration callback contract `callback(iteration, energy)` (ref
:29-30) is kept by replaying the recorded energy trace after the loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..utils.config import resolve_device, same_device
from ..utils.profiling import span


def orth(V: torch.Tensor) -> torch.Tensor:
    """Project onto the Stiefel manifold: the orthogonal polar factor.

    orth(V) = V Q diag(lam^-1/2) Q^T with (lam, Q) = eigh(V^T V).  The
    n x n eigendecomposition is tiny (active-space sized).

    A float32 V is projected in float64 and rounded once: the Gram
    matrix squares V's condition number, and a float32 eigh of it leaves
    U^T U off the identity by ~eps32 cond(V)^2, 3e-2 after a long BB step
    at m = 112 (tests/test_torch_orth_float32.py).  A float64 V is
    projected in its own precision."""
    W = V.double() if V.dtype == torch.float32 else V
    lam, Q = torch.linalg.eigh(W.T @ W)
    lam = torch.clamp_min(lam, 1e-14)
    return (W @ (Q * torch.rsqrt(lam)) @ Q.T).to(V.dtype)


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
    go = k <= maxiter and bool(S > tol)
    while go:
        with span("bb.iter", count="bb_iterations"):
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
            go = k <= maxiter and bool(S > tol)
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


@dataclasses.dataclass
class StiefelOptResult:
    partial_unitary: np.ndarray
    energy: float
    iterations: int
    converged: bool
    final_S: float
    energy_trace: np.ndarray        # energies of iterates 0..iterations


class PartialUnitaryProjectionOptimizer:
    """The BB/Stiefel descent behind the reference's constructor
    (partial_unitary_projection_optimizer.py:15-48).

    `device` places the loop ("cuda" by default; "cpu" runs on the host;
    accepted and ignored in the JAX package).  Gradients are autograd's
    unless `gradient_method='finite_difference'`, a central-difference
    debug mode that cross-checks the autograd path.
    """

    def __init__(self,
                 initial_BBstepsize: float = 1e-3,
                 stopping_tolerance: float = 1e-5,
                 maxiter: int = 10000,
                 callback: Optional[Callable] = None,
                 decay_factor: float = 0.8,
                 gradient_method: Optional[str] = "autograd",
                 device="cuda"):
        self.callback = callback
        self.stopping_tolerance = stopping_tolerance
        self.maxiter = maxiter
        self.BBstepsize = initial_BBstepsize
        self.decay_factor = decay_factor
        self.gradient_method = gradient_method
        self.device = resolve_device(device)
        self.last_result: Optional[StiefelOptResult] = None
        self._vag_cache: dict = {}

    def _vag_for(self, fun: Callable) -> Callable:
        """value-and-grad of `fun`, cached by objective identity (the
        entry keeps `fun` alive so its id() is never reused)."""
        key = (id(fun), self.gradient_method)
        hit = self._vag_cache.get(key)
        if hit is None:
            if self.gradient_method == "finite_difference":
                vag = _finite_difference_vag(fun)
            else:
                vag = value_and_grad(fun)
            self._vag_cache[key] = (vag, fun)
            return vag
        return hit[0]

    def _on_device(self, x, dtype=None) -> torch.Tensor:
        """A tensor on this optimizer's device: NumPy input is uploaded, a
        tensor on another device raises (no silent copy)."""
        if torch.is_tensor(x):
            if not same_device(x.device, self.device):
                raise ValueError(
                    f"PartialUnitaryProjectionOptimizer runs on "
                    f"{self.device} but got a tensor on {x.device}")
            return x if dtype is None else x.to(dtype)
        t = torch.as_tensor(np.asarray(x), device=self.device)
        return t if dtype is None else t.to(dtype)

    def compute_optimal_rotation(self, fun: Callable,
                                 initial_partial_unitary,
                                 *data) -> Tuple[torch.Tensor, float]:
        """Minimize `fun(U, *data)` over partial unitaries from the
        initial U.  `fun` must be differentiable by autograd; `data`
        (RDMs, integral tensors, ...) are tensors on the optimizer's
        device or arrays to upload there.  Returns (U_opt on the device,
        E_opt), the reference's result tuple (:161)."""
        vag_fn = self._vag_for(fun)
        data = tuple(self._on_device(d) for d in data)
        U0 = self._on_device(initial_partial_unitary)
        real = next((d.real.dtype if d.is_complex() else d.dtype
                     for d in data if d.is_floating_point()
                     or d.is_complex()), U0.dtype)
        U0 = U0.to(real)

        def scalar(v):
            return torch.tensor(v, dtype=real, device=self.device)

        U, E, k, S, tr = _bb_projected_descent(
            vag_fn, U0, data, scalar(self.BBstepsize),
            scalar(self.stopping_tolerance), scalar(self.decay_factor),
            int(self.maxiter))
        trace = tr.detach().cpu().numpy()[: k + 1]
        if self.callback is not None:
            for it, e in enumerate(trace):
                self.callback(it, float(e))
        S = float(S)
        self.last_result = StiefelOptResult(
            partial_unitary=U.detach().cpu().numpy(), energy=float(E),
            iterations=int(k), converged=bool(S <= self.stopping_tolerance),
            final_S=S, energy_trace=trace)
        return U, float(E)


def _finite_difference_vag(energy_fn: Callable, eps: float = 1e-6):
    """Central finite-difference value-and-grad (debug mode, ref
    :105-127): all 2 * U.numel() shifted energies of one call."""
    def vag(U, *data):
        with torch.no_grad():
            E = energy_fn(U, *data)
            eye = torch.eye(U.numel(), dtype=U.dtype,
                            device=U.device).reshape((-1,) + U.shape)
            grad = torch.stack([
                (energy_fn(U + eps * d, *data)
                 - energy_fn(U - eps * d, *data)) / (2.0 * eps)
                for d in eye]).reshape(U.shape)
        return E, grad

    return vag
