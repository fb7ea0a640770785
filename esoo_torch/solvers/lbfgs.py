"""L-BFGS (two-loop recursion, interpolating Armijo backtracking).

Port of esoo_tpu/solvers/lbfgs.py with the same semantics: minimizes
fun(x, *args) from x0 and stops on ||grad||_inf <= gtol, `maxiter`
iterations, an f-plateau (`ftol`, a relative-decrease test with a
consecutive-iteration patience), a non-finite f, or a stalled line search
(a fully exhausted search leaves x unchanged and the no-move test stops
the solve — at f32 the gradient-noise floor makes gtol unreachable).  The
line search is quadratic-interpolation backtracking: fit f(0), f'(0),
f(t) and jump to the model minimizer clamped to [0.1 t, 0.5 t].  Every
trial evaluates value_and_grad, so the accepted point's gradient comes
out of the search (nfev ~ nit + 1 on an accept-at-t=1 run).

The JAX package's `jnp.where` branches, which evaluate both sides on the
device, are Python control flow here with the same arithmetic; the
branch conditions are read on the host (a few syncs per iteration).
Each value-and-grad evaluation, with the host read of the flags that
follows it, is an `lbfgs.eval` span (utils/profiling.py; counted in a
running solve's stage_stats as lbfgs_evaluations).
The optimizer is resumable: `lbfgs_init` + repeated `lbfgs_advance` ==
`lbfgs_minimize`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..orbital_optimization.stiefel import value_and_grad
from ..utils.profiling import span


def _eval_span():
    return span("lbfgs.eval", count="lbfgs_evaluations")


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    nit: int
    nfev: int
    grad_norm: torch.Tensor


class LBFGSState(NamedTuple):
    """Resumable optimizer state (buffers on the device, counters on the
    host)."""
    it: int                # iterations completed
    k: int                 # curvature pairs stored (monotone counter)
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    S: torch.Tensor        # (memory, P) step buffer
    Y: torch.Tensor        # (memory, P) gradient-difference buffer
    rho: torch.Tensor      # (memory,) 1/s.y
    nfev: int
    done: bool
    plateau: int           # consecutive iterations below the ftol decrease


def default_ftol(dtype: torch.dtype) -> float:
    """Relative per-iteration decrease below which progress counts as
    noise for the plateau stop: 32 ulps at f32, DISABLED (0.0) at f64 —
    the oracle precision keeps pure gtol/maxiter semantics."""
    if torch.finfo(dtype).bits >= 64:
        return 0.0
    return 32.0 * float(torch.finfo(dtype).eps)


_PLATEAU_PATIENCE = 3


def lbfgs_init(fun, x0: torch.Tensor, args=(), gtol: float = 1e-8,
               memory: int = 10) -> LBFGSState:
    """Evaluate fun/grad at x0 and build the initial resumable state."""
    dtype, device = x0.dtype, x0.device
    P = x0.shape[0]
    with _eval_span():
        f0, g0 = value_and_grad(fun)(x0, *args)
        done = bool(torch.max(torch.abs(g0)) <= gtol)
    return LBFGSState(
        it=0, k=0, x=x0.detach(), f=f0, g=g0,
        S=torch.zeros((memory, P), dtype=dtype, device=device),
        Y=torch.zeros((memory, P), dtype=dtype, device=device),
        rho=torch.zeros((memory,), dtype=dtype, device=device),
        nfev=1, done=done, plateau=0)


def _two_loop(g, S, Y, rho, k: int, eps):
    """H_k @ g via the two-loop recursion over the valid window of the
    circular (m, P) buffers (newest -> oldest, then back)."""
    m = S.shape[0]
    n_valid = min(k, m)
    q = g
    alphas = [None] * m
    for i in range(n_valid):
        j = (k - 1 - i) % m
        a = rho[j] * torch.dot(S[j], q)
        q = q - a * Y[j]
        alphas[i] = a
    if k > 0:
        newest = (k - 1) % m
        sy = torch.dot(S[newest], Y[newest])
        yy = torch.dot(Y[newest], Y[newest])
        r = (sy / (yy + eps)) * q
    else:
        r = 1.0 * q
    for i in reversed(range(n_valid)):
        j = (k - 1 - i) % m
        b = rho[j] * torch.dot(Y[j], r)
        r = r + (alphas[i] - b) * S[j]
    return r


def _line_search(vag, args, x, f, g, d, max_backtracks: int,
                 armijo_c1: float):
    """Quadratic-interpolation backtracking Armijo from t = 1.  Returns
    (x_t, f_t, g_t, evals, accepted); an exhausted search returns x, f, g
    unchanged."""
    gd = torch.dot(g, d)
    t = torch.ones((), dtype=x.dtype, device=x.device)
    n = 0
    while n < max_backtracks:
        with _eval_span():
            xt = x + t * d
            ft, gt = vag(xt, *args)
            n += 1
            ok = ft <= f + armijo_c1 * t * gd
            # minimizer of the quadratic model q(s): q(0)=f, q'(0)=gd,
            # q(t)=ft  ->  s* = -gd t^2 / (2 (ft - f - t gd))
            denom = 2.0 * (ft - f - t * gd)
            pos = denom > 0
            flags = torch.stack([ok, pos,
                                 torch.isfinite(ft) & pos]).tolist()
        if flags[0]:
            return xt, ft, gt, n, True
        t_q = -gd * t * t / (denom if flags[1] else 1.0)
        t = (torch.clamp(t_q, min=0.1 * t, max=0.5 * t) if flags[2]
             else 0.1 * t)
    return x, f, g, n, False


def lbfgs_advance(fun, state: LBFGSState, args=(), num_steps: int = 1,
                  maxiter: int = 200, gtol: float = 1e-8,
                  max_backtracks: int = 25,
                  armijo_c1: float = 1e-4,
                  ftol: float = None,
                  plateau_patience: int = _PLATEAU_PATIENCE) -> LBFGSState:
    """Run up to `num_steps` more iterations (or until convergence /
    `maxiter` TOTAL iterations) and return the updated state.  `ftol` is
    the relative per-iteration decrease counting toward the plateau stop
    (None -> default_ftol(dtype); 0.0 disables it)."""
    vag = value_and_grad(fun)
    (it, k, x, f, g, S, Y, rho, nfev, done, plateau) = state
    S, Y, rho = S.clone(), Y.clone(), rho.clone()
    dtype = x.dtype
    m = S.shape[0]
    eps = torch.tensor(1e-30, dtype=dtype, device=x.device)
    ftol_v = default_ftol(dtype) if ftol is None else ftol
    stop_at = it + num_steps
    while not done and it < stop_at:
        d = -_two_loop(g, S, Y, rho, k, eps)
        # steepest descent if d is not a descent direction
        if not bool(torch.dot(g, d) < 0):
            d = -g
        # with no curvature pairs the raw gradient step overshoots by the
        # curvature scale: normalize the first direction to unit inf-norm
        if k == 0:
            d = d * (1.0 / torch.clamp_min(torch.max(torch.abs(d)), 1.0))
        x_new, f_new, g_new, ls_evals, accepted = _line_search(
            vag, args, x, f, g, d, max_backtracks, armijo_c1)
        s = x_new - x
        y = g_new - g
        sy = torch.dot(s, y)
        # plateau: consecutive iterations whose decrease is noise-level
        small = (f - f_new) <= ftol_v * torch.clamp_min(
            torch.maximum(torch.abs(f), torch.abs(f_new)), 1.0)
        good, small, converged, finite, no_move = torch.stack([
            sy > 1e-10,          # curvature condition: store useful pairs
            small,
            torch.max(torch.abs(g_new)) <= gtol,
            torch.isfinite(f_new),
            # an exhausted line search leaves x unchanged: stop rather
            # than burn max_backtracks evals every iteration
            torch.max(torch.abs(s)) <= 0.0,
        ]).tolist()
        if good:
            slot = k % m
            S[slot] = s
            Y[slot] = y
            rho[slot] = 1.0 / (sy + eps)
            k += 1
        plateau = 0 if (accepted and not small) else plateau + 1
        done = (converged or not finite or it + 1 >= maxiter or no_move
                or plateau >= plateau_patience)
        it += 1
        nfev += ls_evals
        x, f, g = x_new, f_new, g_new
    return LBFGSState(it, k, x, f, g, S, Y, rho, nfev, done, plateau)


def lbfgs_minimize(fun, x0: torch.Tensor, args=(), maxiter: int = 200,
                   gtol: float = 1e-8, memory: int = 10,
                   max_backtracks: int = 25,
                   armijo_c1: float = 1e-4,
                   ftol: float = None,
                   plateau_patience: int = _PLATEAU_PATIENCE) -> LBFGSResult:
    """L-BFGS minimization of fun(x, *args) from x0 (autograd gradients)."""
    state = lbfgs_init(fun, x0, args=args, gtol=gtol, memory=memory)
    state = lbfgs_advance(fun, state, args=args, num_steps=maxiter,
                          maxiter=maxiter, gtol=gtol,
                          max_backtracks=max_backtracks,
                          armijo_c1=armijo_c1, ftol=ftol,
                          plateau_patience=plateau_patience)
    return LBFGSResult(x=state.x, fun=state.f, nit=state.it,
                       nfev=state.nfev,
                       grad_norm=torch.max(torch.abs(state.g)))
