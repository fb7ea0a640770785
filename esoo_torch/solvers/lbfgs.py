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

The CUDA-graph route.  A caller marks a cost capture-safe (its value and
gradient queue device work only: no host read, no host-to-device copy)
by handing `lbfgs_minimize` an `LBFGSGraphs` of it.  Where x0 is then on
a CUDA device, the solve replays two graphs that the holder captured
once, at its first solve, instead of queueing each launch from Python:

  trial   one line-search trial: x + t d, the value and gradient there,
          the Armijo flag, and the next t of the quadratic model;
  update  the curvature pair and the five stop flags of an iteration,
          the pair stored in slot k mod m under where(good, ...) with k
          on the device, then the next direction: the two-loop over all
          m slots with device-side slot indices, the empty ones masked
          off, the descent test and the k == 0 normalization as where.

Each replay is followed by one read of its flags, the sync the eager
loop makes anyway; the branches, `it`, `nfev` and the stop decision stay
on the host.  The arithmetic is the eager loop's, expression for
expression, so the trajectory is the same bits.  The holder keeps the
graphs and their static buffers (x, the direction, the pairs, a copy of
the cost's tensor arguments, which each solve refreshes) while it lives;
a solve with other shapes or constants captures anew.  The first capture
on a device runs the trial once eagerly before it (the per-thread state a
capture cannot make: `_WARM`).  Every other call (a CPU x0, no holder)
runs the eager loop above.  Evaluations are counted by route in
stage_stats, lbfgs_graph_evals and lbfgs_eager_evals, and the captures
in an `lbfgs.capture` span (lbfgs_capture_s, lbfgs_captures).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils import _pytree

from ..ops import _build
from ..orbital_optimization.stiefel import value_and_grad
from ..utils.profiling import count, span


def _eval_span(route: str = "eager"):
    """An evaluation's span, the evaluation counted by route."""
    count(f"lbfgs_{route}_evals")
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
                   plateau_patience: int = _PLATEAU_PATIENCE,
                   graphs: "LBFGSGraphs" = None) -> LBFGSResult:
    """L-BFGS minimization of fun(x, *args) from x0 (autograd gradients).
    `graphs`, an LBFGSGraphs of `fun`, marks the cost capture-safe: the
    solve then takes the CUDA-graph route where `graph_route` holds."""
    if graphs is not None and graph_route(x0):
        return graphs.minimize(x0, args, maxiter=maxiter, gtol=gtol,
                               memory=memory, max_backtracks=max_backtracks,
                               armijo_c1=armijo_c1, ftol=ftol,
                               plateau_patience=plateau_patience)
    state = lbfgs_init(fun, x0, args=args, gtol=gtol, memory=memory)
    state = lbfgs_advance(fun, state, args=args, num_steps=maxiter,
                          maxiter=maxiter, gtol=gtol,
                          max_backtracks=max_backtracks,
                          armijo_c1=armijo_c1, ftol=ftol,
                          plateau_patience=plateau_patience)
    return LBFGSResult(x=state.x, fun=state.f, nit=state.it,
                       nfev=state.nfev,
                       grad_norm=torch.max(torch.abs(state.g)))


# -- the CUDA-graph route -----------------------------------------------------

def graph_route(x0: torch.Tensor) -> bool:
    """Whether a solve of a capture-safe cost from x0 replays graphs: on a
    CUDA device (a mesh's costs are never marked)."""
    return x0.is_cuda


def _two_loop_masked(g, S, Y, rho, k: torch.Tensor, eps):
    """_two_loop with the pair count k a tensor: all m slots visited
    newest to oldest through device-side slot indices, a slot past the
    k stored pairs leaving q and r as they are (torch.where), so that the
    result is _two_loop's, bit for bit, with no host read of k."""
    m = S.shape[0]
    i = torch.arange(m, device=k.device)
    slots = torch.remainder(k - 1 - i, m)      # the i-th newest pair's slot
    live = i < k
    Sk, Yk = S.index_select(0, slots), Y.index_select(0, slots)
    rk = rho.index_select(0, slots)
    q = g
    alphas = [None] * m
    for i in range(m):
        a = rk[i] * torch.dot(Sk[i], q)
        q = torch.where(live[i], q - a * Yk[i], q)
        alphas[i] = a
    sy = torch.dot(Sk[0], Yk[0])
    yy = torch.dot(Yk[0], Yk[0])
    r = torch.where(k > 0, (sy / (yy + eps)) * q, 1.0 * q)
    for i in reversed(range(m)):
        b = rk[i] * torch.dot(Yk[i], r)
        r = torch.where(live[i], r + (alphas[i] - b) * Sk[i], r)
    return r


def _direction(g, S, Y, rho, k: torch.Tensor, eps):
    """lbfgs_advance's search direction with k a tensor: -H g, steepest
    descent where that is no descent direction, and the first direction
    (k == 0) normalized to unit inf-norm, each branch a torch.where."""
    d = -_two_loop_masked(g, S, Y, rho, k, eps)
    d = torch.where(torch.dot(g, d) < 0, d, -g)
    return torch.where(
        k == 0, d * (1.0 / torch.clamp_min(torch.max(torch.abs(d)), 1.0)), d)


def _store_pair(S, Y, rho, k: torch.Tensor, s, y, sy, good, eps) -> None:
    """lbfgs_advance's `if good:` store with k a tensor: s, y and
    1 / (s.y + eps) into slot k mod m where `good`, the slot's old values
    kept elsewhere, and k advanced by `good`."""
    slot = torch.remainder(k, S.shape[0]).reshape(1)
    for buf, new in ((S, s), (Y, y), (rho, 1.0 / (sy + eps))):
        old = buf.index_select(0, slot)[0]
        buf.index_copy_(0, slot, torch.where(good, new, old).unsqueeze(0))
    k.add_(good.to(k.dtype))


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every capture on `device` runs on (capture needs
    one other than the current stream)."""
    return torch.cuda.Stream(device)


# the devices where a capture has run: the first capture on a device runs
# its function once on the capture stream first, so that the state each
# thread makes at its first use of a device (the autograd engine's
# thread's cuBLAS handle above all, whose creation a capture refuses)
# exists before any capture
_WARM: set = set()


class _Step:
    """A function of static buffers run as one CUDA graph: captured at
    construction (its launches recorded for ops.launch_counts) and
    replayed at each call.  Off CUDA (where a test forces the route) the
    function runs as a plain call.  Either way a call returns the
    function's outputs: on the card the same tensors at every replay.

    cuBLAS keeps a workspace per handle and stream.  The workspaces are
    dropped before and after each capture (as torch's own CUDA-graph
    trees do), so that the capture allocates the ones it uses in the
    graph's private pool, where they live and die with the graph, and no
    workspace of the capture stream stays allocated beside the eager
    streams' own."""

    def __init__(self, fn, device: torch.device):
        self.fn, self.graph = fn, None
        if device.type != "cuda":
            return
        self.graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            if device not in _WARM:
                fn()
                _WARM.add(device)
            torch._C._cuda_clearCublasWorkspaces()
            with _build.recording() as rec:
                self.graph.capture_begin()
                try:
                    self.out = fn()
                finally:
                    self.graph.capture_end()
            torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.launches = rec

    def __call__(self):
        if self.graph is None:
            self.out = self.fn()
        else:
            self.graph.replay()
            _build.credit(self.launches)
        return self.out


class LBFGSGraphs:
    """The CUDA-graph route of lbfgs_minimize for one capture-safe cost
    `fun` (see the module docstring).  The graphs are captured at the
    first solve and reused by every later solve of the same shapes and
    constants; they and their memory are freed with the holder."""

    def __init__(self, fun):
        self.fun = fun
        self._key = None

    def _capture(self, key, x0, args, memory, armijo_c1, gtol, ftol_v):
        """Static buffers and the trial and update steps for `key`."""
        self._key = self._trial = self._update = None   # free the old
        dtype, device = x0.dtype, x0.device
        P = x0.shape[0]

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        x, g, d = zeros(P), zeros(P), zeros(P)
        f, gd, t = zeros(), zeros(), zeros()
        S, Y, rho = zeros(memory, P), zeros(memory, P), zeros(memory)
        k = zeros(dt=torch.int64)
        eps = torch.full((), 1e-30, dtype=dtype, device=device)
        leaves, spec = _pytree.tree_flatten(args)
        static = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in leaves]
        vag = value_and_grad(self.fun)
        fargs = _pytree.tree_unflatten(static, spec)

        def trial_fn():
            # _line_search's body, its branches as torch.where
            xt = x + t * d
            ft, gt = vag(xt, *fargs)
            ok = ft <= f + armijo_c1 * t * gd
            denom = 2.0 * (ft - f - t * gd)
            pos = denom > 0
            t_q = -gd * t * t / torch.where(pos, denom, 1.0)
            t.copy_(torch.where(torch.isfinite(ft) & pos,
                                torch.clamp(t_q, min=0.1 * t, max=0.5 * t),
                                0.1 * t))
            return xt, ft, gt, ok

        def update_fn():
            # lbfgs_advance's body after the search, then the next
            # iteration's direction ahead of its search (the trial step
            # read through the local name, not self: a cycle through the
            # holder would leave its graphs to the garbage collector, whose
            # destruction of them inside a later capture breaks that one)
            x_new, f_new, g_new, _ = trial.out
            s = x_new - x
            y = g_new - g
            sy = torch.dot(s, y)
            small = (f - f_new) <= ftol_v * torch.clamp_min(
                torch.maximum(torch.abs(f), torch.abs(f_new)), 1.0)
            flags = torch.stack([
                sy > 1e-10, small, torch.max(torch.abs(g_new)) <= gtol,
                torch.isfinite(f_new), torch.max(torch.abs(s)) <= 0.0])
            _store_pair(S, Y, rho, k, s, y, sy, flags[0], eps)
            x.copy_(x_new)
            f.copy_(f_new)
            g.copy_(g_new)
            d.copy_(_direction(g, S, Y, rho, k, eps))
            gd.copy_(torch.dot(g, d))
            t.fill_(1.0)
            return flags

        self._bufs = (x, f, g, d, t, S, Y, rho, k)
        self._static = static
        with span("lbfgs.capture", "lbfgs_capture_s", "lbfgs_captures"):
            trial = _Step(trial_fn, device)
            self._trial, self._update = trial, _Step(update_fn, device)
        self._key = key

    def minimize(self, x0: torch.Tensor, args=(), maxiter: int = 200,
                 gtol: float = 1e-8, memory: int = 10,
                 max_backtracks: int = 25, armijo_c1: float = 1e-4,
                 ftol: float = None,
                 plateau_patience: int = _PLATEAU_PATIENCE) -> LBFGSResult:
        """lbfgs_minimize's solve, replayed: the same result, bit for
        bit."""
        ftol_v = default_ftol(x0.dtype) if ftol is None else ftol
        leaves, spec = _pytree.tree_flatten(args)
        key = (tuple(x0.shape), x0.dtype, x0.device, memory, armijo_c1,
               gtol, ftol_v, spec,
               tuple((tuple(a.shape), a.dtype, a.device)
                     if isinstance(a, torch.Tensor) else a for a in leaves))
        if key != self._key:
            self._capture(key, x0, args, memory, armijo_c1, gtol, ftol_v)
        for dst, src in zip(self._static, leaves):
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
        x, f, g, d, t, S, Y, rho, k = self._bufs
        trial, update = self._trial, self._update
        # the first evaluation: a trial at x0 itself (t = 0, d = 0) and an
        # update from g = 0 over empty slots, which stores no pair (s = 0)
        # and leaves the first direction; converged is lbfgs_init's test
        x.copy_(x0)
        for buf in (d, t, g, S, Y, rho, k):
            buf.zero_()
        with _eval_span("graph"):
            trial()
            done = bool(update()[2])
        it, nfev, plateau = 0, 1, 0
        while not done and it < maxiter:
            n, accepted = 0, False
            while n < max_backtracks:
                with _eval_span("graph"):
                    accepted = bool(trial()[3])
                    n += 1
                if accepted:
                    break
            if not accepted:          # an exhausted search keeps x, f, g
                xt, ft, gt, _ = trial.out
                xt.copy_(x)
                ft.copy_(f)
                gt.copy_(g)
            good, small, converged, finite, no_move = update().tolist()
            plateau = 0 if (accepted and not small) else plateau + 1
            done = (converged or not finite or it + 1 >= maxiter or no_move
                    or plateau >= plateau_patience)
            it += 1
            nfev += n
        return LBFGSResult(x=x.clone(), fun=f.clone(), nit=it, nfev=nfev,
                           grad_norm=torch.max(torch.abs(g)))
