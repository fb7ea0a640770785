"""Davidson eigensolver for the string-sector Hamiltonian.

Port of esoo_tpu/solvers/davidson.py: the lowest eigenpair
(`davidson_ground`) or the lowest k (`davidson_block` and its chunked
init/advance/finish form) of a symmetric operator given as a matvec and
its exact diagonal (the preconditioner, sim/strings.py `diagonal`).

The JAX package runs each search as one fixed-shape `lax.while_loop`;
here it is an eager loop with the same shapes and the same arithmetic:

  * a (max_subspace, dim) basis with zero rows for the unused slots;
  * Rayleigh-Ritz on the (m, m) projected matrix by `torch.linalg.eigh`
    on the device, the unused diagonal slots padded to max(active
    diagonal) + 1 (spectrum-relative: a finfo-max pad loses the active
    block in float32 eigh);
  * the correction r / (diag - E) with |den| < 1e-2 guarded, two
    Gram-Schmidt passes, the stagnation exit at 64 eps, the collapse to
    [x, t] (block: to the k Ritz vectors) when the basis is full, and a
    final Rayleigh-Ritz whose pair is kept if its residual is no worse.

Each stop test reads one small tensor on the host: one device-to-host
sync per iteration.  Every matvec runs under a `davidson.sigma` span
(utils/profiling.py; sigma_s, and its count davidson_matvecs, in a
running solve's stage_stats): in `davidson_ground`'s loop the span closes
at the iteration's stop test, so it holds the matvec's device work; the
first matvec's span, before the loop, and the block path's hold their
launches only.  The basis buffers are updated in place.  The block
matvec runs row by row and skips dead (zero) rows; the JAX package's
`sequential_mv` choice between a vmap over the rows (computing the
dead ones too) and a lax.map that skips them, a memory choice with the
same numbers, has no counterpart here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.profiling import span


def _sigma():
    return span("davidson.sigma", "sigma_s", "davidson_matvecs")


class DavidsonResult(NamedTuple):
    eigenvalue: torch.Tensor     # lowest Ritz value
    eigenvector: torch.Tensor    # (dim,) normalized Ritz vector
    iterations: int              # matvec count actually performed
    residual_norm: torch.Tensor  # ||H x - E x|| at exit


def _ritz_pad(G: torch.Tensor, inactive: torch.Tensor) -> torch.Tensor:
    """Set the inactive diagonal slots (zero rows of the basis) to
    max(active diagonal) + 1: above the lowest eigenvalue while keeping
    ||G|| at the spectrum's scale."""
    dG = torch.diagonal(G)
    mx = torch.max(torch.where(inactive > 0, -torch.inf, dG))
    return G + torch.diag(inactive * (mx + 1.0))


def _guard(den: torch.Tensor) -> torch.Tensor:
    """den with |den| < 1e-2 replaced by +-1e-2 (its sign kept)."""
    floor = den.new_tensor(1e-2)
    return torch.where(den.abs() < 1e-2,
                       torch.where(den < 0, -floor, floor), den)


def davidson_ground(matvec: Callable, diag: torch.Tensor, v0: torch.Tensor,
                    max_subspace: int = 16, maxiter: int = 200,
                    tol: float = 1e-8) -> DavidsonResult:
    """Lowest eigenpair of the symmetric operator `matvec` (flat vectors
    (dim,) -> (dim,)) with exact diagonal `diag`, started from `v0`.

    Convergence: ||H x - E x|| < tol * max(1, |E|).  On stagnation of the
    preconditioned correction (numerically inside the subspace) the loop
    exits with the current Ritz pair."""
    dim, dt, dev = v0.shape[0], v0.dtype, v0.device
    m = max_subspace
    eps = torch.finfo(dt).eps
    slots = torch.arange(m, device=dev)

    def ritz(B, HB, cnt):
        G = B @ HB.T
        G = (G + G.T) / 2.0
        G = _ritz_pad(G, (slots >= cnt).to(dt))
        w, Y = torch.linalg.eigh(G)
        y = Y[:, 0]
        return w[0], y @ B, y @ HB

    v0 = v0 / torch.linalg.norm(v0)
    B = torch.zeros((m, dim), dtype=dt, device=dev)
    HB = torch.zeros((m, dim), dtype=dt, device=dev)
    B[0] = v0
    with _sigma():
        HB[0] = matvec(v0)
    cnt, it = 1, 1
    x, hx = v0, HB[0].clone()
    rn = torch.tensor(torch.inf, dtype=dt, device=dev)
    while it < maxiter:
        E, x, hx = ritz(B, HB, cnt)
        r = hx - E * x
        rn = torch.linalg.norm(r)
        converged = rn < tol * torch.clamp_min(E.abs(), 1.0)
        t = r / _guard(diag - E)
        # orthogonalize against the basis (two Gram-Schmidt passes;
        # inactive rows are zero so they project out nothing)
        t = t - (B @ t) @ B
        t = t - (B @ t) @ B
        tn = torch.linalg.norm(t)
        stagnant = tn < 64 * eps
        t = t / torch.clamp_min(tn, eps)
        if cnt >= m:
            # restart: collapse to [x, t]
            xn = torch.linalg.norm(x)
            B.zero_()
            HB.zero_()
            B[0] = x / xn
            HB[0] = hx / xn
            t = t - torch.dot(B[0], t) * B[0]
            t = t / torch.clamp_min(torch.linalg.norm(t), eps)
            cnt = 1
        B[cnt] = t
        cnt += 1
        with _sigma():
            HB[cnt - 1] = matvec(t)
            it += 1
            stop = bool(converged | stagnant)
        if stop:
            break
    # final Rayleigh-Ritz so the returned pair reflects the last append
    E2, x2, hx2 = ritz(B, HB, cnt)
    rn2 = torch.linalg.norm(hx2 - E2 * x2)
    if bool(rn2 <= rn):
        E, x, rn = E2, x2, rn2
    return DavidsonResult(eigenvalue=E, eigenvector=x / torch.linalg.norm(x),
                          iterations=it, residual_norm=rn)


class BlockDavidsonResult(NamedTuple):
    eigenvalues: torch.Tensor    # (k,) lowest Ritz values, ascending
    eigenvectors: torch.Tensor   # (k, dim) orthonormal Ritz vectors
    iterations: int              # outer Davidson iterations performed
    residual_norm: torch.Tensor  # max_i ||H x_i - E_i x_i|| at exit


class BlockDavidsonState(NamedTuple):
    """The carry of a block search, threaded through the chunked
    init/advance/finish calls (the JAX package's loop carry)."""
    B: torch.Tensor              # (m, dim) basis, zero rows unused
    HB: torch.Tensor             # (m, dim) its H-image
    cnt: int                     # rows in use
    it: int                      # iterations so far (starts at 1)
    ws: torch.Tensor             # (k,) Ritz values
    X: torch.Tensor              # (k, dim) Ritz vectors
    HX: torch.Tensor
    rn: torch.Tensor             # max residual norm
    stop: bool                   # converged or stagnant


def _gs_rows(X: torch.Tensor, B: torch.Tensor, cnt: int) -> torch.Tensor:
    """Orthonormalize the rows of X against the first `cnt` rows of B and
    each other (two passes); a row whose norm falls below 256 eps becomes
    zero (dead)."""
    dt = X.dtype
    eps = torch.finfo(dt).eps
    mask = (torch.arange(B.shape[0], device=B.device) < cnt).to(dt)
    rows = []
    for i in range(X.shape[0]):
        x = X[i]
        for _ in range(2):
            x = x - ((B @ x) * mask) @ B
            for r in rows:
                x = x - torch.dot(r, x) * r
        nx = torch.linalg.norm(x)
        x = torch.where(nx > 256 * eps, x / torch.clamp_min(nx, eps),
                        torch.zeros_like(x))
        rows.append(x)
    return torch.stack(rows)


def _block_ritz(B: torch.Tensor, HB: torch.Tensor, cnt: int, k: int):
    """(ws, X, HX): the k lowest Ritz pairs.  A slot is inactive if beyond
    cnt or a dead (zero) row inside the window: dead rows would otherwise
    give spurious zero Ritz pairs."""
    dt, m = B.dtype, B.shape[0]
    G = B @ HB.T
    G = (G + G.T) / 2.0
    dead = (torch.linalg.norm(B, dim=1) < 0.5).to(dt)
    beyond = (torch.arange(m, device=B.device) >= cnt).to(dt)
    G = _ritz_pad(G, torch.maximum(beyond, dead))
    w, Y = torch.linalg.eigh(G)
    Yk = Y[:, :k].T
    return w[:k], Yk @ B, Yk @ HB


def _bmv(matvec: Callable, T: torch.Tensor, alive: list) -> torch.Tensor:
    """The matvec of each live row of T; dead rows give zero."""
    def one(row):
        with _sigma():
            return matvec(row)
    return torch.stack([one(row) if live else torch.zeros_like(row)
                        for row, live in zip(T, alive)])


def _block_step(matvec: Callable, diag: torch.Tensor,
                s: BlockDavidsonState, tol: float) -> BlockDavidsonState:
    """One block-Davidson iteration (the body of the JAX loop)."""
    B, HB, cnt, it = s.B, s.HB, s.cnt, s.it
    k, m, dt = s.ws.shape[0], B.shape[0], B.dtype
    ws, X, HX = _block_ritz(B, HB, cnt, k)
    R = HX - ws[:, None] * X
    rns = torch.linalg.norm(R, dim=1)
    rn = torch.max(rns)
    converged = rn < tol * torch.clamp_min(ws.abs().max(), 1.0)
    den = _guard(diag[None, :] - ws[:, None])
    # per-root locking: a root whose own residual is below tolerance
    # contributes no correction this iteration
    locked = rns < tol * torch.clamp_min(ws.abs(), 1.0)
    T = (R / den) * (1.0 - locked.to(dt))[:, None]
    if cnt + k > m:
        B.zero_()
        HB.zero_()
        B[:k] = X
        HB[:k] = HX
        cnt = k
    Tn = _gs_rows(T, B, cnt)
    flags = torch.cat([converged[None],
                       torch.linalg.norm(Tn, dim=1) > 0.5]).tolist()
    alive = flags[1:]
    stop = flags[0] or not any(alive)
    B[cnt:cnt + k] = Tn            # dead rows are zero: inert
    HB[cnt:cnt + k] = _bmv(matvec, Tn, alive)
    return BlockDavidsonState(B, HB, cnt + k, it + 1, ws, X, HX, rn, stop)


def davidson_block_init(matvec: Callable, diag: torch.Tensor,
                        V0: torch.Tensor, k: int, max_subspace: int = 24,
                        tol: float = 1e-8) -> BlockDavidsonState:
    """Initial carry of a block search: the rows of V0 (k, dim)
    orthonormalized, and their matvecs."""
    if max_subspace < 2 * k:
        raise ValueError(
            f"max_subspace={max_subspace} must be >= 2k={2 * k}")
    dim, dt, dev = V0.shape[1], V0.dtype, V0.device
    B = torch.zeros((max_subspace, dim), dtype=dt, device=dev)
    HB = torch.zeros_like(B)
    V0 = _gs_rows(V0, B, 0)
    alive = (torch.linalg.norm(V0, dim=1) > 0.5).tolist()
    B[:k] = V0
    HB[:k] = _bmv(matvec, V0, alive)
    return BlockDavidsonState(B, HB, k, 1, torch.zeros(k, dtype=dt,
                                                       device=dev),
                              V0, HB[:k].clone(),
                              torch.tensor(torch.inf, dtype=dt, device=dev),
                              False)


def davidson_block_advance(matvec: Callable, diag: torch.Tensor,
                           state: BlockDavidsonState, iters: int,
                           tol: float = 1e-8) -> BlockDavidsonState:
    """At most `iters` more iterations from `state` (stopping early on
    convergence or stagnation); the caller bounds the total."""
    it0 = state.it
    while not state.stop and state.it - it0 < iters:
        state = _block_step(matvec, diag, state, tol)
    return state


def davidson_block_finish(matvec: Callable, diag: torch.Tensor,
                          state: BlockDavidsonState, tol: float = 1e-8
                          ) -> BlockDavidsonResult:
    """Final Rayleigh-Ritz of a search carry, kept if its residual is no
    worse, so init + advance* + finish equals `davidson_block`."""
    k = state.ws.shape[0]
    ws2, X2, HX2 = _block_ritz(state.B, state.HB, state.cnt, k)
    rn2 = torch.max(torch.linalg.norm(HX2 - ws2[:, None] * X2, dim=1))
    ws, X, rn = state.ws, state.X, state.rn
    if bool(rn2 <= rn):
        ws, X, rn = ws2, X2, rn2
    X = X / torch.linalg.norm(X, dim=1, keepdim=True)
    return BlockDavidsonResult(eigenvalues=ws, eigenvectors=X,
                               iterations=state.it, residual_norm=rn)


def davidson_block(matvec: Callable, diag: torch.Tensor, V0: torch.Tensor,
                   k: int, max_subspace: int = 24, maxiter: int = 200,
                   tol: float = 1e-8) -> BlockDavidsonResult:
    """Lowest k eigenpairs of the symmetric operator `matvec` by block
    Davidson: per iteration, Rayleigh-Ritz over the subspace, k
    preconditioned residual corrections appended (orthonormalized against
    the basis and each other), restart collapsing to the k Ritz vectors
    when the subspace fills.  V0 is (k, dim); its rows are
    orthonormalized."""
    state = davidson_block_init(matvec, diag, V0, k, max_subspace, tol)
    state = davidson_block_advance(matvec, diag, state, maxiter - 1, tol)
    return davidson_block_finish(matvec, diag, state, tol)
