"""esoo_torch L-BFGS against esoo_tpu's (solvers/lbfgs.py) on the same
costs: identical iteration and evaluation counts and x to 1e-9 (float64,
CPU) where every line-search decision is above rounding, plus the
resumable-advance and stop-rule contracts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD
from esoo_tpu.sim.sector import SectorUCC as JSector
from esoo_tpu.solvers import lbfgs as JL
from esoo_torch.sim import HartreeFock, UCCSD
from esoo_torch.sim.sector import SectorUCC
from esoo_torch.solvers import lbfgs as TL

jax.config.update("jax_enable_x64", True)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _sector_problem(n, parts, seed):
    """Both packages' sectors and sigma operators for one random
    spin-orbital Hamiltonian with the package's symmetries."""
    N = 2 * n
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, N))
    h = (h + h.T) / 2
    g0 = rng.normal(size=(N,) * 4) * 0.3
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    js = JSector(JUCCSD(n, parts, initial_state=JHF(n, parts)), N)
    ts = SectorUCC(UCCSD(n, parts, initial_state=HartreeFock(n, parts)), N)
    return (js, js.build_values(jnp.asarray(h), jnp.asarray(g)),
            ts, ts.build_values(_t(h), _t(g)))


@pytest.mark.parametrize("n,parts,seed", [(2, (1, 1), 0), (4, (2, 2), 1)])
@pytest.mark.parametrize("ftol", [None, 1e-12])
def test_sector_energy_minimization_matches_jax(n, parts, seed, ftol):
    """The fused eigensolver stage: L-BFGS over theta of the sector energy.

    gtol 1e-6 keeps every Armijo decision far above rounding; at the fused
    loop's f64 gtol of 1e-9 the last steps change f by less than an ulp,
    where the two packages' summation orders decide the test, so there
    only the converged point is compared."""
    js, jvals, ts, tvals = _sector_problem(n, parts, seed)
    P = len(ts._excs)
    x0 = np.full(P, 0.05)
    ref = JL.lbfgs_minimize(js.energy_values, jnp.asarray(x0),
                            args=(jvals,), maxiter=200, gtol=1e-6,
                            ftol=ftol)
    out = TL.lbfgs_minimize(ts.energy_values, _t(x0), args=(tvals,),
                            maxiter=200, gtol=1e-6, ftol=ftol)
    assert out.nit == int(ref.nit)
    assert out.nfev == int(ref.nfev)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(float(out.fun), float(ref.fun), rtol=0,
                               atol=1e-12)
    ref = JL.lbfgs_minimize(js.energy_values, jnp.asarray(x0),
                            args=(jvals,), maxiter=200, gtol=1e-9,
                            ftol=ftol)
    out = TL.lbfgs_minimize(ts.energy_values, _t(x0), args=(tvals,),
                            maxiter=200, gtol=1e-9, ftol=ftol)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(float(out.fun), float(ref.fun), rtol=0,
                               atol=1e-12)


def _rosen_torch(x):
    return torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rosen_jax(x):
    return jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def test_rosenbrock_trajectory_matches_jax():
    ref = JL.lbfgs_minimize(_rosen_jax, jnp.zeros(6), maxiter=137,
                            gtol=1e-8)
    out = TL.lbfgs_minimize(_rosen_torch, torch.zeros(6,
                                                      dtype=torch.float64),
                            maxiter=137, gtol=1e-8)
    assert (out.nit, out.nfev) == (int(ref.nit), int(ref.nfev))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)
    assert float(out.fun) < 1e-12


def test_chunked_advance_equals_single_shot():
    """init + bounded advances reproduce lbfgs_minimize exactly."""
    ref = TL.lbfgs_minimize(_rosen_torch, torch.zeros(6,
                                                      dtype=torch.float64),
                            maxiter=137, gtol=1e-8)
    st = TL.lbfgs_init(_rosen_torch, torch.zeros(6, dtype=torch.float64),
                       gtol=1e-8)
    while not st.done:
        st = TL.lbfgs_advance(_rosen_torch, st, num_steps=7, maxiter=137,
                              gtol=1e-8)
    assert (st.it, st.nfev) == (ref.nit, ref.nfev)
    assert torch.equal(st.x, ref.x)


def test_quadratic_closed_form_and_one_eval_per_iteration():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(20, 20))
    A = A @ A.T + np.eye(20)
    b = rng.normal(size=20)
    At, bt = _t(A), _t(b)
    r = TL.lbfgs_minimize(lambda x: 0.5 * x @ At @ x - bt @ x,
                          torch.zeros(20, dtype=torch.float64),
                          maxiter=400, gtol=1e-10)
    np.testing.assert_allclose(r.x.numpy(), np.linalg.solve(A, b),
                               atol=1e-6)      # as tests/test_lbfgs.py
    assert r.nfev <= 2 * r.nit + 1


def test_f32_and_default_ftol_match_jax():
    for td, jd in ((torch.float32, jnp.float32),
                   (torch.float64, jnp.float64)):
        assert TL.default_ftol(td) == JL.default_ftol(jd)
    A = torch.eye(8, dtype=torch.float32) * 3.0

    def f(x, A, c):
        return 0.5 * x @ A @ x + c * torch.sum(x)

    r = TL.lbfgs_minimize(f, torch.ones(8, dtype=torch.float32),
                          args=(A, torch.tensor(2.0)), maxiter=100,
                          gtol=1e-6)
    assert r.x.dtype == torch.float32
    np.testing.assert_allclose(r.x.numpy(), -2.0 / 3.0 * np.ones(8),
                               atol=1e-5)


def test_stalled_line_search_stops_without_moving():
    """A cost whose every trial point is worse: the exhausted search
    leaves x unchanged and the no-move stop ends the solve."""
    def f(x):
        return torch.where(torch.all(x == 0), torch.sum(x * 0.0) + 1.0,
                           torch.sum(x * 0.0) + 2.0) + 1e-3 * torch.sum(x)

    x0 = torch.zeros(3, dtype=torch.float64)
    r = TL.lbfgs_minimize(f, x0, maxiter=50, max_backtracks=4)
    assert r.nit == 1 and r.nfev == 5
    assert torch.equal(r.x, x0)


# -- the CUDA-graph route's arithmetic, on the CPU ----------------------------
#
# On the card the route replays captured graphs; here its steps run as plain
# calls (solvers/lbfgs.py::_Step), so every piece and the whole loop are held
# to the eager loop bit for bit.  The card tests are in
# tests/test_torch_cuda_lbfgs.py.

def _ring(memory, P, dtype, seed):
    """Random (S, Y, rho) ring buffers and a gradient: every slot filled,
    so that a slot the two-loop must not read would show."""
    gen = torch.Generator().manual_seed(seed)
    S = torch.randn(memory, P, dtype=dtype, generator=gen)
    Y = torch.randn(memory, P, dtype=dtype, generator=gen)
    rho = torch.randn(memory, dtype=dtype, generator=gen)
    g = torch.randn(P, dtype=dtype, generator=gen)
    return S, Y, rho, g


_RING_CASES = [(m, k) for m in (10, 3) for k in range(2 * m + 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("memory,k", _RING_CASES)
def test_masked_two_loop_matches_the_two_loop(dtype, memory, k):
    """k from 0 to 2m + 1: no pair, a partly filled ring, the first wrap,
    a full ring: the masked fixed-m loop with device slot indices gives
    _two_loop's bits."""
    S, Y, rho, g = _ring(memory, 7, dtype, seed=100 * memory + k)
    eps = torch.tensor(1e-30, dtype=dtype)
    ref = TL._two_loop(g, S, Y, rho, k, eps)
    out = TL._two_loop_masked(g, S, Y, rho, torch.tensor(k), eps)
    assert torch.equal(out, ref)


def _eager_direction(g, S, Y, rho, k, eps):
    """lbfgs_advance's direction, its branches on the host."""
    d = -TL._two_loop(g, S, Y, rho, k, eps)
    if not bool(torch.dot(g, d) < 0):
        d = -g
    if k == 0:
        d = d * (1.0 / torch.clamp_min(torch.max(torch.abs(d)), 1.0))
    return d


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("memory", [10, 3])
def test_direction_matches_the_eager_branches(dtype, memory):
    """The descent test and the k == 0 normalization as torch.where give
    the host branches' bits; rho of either sign takes both sides of the
    descent test, and a large gradient both sides of the clamp."""
    branches = set()
    for k in range(2 * memory + 2):
        for scale in (1e-2, 1e2):
            S, Y, rho, g = _ring(memory, 7, dtype, seed=k)
            g = g * scale
            eps = torch.tensor(1e-30, dtype=dtype)
            ref = _eager_direction(g, S, Y, rho, k, eps)
            out = TL._direction(g, S, Y, rho, torch.tensor(k), eps)
            assert torch.equal(out, ref)
            d = -TL._two_loop(g, S, Y, rho, k, eps)
            branches.add(bool(torch.dot(g, d) < 0))
    assert branches == {True, False}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("memory", [10, 3])
def test_store_pair_matches_the_eager_store(dtype, memory):
    """The slot write under where(good, ...) with k on the device against
    lbfgs_advance's `if good:` store, through two wraps of the ring."""
    S, Y, rho, _ = _ring(memory, 5, dtype, seed=memory)
    S2, Y2, rho2 = S.clone(), Y.clone(), rho.clone()
    eps = torch.tensor(1e-30, dtype=dtype)
    k, kt = 0, torch.tensor(0)
    gen = torch.Generator().manual_seed(7)
    for step in range(2 * memory + 3):
        s = torch.randn(5, dtype=dtype, generator=gen)
        y = torch.randn(5, dtype=dtype, generator=gen)
        sy = torch.dot(s, y)
        good = step % 3 != 1
        if good:
            slot = k % memory
            S[slot] = s
            Y[slot] = y
            rho[slot] = 1.0 / (sy + eps)
            k += 1
        TL._store_pair(S2, Y2, rho2, kt, s, y, sy, torch.tensor(good), eps)
        assert int(kt) == k
        assert torch.equal(S2, S) and torch.equal(Y2, Y)
        assert torch.equal(rho2, rho)


def _stalled(x):
    return torch.where(torch.all(x == 0), torch.sum(x * 0.0) + 1.0,
                       torch.sum(x * 0.0) + 2.0) + 1e-3 * torch.sum(x)


@pytest.mark.parametrize("case", ["rosenbrock64", "rosenbrock32",
                                  "memory3", "stalled", "no_backtracks",
                                  "sector"])
def test_graph_route_steps_reproduce_the_eager_solve(case):
    """The route's host loop over its two steps (trial, update), run as
    plain calls: nit, nfev, x, f and the gradient norm of lbfgs_minimize,
    bit for bit; a second solve on the same holder reuses its buffers."""
    kw = dict(maxiter=137, gtol=1e-8)
    fun, args = _rosen_torch, ()
    x0 = torch.zeros(6, dtype=torch.float64)
    if case == "rosenbrock32":
        x0 = x0.float()
    elif case == "memory3":
        kw["memory"] = 3
    elif case == "stalled":
        fun, x0 = _stalled, torch.zeros(3, dtype=torch.float64)
        kw = dict(maxiter=50, max_backtracks=4)
    elif case == "no_backtracks":
        kw["max_backtracks"] = 0
    elif case == "sector":
        _, _, ts, tvals = _sector_problem(4, (2, 2), 1)
        fun, args = ts.energy_values, (tvals,)
        x0 = torch.full((len(ts._excs),), 0.05, dtype=torch.float64)
        kw = dict(maxiter=200, gtol=1e-9)
    graphs = TL.LBFGSGraphs(fun)
    for start in (x0, x0 + 0.01):
        ref = TL.lbfgs_minimize(fun, start, args=args, **kw)
        out = graphs.minimize(start, args, **kw)
        assert (out.nit, out.nfev) == (ref.nit, ref.nfev)
        assert torch.equal(out.x, ref.x)
        assert torch.equal(out.fun, ref.fun)
        assert torch.equal(out.grad_norm, ref.grad_norm)


def test_a_cpu_solve_takes_the_eager_loop(monkeypatch):
    """A holder on the CPU: lbfgs_minimize keeps the eager loop (no step
    runs), with the eager loop's result and counters."""
    from esoo_torch.utils.profiling import collect

    def refuse(*a, **k):
        raise AssertionError("the graph route ran on the CPU")

    monkeypatch.setattr(TL.LBFGSGraphs, "minimize", refuse)
    x0 = torch.zeros(6, dtype=torch.float64)
    ref = TL.lbfgs_minimize(_rosen_torch, x0, maxiter=137, gtol=1e-8)
    stats = {}
    with collect(stats):
        out = TL.lbfgs_minimize(_rosen_torch, x0, maxiter=137, gtol=1e-8,
                                graphs=TL.LBFGSGraphs(_rosen_torch))
    assert (out.nit, out.nfev) == (ref.nit, ref.nfev)
    assert torch.equal(out.x, ref.x)
    assert stats["lbfgs_eager_evals"] == stats["lbfgs_evaluations"] \
        == out.nfev
    assert "lbfgs_graph_evals" not in stats and "lbfgs_captures" not in stats


class _Spatial:
    """A problem given by its spatial integrals."""

    def __init__(self, h, g):
        self.h, self.g = h, g

    def spatial_integral_tensors(self):
        return self.h, self.g


def _fused_vqe(mesh=None):
    from esoo_torch import FusedOptOrbVQE
    rng = np.random.default_rng(5)
    m = 6
    h = rng.normal(size=(m, m))
    h = (h + h.T) / 2
    g = rng.normal(size=(m,) * 4) / m
    g = g + g.transpose(1, 0, 3, 2)
    g = g + g.transpose(2, 3, 0, 1)
    return FusedOptOrbVQE(
        4, UCCSD(2, (1, 1), initial_state=HartreeFock(2, (1, 1))),
        problem=_Spatial(h, g), maxiter=3, dtype=torch.float64,
        device="cpu", mesh=mesh).compute_minimum_energy()


@pytest.mark.parametrize("where", ["one device", "mesh"])
def test_fused_vqe_route_choice(monkeypatch, where):
    """FusedOptOrbVQE marks its sector cost capture-safe on one device and
    not on a mesh.  With the route forced on (a card's choice), the single
    device solve runs the route's steps with the eager loop's bits; the
    mesh solve stays on the eager loop; the unforced CPU solve is eager."""
    from esoo_torch import parallel as TP
    mesh = TP.make_orbital_mesh(devices=["cpu"] * 2) \
        if where == "mesh" else None
    ref = _fused_vqe(mesh)
    assert ref.stage_stats["lbfgs_graph_evals"] == 0
    assert ref.stage_stats["lbfgs_eager_evals"] == \
        ref.stage_stats["lbfgs_evaluations"] > 0
    monkeypatch.setattr(TL, "graph_route", lambda x0: True)
    out = _fused_vqe(mesh)
    assert out.eigenvalue == ref.eigenvalue
    assert np.array_equal(out.optimal_point, ref.optimal_point)
    assert np.array_equal(out.optimal_partial_unitary,
                          ref.optimal_partial_unitary)
    st = out.stage_stats
    assert st["lbfgs_evaluations"] == ref.stage_stats["lbfgs_evaluations"]
    if where == "mesh":
        assert st["lbfgs_graph_evals"] == st["lbfgs_captures"] == 0
    else:
        assert st["lbfgs_graph_evals"] == st["lbfgs_evaluations"]
        assert st["lbfgs_eager_evals"] == 0 and st["lbfgs_captures"] == 1


def test_the_holder_dies_with_the_run(monkeypatch):
    """The graphs are freed by reference counting when the solver's run
    ends, never left to the garbage collector, which could destroy them
    inside a later capture and break it: no cycle runs through the
    holder, its steps or the fused solver's stage functions."""
    import gc
    import weakref
    from esoo_torch.orbital_optimization import fused

    made = []

    class Watched(TL.LBFGSGraphs):
        def __init__(self, fun):
            super().__init__(fun)
            made.append(weakref.ref(self))

    monkeypatch.setattr(fused, "LBFGSGraphs", Watched)
    monkeypatch.setattr(TL, "graph_route", lambda x0: True)
    gc.disable()
    try:
        r = _fused_vqe()
        assert r.stage_stats["lbfgs_captures"] == 1
        assert len(made) == 1 and made[0]() is None
    finally:
        gc.enable()
