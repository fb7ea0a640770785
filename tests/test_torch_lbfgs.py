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
