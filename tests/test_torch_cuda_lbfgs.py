"""The CUDA-graph route of the L-BFGS loop (solvers/lbfgs.py) against its
eager loop on the card: the same trajectory, the same launches, every
evaluation a replay, one capture a solver, and no memory kept after it.
CUDA graphs need an NVIDIA GPU, so these tests skip without one; run
them there with

    pytest -m cuda tests/test_torch_cuda_lbfgs.py"""

import gc

import numpy as np
import pytest
import torch

from esoo_torch.ops import launch_counts, reset_launch_counts
from esoo_torch.solvers import lbfgs as TL

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def warm():
    """One small graph-route solve before the tests: the first capture on
    a device runs one trial eagerly ahead of it (solvers/lbfgs.py::_WARM),
    so that each test compares the launches of warm solves."""
    if torch.cuda.is_available():
        sector, vals = _random_sector(2, (1, 1), 0, torch.float64)
        TL.lbfgs_minimize(sector.energy_values,
                          torch.zeros(len(sector._excs), dtype=torch.float64,
                                      device="cuda"),
                          args=(vals, None), maxiter=5,
                          graphs=TL.LBFGSGraphs(sector.energy_values))


def _eager(monkeypatch):
    """Send every solve to the eager loop, as on the CPU."""
    monkeypatch.setattr(TL, "graph_route", lambda x0: False)


def _h4_631g():
    from esoo_torch.chem import MoleculeDriver
    return MoleculeDriver(atom="H 0 0 0; H 0 0 1.23; H 0 0 2.46; "
                          "H 0 0 3.69", basis="6-31g").run()


def _h4_vqe(problem, dtype, maxiter=20):
    from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
    return FusedOptOrbVQE(
        8, UCCSD(4, (2, 2), initial_state=HartreeFock(4, (2, 2))),
        problem=problem, maxiter=maxiter, dtype=dtype, device="cuda")


def _run(solver):
    reset_launch_counts()
    r = solver.compute_minimum_energy()
    torch.cuda.synchronize()
    return r, launch_counts()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_h4_vqe_graph_route_matches_the_eager_loop(card, monkeypatch,
                                                    dtype):
    """FusedOptOrbVQE on H4 6-31G -> 8, UCCSD (2, 2): both routes give the
    same bits (energy, theta, U, the trace), the same evaluations,
    iterations and launches; on the graph route every evaluation is a
    replay and the solver captures once."""
    p = _h4_631g()
    graph, graph_launches = _run(_h4_vqe(p, dtype))
    with monkeypatch.context() as m:
        _eager(m)
        eager, eager_launches = _run(_h4_vqe(p, dtype))
    assert graph.eigenvalue == eager.eigenvalue
    assert np.array_equal(graph.optimal_point, eager.optimal_point)
    assert np.array_equal(graph.optimal_partial_unitary,
                          eager.optimal_partial_unitary)
    assert graph.energy_convergence_list == eager.energy_convergence_list
    gs, es = graph.stage_stats, eager.stage_stats
    for key in ("lbfgs_evaluations", "lbfgs_iterations", "bb_iterations"):
        assert gs[key] == es[key], key
    assert gs["lbfgs_graph_evals"] == gs["lbfgs_evaluations"] > 0
    assert gs["lbfgs_eager_evals"] == 0
    assert gs["lbfgs_captures"] == 1 and gs["lbfgs_capture_s"] > 0
    assert es["lbfgs_eager_evals"] == es["lbfgs_evaluations"]
    assert es["lbfgs_graph_evals"] == es["lbfgs_captures"] == 0
    assert graph_launches == eager_launches
    assert graph_launches["gate_scan.gate_scan_bwd.smem"] == \
        gs["lbfgs_evaluations"]


def _random_sector(n, parts, seed, dtype):
    """A UCCSD(n, parts) string sector on the card and its sigma values
    for a random spin-orbital Hamiltonian with the package's
    symmetries."""
    from esoo_torch.sim import HartreeFock, UCCSD
    from esoo_torch.sim.sector import SectorUCC
    N = 2 * n
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, N))
    h = (h + h.T) / 2
    g0 = rng.normal(size=(N,) * 4) * 0.05
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    sector = SectorUCC(UCCSD(n, parts, initial_state=HartreeFock(n, parts)),
                       N)
    vals = sector.build_values(torch.as_tensor(h, device="cuda").to(dtype),
                               torch.as_tensor(g, device="cuda").to(dtype))
    return sector, vals


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_h8_16_sector_solve_graph_route_matches_the_eager_loop(card, dtype):
    """An H8 -> 16 sector solve (UCCSD (4, 4), 360 gates on 4,900
    determinants) from a random start, twice on one holder (the second
    solve replays the first one's graphs with new values): x, f, nit and
    nfev of each solve are the eager loop's bits, with the same
    launches."""
    sector, vals = _random_sector(8, (4, 4), 3, dtype)
    _, vals2 = _random_sector(8, (4, 4), 4, dtype)
    P = len(sector._excs)
    gtol = 1e-9 if dtype == torch.float64 else 1e-5
    graphs = TL.LBFGSGraphs(sector.energy_values)
    for i, v in enumerate((vals, vals2)):
        x0 = torch.as_tensor(np.random.default_rng(i).normal(size=P) * 0.02,
                             device=card).to(dtype)
        reset_launch_counts()
        ref = TL.lbfgs_minimize(sector.energy_values, x0, args=(v, None),
                                maxiter=60, gtol=gtol)
        torch.cuda.synchronize()
        ref_launches = launch_counts()
        reset_launch_counts()
        out = TL.lbfgs_minimize(sector.energy_values, x0, args=(v, None),
                                maxiter=60, gtol=gtol, graphs=graphs)
        torch.cuda.synchronize()
        assert (out.nit, out.nfev) == (ref.nit, ref.nfev)
        assert torch.equal(out.x, ref.x)
        assert torch.equal(out.fun, ref.fun)
        assert torch.equal(out.grad_norm, ref.grad_norm)
        assert launch_counts() == ref_launches


def test_graphs_are_freed_with_the_solver(card):
    """20 H4 solvers built, run and dropped: the device memory in use
    returns to its level (the graphs, their pools and their static
    buffers go with the solver's run)."""
    p = _h4_631g()
    _run(_h4_vqe(p, torch.float32, maxiter=2))
    gc.collect()
    torch.cuda.synchronize()
    level = torch.cuda.memory_allocated()
    for _ in range(20):
        r, _ = _run(_h4_vqe(p, torch.float32, maxiter=2))
        assert r.stage_stats["lbfgs_captures"] == 1
        del r
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == level
