"""The orbital step's one-pass value and gradient (esoo_torch/ops/
orbital_vag.py) on the CPU: the plain twin, whose formulas the CUDA kernel
(csrc/orbital_vag.cu) computes, against autograd of
orbital_optimization.kernels.rotated_energy_spatial through both of its
transforms (the kron sandwich and the minor-axis chain); the pair-symmetry
check; the route's conditions and where the solvers decide it; and the
fused solvers keeping autograd on the CPU.  The kernel itself is held to
the twin on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from esoo_torch.ops import launch_counts, reset_launch_counts
from esoo_torch.ops import orbital_vag as ov
from esoo_torch.orbital_optimization import fused, kernels
from esoo_torch.orbital_optimization.stiefel import orth, value_and_grad

SHAPES = [(12, 4), (16, 6), (20, 8), (18, 10)]
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _pair_symmetric_g(rng, m):
    g0 = rng.normal(size=(m,) * 4)
    return g0 + g0.transpose(2, 3, 0, 1)


def _rdms(rng, n, symmetric=True):
    """gamma symmetric; Gamma with the spin-summed RDM's symmetries
    (Gamma[ijkl] = Gamma[klij] = Gamma[jilk]) or, with symmetric=False,
    none at all."""
    a = rng.normal(size=(n, n))
    G0 = rng.normal(size=(n,) * 4)
    if not symmetric:
        return a, G0
    G = (G0 + G0.transpose(2, 3, 0, 1) + G0.transpose(1, 0, 3, 2)
         + G0.transpose(3, 2, 1, 0))
    return a + a.T, G


def _inputs(m, n, dtype, seed, symmetric=True):
    rng = np.random.default_rng(seed)
    U = orth(torch.as_tensor(rng.normal(size=(m, n))))
    h = rng.normal(size=(m, m))
    gamma, Gamma = _rdms(rng, n, symmetric)
    arrays = (U, gamma, Gamma, h + h.T, _pair_symmetric_g(rng, m))
    return tuple(torch.as_tensor(np.asarray(a)).to(dtype) for a in arrays)


def _autograd(transform):
    def energy(u, gamma, Gamma, h, g):
        return (torch.sum(kernels.rotate_one_body(h, u) * gamma)
                + torch.sum(transform(g, u) * Gamma))
    return value_and_grad(energy)


def _close(out, ref, rtol):
    tol = rtol * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("branch", ["kron", "minor"])
@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_twin_matches_autograd(m, n, branch, dtype):
    args = _inputs(m, n, dtype, 100 * m + n)
    transform = getattr(kernels, f"rotate_two_body_{branch}")
    E_ref, G_ref = _autograd(transform)(*args)
    E, G = ov.orbital_value_and_grad_plain(*args)
    assert E.dtype == G.dtype == dtype and G.shape == (m, n)
    _close(E, E_ref, RTOL[dtype])
    _close(G, G_ref, RTOL[dtype])


@pytest.mark.parametrize("m,n", [(9, 4), (12, 5)])
def test_plain_twin_takes_a_gamma_without_symmetries(m, n):
    """Only g's pair symmetry is assumed: a random Gamma gives autograd's
    value and gradient through the pair-symmetrised Gamma."""
    args = _inputs(m, n, torch.float64, m + n, symmetric=False)
    E_ref, G_ref = _autograd(kernels.rotate_two_body_minor)(*args)
    E, G = ov.orbital_value_and_grad_plain(*args)
    _close(E, E_ref, 1e-12)
    _close(G, G_ref, 1e-12)


def test_the_energy_path_matches_rotated_energy_spatial():
    """rotated_energy_spatial (the solvers' objective) at its own branch."""
    args = _inputs(14, 4, torch.float64, 5)
    E_ref, G_ref = fused._ORBITAL_VAG(*args)
    E, G = ov.orbital_value_and_grad_cuda(*args)      # CPU: the twin
    _close(E, E_ref, 1e-12)
    _close(G, G_ref, 1e-12)


def test_cpu_tensors_run_the_twin_and_count_its_route():
    reset_launch_counts()
    args = _inputs(10, 3, torch.float64, 7)
    E, G = ov.orbital_value_and_grad_cuda(*args)
    E2, G2 = ov.orbital_value_and_grad_plain(*args)
    assert torch.equal(E, E2) and torch.equal(G, G2)
    assert not any(key.startswith("orbital_vag.") for key in launch_counts())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_symmetry_check(dtype):
    rng = np.random.default_rng(3)
    m = 11
    g = torch.as_tensor(_pair_symmetric_g(rng, m)).to(dtype)
    assert ov.pair_symmetric(g)
    # what an MO transform leaves: rounding-sized asymmetry passes
    noise = torch.as_tensor(rng.normal(size=(m,) * 4)).to(dtype)
    assert ov.pair_symmetric(g + 1e-3 * ov.pair_rtol(dtype) * noise)
    # a g that lacks the symmetry fails, also in one element
    assert not ov.pair_symmetric(noise)
    bad = g.clone()
    bad[1, 2, 3, 4] += 1e-3 * float(g.abs().max())
    assert not ov.pair_symmetric(bad)


def test_pair_symmetry_check_in_bands(monkeypatch):
    """The comparison runs a band of rows at a time; a band of one row
    finds an asymmetry in the last row."""
    monkeypatch.setattr(ov, "_PAIR_CHUNK", 1)
    rng = np.random.default_rng(4)
    g = torch.as_tensor(_pair_symmetric_g(rng, 5))
    assert ov.pair_symmetric(g)
    g[4, 4, 3, 2] += 1.0
    assert not ov.pair_symmetric(g)


@pytest.mark.parametrize("device,dtype,m,n,sym,route", [
    ("cuda", torch.float64, 112, 14, True, True),
    ("cuda", torch.float32, 112, 8, True, True),
    ("cuda", torch.float32, 56, 4, True, True),
    ("cuda", torch.float64, 256, 16, True, True),
    ("cuda:1", torch.float64, 24, 1, True, True),
    ("cuda", torch.float64, 112, 14, False, False),   # no pair symmetry
    ("cpu", torch.float64, 112, 14, True, False),
    ("cuda", torch.complex128, 112, 14, True, False),
    ("cuda", torch.float16, 56, 4, True, False),
    ("cuda", torch.float64, 257, 14, True, False),
    ("cuda", torch.float64, 112, 17, True, False),
])
def test_route_is_chosen_by_shape_dtype_device_and_symmetry(device, dtype, m,
                                                            n, sym, route):
    assert ov.onepass_route(device, dtype, m, n, sym) is route


def _h2_casscf(**kw):
    from esoo_torch import FusedOptOrbCASSCF
    from esoo_torch.chem import MoleculeDriver
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    return FusedOptOrbCASSCF(4, problem=p, device="cpu", **kw)


@pytest.mark.parametrize("max_n,asymmetric,checks,onepass", [
    (16, False, 1, True),       # the route: g checked once, then taken
    (16, True, 1, False),       # g fails the check: autograd
    (1, False, 0, False),       # n = 2 beyond the route: g never checked
])
def test_solver_decides_the_route_once_per_g(monkeypatch, max_n, asymmetric,
                                             checks, onepass):
    """`_orbital_objective` decides the route in one place, from the
    solver's own n: it checks g's pair symmetry at its first call where
    the route could take the kernel, once per g, and keeps the answer.
    (The route is let onto the CPU here; the kernel is not called.)"""
    real = ov.onepass_route

    def route(device, dtype, m, n, sym):
        return real("cuda", dtype, m, n, sym) and n <= max_n

    calls = []

    def check(g):
        calls.append(g)
        return not asymmetric

    monkeypatch.setattr(ov, "onepass_route", route)
    monkeypatch.setattr(ov, "pair_symmetric", check)
    solver = _h2_casscf(dtype=torch.float64)
    assert solver._g_pair_symmetric is None and not calls
    for _ in range(3):
        vag, data = solver._orbital_objective()
    assert vag is (fused._ORBITAL_ONEPASS_VAG if onepass
                   else fused._ORBITAL_VAG)
    assert len(calls) == checks
    assert all(g is solver._g_sp for g in calls)
    assert data[1] is solver._g_sp


def test_cpu_solver_keeps_autograd_and_counts_it():
    """On the CPU the fused solvers keep autograd (the JAX parity tests see
    no change); each BB value-and-grad is counted as bb_vag_autograd."""
    solver = _h2_casscf()
    assert solver._orbital_objective()[0] is fused._ORBITAL_VAG
    assert solver._g_pair_symmetric is None         # unchecked on the CPU
    st = solver.compute_minimum_energy().stage_stats
    assert st["bb_vag_onepass"] == 0
    # a BB call evaluates its start, then once an iteration
    assert st["bb_vag_autograd"] == st["bb_iterations"] + len(
        st["bb_s_per_call"]) > 0


def test_the_benchmark_reads_the_route_share():
    """portbench's bb_onepass_share.casscf: 100 x the one-pass count over
    both counts, summed over the window's completed untraced requests;
    nothing where the program counts neither (a tree without the route)."""
    from portbench.harness import manifest
    read = manifest.metric_reader("bb_onepass_share.casscf")

    def req(stats, failed=False, traced=False):
        return {"failed": failed, "traced": traced, "stage_stats": stats}

    run = {"requests": [
        req({"bb_vag_onepass": 30, "bb_vag_autograd": 0}),
        req({"bb_vag_onepass": 10, "bb_vag_autograd": 10}),
        req({"bb_vag_onepass": 0, "bb_vag_autograd": 90}, traced=True),
        req({"bb_vag_onepass": 0, "bb_vag_autograd": 90}, failed=True)]}
    assert read(run) == pytest.approx(80.0)
    assert read({"requests": [req({"bb_s": 1.0})]}) is None
    assert read({"requests": [req({"bb_vag_onepass": 0,
                                   "bb_vag_autograd": 0})]}) is None
