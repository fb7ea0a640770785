"""The fused solvers on the port's full-space simulator
(`simulation='full'`, and 'auto''s fallback to it) against esoo_tpu on
H2 6-31G -> 4 spin orbitals at float64, the configurations of
tests/test_fused.py: each energy to 1e-8 and each partial unitary to 1e-6
of the JAX package's, and the JAX package's float64 H8 cc-pVTZ -> 12
full-space energy that chip_smoke.py's `full` phase gates on."""

import importlib.util
import os

import numpy as np
import pytest

import esoo_tpu.ops as JO
import esoo_tpu.sim as J
from esoo_tpu.orbital_optimization import (
    FusedOptOrbAdaptVQE as JAdapt, FusedOptOrbMCVQE as JMCVQE,
    FusedOptOrbSSVQE as JSSVQE, FusedOptOrbVQD as JVQD,
    FusedOptOrbVQE as JVQE)
import esoo_torch as T
import esoo_torch.ops as TO
import esoo_torch.sim as TS
from test_torch_engine import same_eri_engine  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E_TOL = 1e-8
U_TOL = 1e-6
REFERENCE = -1.8661038079694765       # tests/test_fused.py:473, decimal 3


def _x12(lib):
    qc = lib.QuantumCircuit(4)
    qc.x(1)
    qc.x(2)
    return qc


def _fallback_circuit(lib):
    """The non-UCC real circuit of tests/test_fused.py:462-467."""
    qc = lib.QuantumCircuit(4)
    qc.x(0)
    qc.x(2)
    qc.ry(qc.parameter(), 1)
    qc.cx(1, 3)
    return qc


def _solver(lib, name, problem, **kw):
    """The configurations in either package (`lib` J or T)."""
    hf = lib.HartreeFock(2, (1, 1))
    if lib is TS:
        kw.setdefault("device", "cpu")
        pkg = dict(vqe=T.FusedOptOrbVQE, ssvqe=T.FusedOptOrbSSVQE,
                   mcvqe=T.FusedOptOrbMCVQE, vqd=T.FusedOptOrbVQD,
                   adapt=T.FusedOptOrbAdaptVQE)
    else:
        pkg = dict(vqe=JVQE, ssvqe=JSSVQE, mcvqe=JMCVQE, vqd=JVQD,
                   adapt=JAdapt)
    if name == "vqe":
        return pkg["vqe"](4, lib.UCCSD(2, (1, 1), initial_state=hf),
                          problem=problem, maxiter=20, simulation="full",
                          **kw)
    if name == "auto":
        return pkg["vqe"](4, _fallback_circuit(lib), problem=problem,
                          maxiter=20, **kw)
    if name == "ssvqe":
        return pkg["ssvqe"](4, lib.UCCSD(2, (1, 1), reps=2),
                            initial_states=[hf, _x12(lib)],
                            weight_vector=[2, 1], problem=problem,
                            maxiter=20, simulation="full", **kw)
    if name == "mcvqe":
        return pkg["mcvqe"](4, lib.UCCSD(2, (1, 1), reps=2),
                            num_particles=(1, 1), k=2, excitations="s",
                            weight_vector=[2, 1], problem=problem,
                            maxiter=20, simulation="full", **kw)
    if name == "vqd":      # per-state ansatz lists: 'auto' takes full
        return pkg["vqd"](4, [lib.UCCSD(2, (1, 1)),
                              lib.UCCSD(2, (1, 1), reps=2)],
                          initial_states=[hf, _x12(lib)], betas=[2.0],
                          weight_vector=[2, 1], problem=problem, maxiter=20,
                          **kw)
    return pkg["adapt"](4, lib.UCCSD(2, (1, 1), initial_state=hf),
                        problem=problem, maxiter=20, simulation="full", **kw)


def _run(solver):
    if hasattr(solver, "compute_energies"):
        return solver.compute_energies()
    return solver.compute_minimum_energy()


def _energies(r):
    return np.atleast_1d(getattr(r, "eigenvalues", None)
                         if hasattr(r, "eigenvalues") else r.eigenvalue)


NAMES = ["vqe", "auto", "ssvqe", "mcvqe", "vqd", "adapt"]


@pytest.fixture(scope="module")
def runs(h2_631g):
    """{name: (JAX result, port result, port solver)}."""
    out = {}
    for name in NAMES:
        solver = _solver(TS, name, h2_631g)
        out[name] = (_run(_solver(J, name, h2_631g)), _run(solver), solver)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_full_space_solvers_match_jax(runs, name):
    ref, got, solver = runs[name]
    assert solver.simulation == "full"
    np.testing.assert_allclose(_energies(got), _energies(ref), rtol=0,
                               atol=E_TOL)
    np.testing.assert_allclose(got.optimal_partial_unitary,
                               ref.optimal_partial_unitary, rtol=0,
                               atol=U_TOL)
    assert got.outer_iterations == ref.outer_iterations
    np.testing.assert_allclose(got.energy_convergence_list,
                               ref.energy_convergence_list, rtol=0,
                               atol=E_TOL)


@pytest.mark.parametrize("name", ["vqe", "adapt"])
def test_full_space_diagnostics_match_jax(runs, name):
    ref, got, _ = runs[name]
    np.testing.assert_allclose(got.natural_occupations,
                               ref.natural_occupations, rtol=0, atol=U_TOL)
    np.testing.assert_allclose(got.one_rdm_spatial, ref.one_rdm_spatial,
                               rtol=0, atol=U_TOL)
    assert abs(got.spin_squared - ref.spin_squared) <= U_TOL


@pytest.mark.parametrize("name", ["ssvqe", "mcvqe", "vqd"])
def test_full_space_runs_carry_no_transition_rdms(runs, name):
    """Full-space eigensolver runs return None for the transition and
    per-state RDMs, as the JAX package does
    (tests/test_fused_diagnostics.py:135)."""
    ref, got, _ = runs[name]
    assert got.transition_rdm1_spatial is None
    assert ref.transition_rdm1_spatial is None
    assert got.natural_occupations is None and ref.natural_occupations is None


def test_full_matches_sector_in_the_port(h2_631g, runs):
    """Both simulate the same unitary from the same start."""
    sector = T.FusedOptOrbVQE(
        4, T.UCCSD(2, (1, 1), initial_state=T.HartreeFock(2, (1, 1))),
        problem=h2_631g, maxiter=20, device="cpu")
    assert sector.simulation == "sector"
    r = sector.compute_minimum_energy()
    full = runs["vqe"][1]
    assert abs(r.eigenvalue - full.eigenvalue) <= E_TOL
    assert abs(full.eigenvalue - REFERENCE) <= 5e-4
    np.testing.assert_allclose(r.energy_convergence_list,
                               full.energy_convergence_list, atol=E_TOL)


def test_auto_falls_back_for_a_non_ucc_circuit(h2_631g):
    with pytest.raises(ValueError):
        T.FusedOptOrbVQE(4, _fallback_circuit(TS), problem=h2_631g,
                         simulation="sector", device="cpu")
    with pytest.raises(ValueError, match="real-safe"):
        T.FusedOptOrbVQE(4, TS.EfficientSU2(4, reps=1), problem=h2_631g,
                         device="cpu")
    # the per-state VQD lists cannot take the sector either
    with pytest.raises(ValueError, match="simulation='full'"):
        _solver(TS, "vqd", h2_631g, simulation="sector")


@pytest.mark.parametrize("mapper", ["ParityMapper", "BravyiKitaevMapper"])
def test_qubit_mappers_in_circuits_and_hamiltonians(h2_sto3g, mapper):
    """A mapped UCCSD from the mapper-aware HartreeFock under the mapped
    Hamiltonian gives the JAX package's energy and the Jordan-Wigner one
    at the same theta (tests/test_mappers.py:79); the fused solvers keep
    refusing it (their direct RDMs need the occupation basis)."""
    h, g = h2_sto3g.integral_tensors()
    theta = np.random.default_rng(0).normal(size=3) * 0.3
    values = []
    for lib, ops, est in ((J, JO, J.Estimator()),
                          (TS, TO, TS.Estimator(device="cpu"))):
        m = getattr(ops, mapper)()
        ans = lib.UCCSD(2, (1, 1), qubit_mapper=m,
                        initial_state=lib.HartreeFock(2, (1, 1),
                                                      qubit_mapper=m))
        H = ops.ActiveSpaceHamiltonianBuilder(4, m).build(h, g)
        jw = ops.ActiveSpaceHamiltonianBuilder(4).build(h, g)
        plain = lib.UCCSD(2, (1, 1),
                          initial_state=lib.HartreeFock(2, (1, 1)))
        values.append(est.run([ans, plain], [H, jw],
                              [theta, theta]).result().values)
    np.testing.assert_allclose(values[1], values[0], rtol=0, atol=1e-12)
    assert abs(values[1][0] - values[1][1]) <= 1e-12
    m = getattr(TO, mapper)()
    with pytest.raises(ValueError, match="Jordan-Wigner"):
        T.FusedOptOrbVQE(4, TS.UCCSD(2, (1, 1), qubit_mapper=m),
                         problem=h2_sto3g, device="cpu")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_h8_12_full_matches_the_smoke_constant():
    """chip_smoke.py's `full` phase gates the card's float32 energy
    against JAX_H8_12_FULL_F64: the JAX package's float64
    FusedOptOrbVQE(simulation='full') on H8 cc-pVTZ m=112 -> 12 spin
    orbitals (UCCSD(6, (4, 4)) from HF, maxiter 10, tol 1e-5; the
    `(12, "full", "one")` configuration of bench.py:307 run_h8_scale).
    This test recomputes it (~4 min on 8 CPU cores with the integrals)."""
    from esoo_tpu.chem import MoleculeDriver
    smoke = _smoke()
    p = MoleculeDriver(atom=smoke.H8_GEOM, basis="cc-pvtz").run()
    assert p.num_spatial_orbitals == 112
    r = JVQE(12, J.UCCSD(6, (4, 4), initial_state=J.HartreeFock(6, (4, 4))),
             problem=p, simulation="full", maxiter=smoke.H8_FULL_KW["maxiter"],
             stopping_tolerance=smoke.H8_FULL_KW["stopping_tolerance"],
             dtype=np.float64).compute_minimum_energy()
    np.testing.assert_allclose(r.eigenvalue, smoke.JAX_H8_12_FULL_F64,
                               rtol=0, atol=1e-9)
