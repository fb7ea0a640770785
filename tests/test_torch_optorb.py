"""esoo_torch's class-based OptOrb solvers (OptOrbVQE, OptOrbSSVQE,
OptOrbMCVQE, OptOrbVQD, OptOrbAdaptVQE), BaseOptOrbSolver, the
complex-RDM objective, PartialUnitaryProjectionOptimizer and the interop
adapter, against esoo_tpu: float64 on the CPU, H2 6-31G -> 4 spin
orbitals (its integrals with the spin blocks coupled for the
spin-orbital path).  Each package solves the same problem (the port's
crosses as the JAX problem's fields).

Mirrors tests/test_optorb_e2e.py, test_stiefel.py, test_complex_rdm.py
and test_interop.py case for case, plus the device rules and the
checkpoints read across packages.  Tolerances: rotated-Hamiltonian
coefficients and RDMs 1e-12; PartialUnitaryProjectionOptimizer on a
fixed objective 1e-10; first outer energies 1e-10; final energies 1e-7
(the BB stop test amplifies last-bit differences); the reference anchors
at decimal 3."""

import dataclasses
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esoo_torch as T
import esoo_torch.interop as TI
import esoo_tpu.interop as JI
import esoo_tpu.orbital_optimization as JO
import esoo_tpu.sim as JS
import esoo_tpu.solvers as JV
from esoo_torch.convert import problem_from_numpy
from esoo_torch.orbital_optimization import base as TB
from esoo_torch.orbital_optimization.stiefel import (
    _bb_projected_descent, value_and_grad)
from esoo_torch.utils import precision_mode
from esoo_torch.parallel import make_orbital_state_mesh
from esoo_tpu.orbital_optimization import base as JB
from test_torch_engine import same_eri_engine  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E_OPTORB_VQE = -1.8661038079694765          # BASELINE.md anchors
E_OPTORB_ADAPT = -1.866104213792463
E_OPTORB_SSVQE = [-1.85403538, -1.37044354]
E_OPTORB_MCVQE = [-1.85703467, -1.46615986]
E_OPTORB_VQD = [-1.8540352, -1.37044389]
CPU = {"device": "cpu"}

# one namespace per package, so a test builds the same solver in both
J = types.SimpleNamespace(pkg="jax", dk={}, **{
    k: getattr(m, k) for m in (JS, JV, JO) for k in dir(m)
    if not k.startswith("_")})
P = types.SimpleNamespace(pkg="torch", dk=CPU, **{
    k: getattr(T, k) for k in T.__all__})


@pytest.fixture(scope="module")
def problems(h2_631g):
    return {"jax": h2_631g,
            "torch": problem_from_numpy(dataclasses.asdict(h2_631g))}


def pupo(ns, **kw):
    return ns.PartialUnitaryProjectionOptimizer(
        initial_BBstepsize=1e-3, stopping_tolerance=1e-5, maxiter=10000,
        **ns.dk, **kw)


def make_vqe(ns, optimizer=None):
    ansatz = ns.UCCSD(2, (1, 1), initial_state=ns.HartreeFock(2, (1, 1)))
    return ns.VQE(ns.Estimator(**ns.dk), ansatz, optimizer or ns.L_BFGS_B(),
                  initial_point=np.zeros(ansatz.num_parameters), **ns.dk)


def optorbvqe(ns, problems, **kw):
    kw.setdefault("problem", problems[ns.pkg])
    kw.setdefault("partial_unitary_optimizer", pupo(ns))
    kw.setdefault("ground_state_solver", make_vqe(ns))
    return ns.OptOrbVQE(num_spin_orbitals=4, **ns.dk, **kw)


def init1(ns):
    qc = ns.QuantumCircuit(4)
    qc.x(1)
    qc.x(2)
    return qc


def excited(ns, problems, kind, **kw):
    ansatz = ns.UCCSD(2, (1, 1), reps=2)
    zeros = np.zeros(ansatz.num_parameters)
    if kind == "ssvqe":
        solver = ns.SSVQE(k=2, ansatz=ansatz, optimizer=ns.L_BFGS_B(),
                          initial_states=[ns.HartreeFock(2, (1, 1)),
                                          init1(ns)],
                          weight_vector=[2, 1], initial_point=zeros, **ns.dk)
        cls = ns.OptOrbSSVQE
    elif kind == "mcvqe":
        solver = ns.MCVQE(k=2, ansatz=ansatz, optimizer=ns.L_BFGS_B(),
                          num_particles=(1, 1), excitations="s",
                          initial_point=zeros, **ns.dk)
        cls = ns.OptOrbMCVQE
    else:
        ansatze = [ns.UCCSD(2, (1, 1), initial_state=st, reps=2)
                   for st in (ns.HartreeFock(2, (1, 1)), init1(ns))]
        solver = ns.VQD(ns.Estimator(**ns.dk),
                        ns.ComputeUncompute(ns.Sampler(shots=None, **ns.dk)),
                        ansatze, ns.L_BFGS_B(), k=2, betas=[2, 2],
                        initial_point=[np.zeros(a.num_parameters)
                                       for a in ansatze], **ns.dk)
        cls = ns.OptOrbVQD
    return cls(num_spin_orbitals=4, excited_states_solver=solver,
               partial_unitary_optimizer=pupo(ns), problem=problems[ns.pkg],
               maxiter=20, **ns.dk, **kw)


def assert_runs_agree(r_jax, r_port, values="eigenvalue"):
    """First outer energies to 1e-10, final energies and traces to 1e-7."""
    tj, tp = r_jax.energy_convergence_list, r_port.energy_convergence_list
    assert abs(tj[0] - tp[0]) <= 1e-10
    assert len(tj) == len(tp)
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-7)
    np.testing.assert_allclose(getattr(r_port, values),
                               getattr(r_jax, values), rtol=0, atol=1e-7)
    np.testing.assert_allclose(r_port.optimal_partial_unitary,
                               r_jax.optimal_partial_unitary, rtol=0,
                               atol=1e-6)


# --- tests/test_optorb_e2e.py ------------------------------------------------

@pytest.mark.parametrize("ingestion", ["problem", "tensors"])
@pytest.mark.parametrize("flags", [dict(spin_conserving=True,
                                        wavefuntion_real=True),
                                   dict(spin_conserving=False,
                                        wavefuntion_real=False)])
def test_optorbvqe(problems, ingestion, flags):
    """The reference's 2x2 ingestion x symmetry-flag matrix."""
    runs = {}
    for ns in (J, P):
        kw = dict(maxiter=20, stopping_tolerance=1e-5, **flags)
        if ingestion == "tensors":
            kw.update(problem=None, integral_tensors=problems[
                "jax"].integral_tensors())
        runs[ns.pkg] = optorbvqe(ns, problems, **kw).compute_minimum_energy()
    assert_runs_agree(runs["jax"], runs["torch"])
    r = runs["torch"]
    np.testing.assert_array_almost_equal(r.eigenvalue, E_OPTORB_VQE,
                                         decimal=3)
    U = r.optimal_partial_unitary
    np.testing.assert_allclose(U.T @ U, np.eye(2), atol=1e-8)
    assert r.orbital_rotation_iterations == \
        runs["jax"].orbital_rotation_iterations


def test_optorbvqe_pauli_rdm_path(problems):
    """Per-Pauli RDM measurement (reference semantics) reaches the direct
    path's optimum, in both packages alike."""
    kw = dict(maxiter=20, spin_conserving=True, wavefuntion_real=True,
              rdm_measurement="pauli")
    rj, rp = (optorbvqe(ns, problems, **kw).compute_minimum_energy()
              for ns in (J, P))
    assert_runs_agree(rj, rp)
    np.testing.assert_array_almost_equal(rp.eigenvalue, E_OPTORB_VQE,
                                         decimal=3)


def test_optorbadaptvqe(problems):
    runs = []
    for ns in (J, P):
        template = ns.UCCSD(2, (1, 1), initial_state=ns.HartreeFock(2, (1, 1)))
        adapt = ns.AdaptVQE(ns.VQE(ns.Estimator(**ns.dk), template,
                                   ns.L_BFGS_B(), **ns.dk))
        runs.append(ns.OptOrbAdaptVQE(
            num_spin_orbitals=4, ground_state_solver=adapt,
            partial_unitary_optimizer=pupo(ns), problem=problems[ns.pkg],
            maxiter=20, **ns.dk).compute_minimum_energy())
    assert_runs_agree(*runs)
    np.testing.assert_array_almost_equal(runs[1].eigenvalue, E_OPTORB_ADAPT,
                                         decimal=3)


@pytest.mark.parametrize("kind,anchor", [("ssvqe", E_OPTORB_SSVQE),
                                         ("mcvqe", E_OPTORB_MCVQE),
                                         ("vqd", E_OPTORB_VQD)])
def test_optorb_excited(problems, kind, anchor):
    """test_optorbssvqe / test_optorbmcvqe / test_optorbvqd."""
    rj, rp = (excited(ns, problems, kind).compute_energies()
              for ns in (J, P))
    assert_runs_agree(rj, rp, values="eigenvalues")
    np.testing.assert_array_almost_equal(rp.eigenvalues, anchor, decimal=3)


def test_checkpoint_resume(problems, tmp_path):
    ck = str(tmp_path / "ckpt")
    optorbvqe(P, problems, maxiter=2,
              checkpoint_dir=ck).compute_minimum_energy()
    files = sorted(os.listdir(ck))
    assert len(files) == 2
    r2 = optorbvqe(P, problems, maxiter=20,
                   resume_from=os.path.join(ck, files[-1])
                   ).compute_minimum_energy()
    np.testing.assert_array_almost_equal(r2.eigenvalue, E_OPTORB_VQE,
                                         decimal=3)


@pytest.mark.parametrize("writer,reader", [(J, P), (P, J)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_checkpoint_crosses_packages(problems, tmp_path, writer, reader):
    """The .npz layouts match: a checkpoint written by one package
    resumes in the other, on the same perturbation stream, and lands
    where an uninterrupted run of the reader does."""
    kw = dict(partial_unitary_random_perturbation=0.01, seed=7)
    ck = str(tmp_path / "ck")
    optorbvqe(writer, problems, maxiter=2, checkpoint_dir=ck,
              **kw).compute_minimum_energy()
    first = os.path.join(ck, sorted(os.listdir(ck))[0])
    r_res = optorbvqe(reader, problems, maxiter=4, resume_from=first,
                      **kw).compute_minimum_energy()
    r_full = optorbvqe(reader, problems, maxiter=4,
                       **kw).compute_minimum_energy()
    np.testing.assert_allclose(r_res.optimal_partial_unitary,
                               r_full.optimal_partial_unitary, atol=1e-7)
    np.testing.assert_allclose(r_res.eigenvalue, r_full.eigenvalue,
                               atol=1e-7)


def test_checkpoint_resume_replays_rng_stream(problems, tmp_path):
    """A perturbed run resumed mid-flight replays the uninterrupted run's
    noise stream (the checkpoint keeps the RNG state), and the stream is
    the JAX package's."""
    kw = dict(partial_unitary_random_perturbation=0.01, seed=7)
    r_full = optorbvqe(P, problems, maxiter=4, **kw).compute_minimum_energy()
    ck = str(tmp_path / "ck_rng")
    optorbvqe(P, problems, maxiter=2, checkpoint_dir=ck,
              **kw).compute_minimum_energy()
    files = sorted(os.listdir(ck))
    r_res = optorbvqe(P, problems, maxiter=4,
                      resume_from=os.path.join(ck, files[0]),
                      **kw).compute_minimum_energy()
    np.testing.assert_allclose(r_res.optimal_partial_unitary,
                               r_full.optimal_partial_unitary, atol=1e-9)
    np.testing.assert_allclose(r_res.eigenvalue, r_full.eigenvalue,
                               atol=1e-9)
    r_jax = optorbvqe(J, problems, maxiter=4, **kw).compute_minimum_energy()
    assert_runs_agree(r_jax, r_full)


def test_start_point_and_unitary_cross_as_numpy(problems):
    """A seeded initial point and partial unitary cross as NumPy arrays:
    both packages start from them and agree (2 outer iterations)."""
    rng = np.random.default_rng(21)
    U0 = _random_u(4, 2, 21)
    x0 = rng.normal(0, 0.1, 3)
    runs = []
    for ns in (J, P):
        ansatz = ns.UCCSD(2, (1, 1), initial_state=ns.HartreeFock(2, (1, 1)))
        vqe = ns.VQE(ns.Estimator(**ns.dk), ansatz, ns.L_BFGS_B(),
                     initial_point=x0.copy(), **ns.dk)
        runs.append(optorbvqe(ns, problems, ground_state_solver=vqe,
                              initial_partial_unitary=U0,
                              maxiter=2).compute_minimum_energy())
    assert_runs_agree(*runs)


def test_outer_loop_callback(problems):
    seen = []
    optorbvqe(P, problems, maxiter=3,
              outer_loop_callback=lambda it, res, orb: seen.append(it)
              ).compute_minimum_energy()
    assert seen == list(range(len(seen)))
    assert len(seen) >= 2


def test_perturbation_paths(problems):
    """Gaussian perturbations of U and of the warm start converge to the
    same optimum, with the JAX package's noise stream."""
    kw = dict(maxiter=20, partial_unitary_random_perturbation=0.01,
              minimum_eigensolver_random_perturbation=0.01, seed=7)
    rj, rp = (optorbvqe(ns, problems, **kw).compute_minimum_energy()
              for ns in (J, P))
    assert_runs_agree(rj, rp)
    np.testing.assert_array_almost_equal(rp.eigenvalue, E_OPTORB_VQE,
                                         decimal=3)


def test_metrics_and_result_fields(problems):
    r = optorbvqe(P, problems, maxiter=20).compute_minimum_energy()
    n = len(r.energy_convergence_list)
    assert r.num_vqe_evaluations == n
    assert len(r.metrics["eigensolver_time"]) == n
    assert len(r.metrics["hamiltonian_time"]) == n
    assert len(r.metrics["rdm_time"]) == len(r.metrics["rotation_time"]) \
        == len(r.orbital_rotation_iterations) == n - 1
    assert isinstance(r.optimal_partial_unitary, np.ndarray)


# --- the class path's pieces against the JAX package -------------------------

def _solvers(problems, **kw):
    return (JB.BaseOptOrbSolver(num_spin_orbitals=4, **kw,
                                problem=problems["jax"]),
            TB.BaseOptOrbSolver(num_spin_orbitals=4, **kw, **CPU,
                                problem=problems["torch"]))


def _random_u(m, n, seed):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(np.eye(m)[:, :n] + 0.2 * rng.normal(size=(m, n)))[0]


def test_rotated_hamiltonian_matches_jax(problems):
    """Pauli coefficients and (h, g) at a seeded U, to 1e-12; the operator
    keeps the device tensors for the eigensolver."""
    sj, sp = _solvers(problems)
    # the problem's spatial g is a transposed view; the CUDA transform
    # takes contiguous tensors only
    assert sp._g_sp.is_contiguous() and sp._h_sp.is_contiguous()
    U = _random_u(4, 2, 11)
    hj, hp = sj.get_rotated_hamiltonian(U), sp.get_rotated_hamiltonian(U)
    assert hj.xs == hp.xs and hj.zs == hp.zs
    np.testing.assert_allclose(hp.coeffs, hj.coeffs, rtol=0, atol=1e-12)
    for a, b in zip(hp.fermionic, hj.fermionic):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for a, b in zip(hp._fermionic_tensors, hp.fermionic):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)


def test_spin_orbital_path_matches_jax(h2_631g):
    """Integrals without the spin-block structure take the spin-orbital
    path: the rotated Hamiltonian and the orbital objective agree."""
    h, g = (np.array(a) for a in h2_631g.integral_tensors())
    m = h.shape[0] // 2
    h[0, m] = h[m, 0] = 1e-3            # break the spin-block structure
    sj = JB.BaseOptOrbSolver(num_spin_orbitals=4, integral_tensors=(h, g))
    sp = TB.BaseOptOrbSolver(num_spin_orbitals=4, integral_tensors=(h, g),
                             **CPU)
    assert not sj._spatial_path and not sp._spatial_path
    U = _random_u(m, 2, 12)
    np.testing.assert_allclose(sp.get_rotated_hamiltonian(U).coeffs,
                               sj.get_rotated_hamiltonian(U).coeffs,
                               rtol=0, atol=1e-12)


def test_direct_rdms_and_inner_step_match_jax(problems):
    """Sector RDMs of a bound UCCSD circuit (1e-12) and one orbital step
    on them (1e-10)."""
    sj, sp = _solvers(problems)
    theta = np.random.default_rng(5).normal(0, 0.2, 3)
    circs = [(ns.UCCSD(2, (1, 1), initial_state=ns.HartreeFock(2, (1, 1))),
              theta) for ns in (J, P)]
    gj, Gj = sj._rdms_for_bound_circuits([circs[0]])
    gp, Gp = sp._rdms_for_bound_circuits([circs[1]])
    np.testing.assert_allclose(gp[0].numpy(), gj[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(Gp[0].numpy(), Gj[0], rtol=0, atol=1e-12)
    U0 = sj.initial_partial_unitary
    Uj, Ej = sj._run_inner_optimization(pupo(J), U0, gj, Gj)
    Up, Ep = sp._run_inner_optimization(pupo(P), U0, gp, Gp)
    assert abs(Ep - Ej) <= 1e-10
    np.testing.assert_allclose(Up.numpy(), Uj, rtol=0, atol=1e-8)


def test_fast_precision_runs_in_float32(problems):
    """precision_mode('fast') puts the class path in float32 (the JAX
    package's policy); the energy stays within 1e-4 of float64."""
    with precision_mode("fast"):
        solver = optorbvqe(P, problems, maxiter=20)
        r = solver.compute_minimum_energy()
    assert solver._h_sp.dtype == torch.float32
    assert abs(r.eigenvalue - E_OPTORB_VQE) <= 1e-4


# --- device rules -----------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: P.VQE(),
    lambda: P.SSVQE(),
    lambda: P.MCVQE(),
    lambda: P.VQD(),
    lambda: P.PartialUnitaryProjectionOptimizer(),
    lambda: P.DeviceLBFGS(),
    lambda: P.AdaptVQE(P.VQE(**CPU), device="cuda"),
    lambda: P.OptOrbVQE(4, ground_state_solver=P.VQE(**CPU),
                        integral_tensors=(np.eye(8), np.zeros((8,) * 4))),
], ids=["VQE", "SSVQE", "MCVQE", "VQD", "PUPO", "DeviceLBFGS", "AdaptVQE",
        "OptOrbVQE"])
def test_entry_points_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_parts_on_another_device_raise(problems):
    """A VQE, estimator or orbital optimizer built for another device than
    its OptOrb solver raises instead of being copied."""
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="solver"):
        optorbvqe(P, problems, ground_state_solver=P.VQE(**meta))
    with pytest.raises(ValueError, match="estimator"):
        optorbvqe(P, problems, estimator=P.Estimator(**meta))
    with pytest.raises(ValueError, match="partial_unitary_optimizer"):
        optorbvqe(P, problems, partial_unitary_optimizer=P.
                  PartialUnitaryProjectionOptimizer(**meta))
    with pytest.raises(ValueError, match="optimizer"):
        P.VQE(ansatz=None, optimizer=P.DeviceLBFGS(**meta), **CPU)


def test_mesh_is_not_ported(problems):
    """mesh= is ported (tests/test_torch_parallel.py): a non-mesh raises
    TypeError, and a 2-D state x orb mesh shards g over its orb axis, as
    in the JAX package."""
    with pytest.raises(TypeError, match="OrbitalMesh"):
        optorbvqe(P, problems, mesh=object())
    on_2d = optorbvqe(P, problems, mesh=make_orbital_state_mesh(
        2, 2, devices=["cpu"] * 4))
    assert len(on_2d._sharded["g"]) == 2


def test_wrong_solver_type_and_unitary_shape_raise(problems):
    with pytest.raises(P.AlgorithmError, match="VQE, not SSVQE"):
        optorbvqe(P, problems, ground_state_solver=P.SSVQE(**CPU))
    with pytest.raises(ValueError, match="spatial"):
        optorbvqe(P, problems, initial_partial_unitary=np.eye(8)[:, :4])


# --- tests/test_stiefel.py ---------------------------------------------------

def test_orth_matches_jax_and_is_the_polar_factor():
    """test_orth_produces_orthonormal_columns / _idempotent_on_orthonormal
    / _is_polar_factor."""
    from scipy.linalg import polar
    rng = np.random.default_rng(0)
    V = rng.normal(size=(8, 3))
    U = T.orbital_optimization.orth(torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(U.T @ U, np.eye(3), atol=1e-10)
    np.testing.assert_allclose(U, np.asarray(JO.orth(jnp.asarray(V))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(U, polar(V)[0], atol=1e-9)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 4)))
    np.testing.assert_allclose(
        T.orbital_optimization.orth(torch.as_tensor(Q)).numpy(), Q,
        atol=1e-10)


def _brockett(U, A, B):
    """tr(U^T A U B): minimized by eigenvectors of A paired to B's order."""
    return (U.T @ A @ U @ B).trace()


def _brockett_problem(seed, m, diag):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, m))
    return (A + A.T) / 2, np.diag(diag)


def test_bb_descent_brockett_minimum():
    """Known global minimum (Brockett cost on the Stiefel manifold); the
    port and the JAX package agree to 1e-10 on the same start."""
    A, B = _brockett_problem(3, 10, [3.0, 2.0, 1.0])
    w = np.linalg.eigvalsh(A)
    expected = w[0] * 3.0 + w[1] * 2.0 + w[2] * 1.0
    kw = dict(initial_BBstepsize=1e-2, stopping_tolerance=1e-12,
              maxiter=20000)
    U0 = np.eye(10)[:, :3]
    U, E = P.PartialUnitaryProjectionOptimizer(
        **kw, **CPU).compute_optimal_rotation(_brockett, U0, A, B)
    _, Ej = J.PartialUnitaryProjectionOptimizer(**kw).compute_optimal_rotation(
        lambda U, A, B: jnp.trace(U.T @ A @ U @ B), U0, jnp.asarray(A),
        jnp.asarray(B))
    np.testing.assert_allclose(E, expected, atol=1e-6)
    assert abs(E - Ej) <= 1e-10
    np.testing.assert_allclose(U.T @ U, torch.eye(3, dtype=U.dtype),
                               atol=1e-9)


def test_callback_replay_and_result_fields():
    A, B = _brockett_problem(4, 6, [1.0, 0.5])
    seen = []
    opt = P.PartialUnitaryProjectionOptimizer(
        initial_BBstepsize=1e-2, stopping_tolerance=1e-8, maxiter=5000,
        callback=lambda it, e: seen.append((it, e)), **CPU)
    U, E = opt.compute_optimal_rotation(_brockett, np.eye(6)[:, :2], A, B)
    assert len(seen) == opt.last_result.iterations + 1
    assert seen[0][0] == 0
    np.testing.assert_allclose(seen[-1][1], E, atol=1e-9)
    assert opt.last_result.converged
    np.testing.assert_allclose(opt.last_result.partial_unitary, U.numpy())


def test_finite_difference_matches_autograd():
    A, B = _brockett_problem(5, 6, [2.0, 1.0])
    kw = dict(initial_BBstepsize=1e-2, stopping_tolerance=1e-10,
              maxiter=5000, **CPU)
    U0 = np.eye(6)[:, :2]
    _, E_auto = P.PartialUnitaryProjectionOptimizer(
        **kw).compute_optimal_rotation(_brockett, U0, A, B)
    _, E_fd = P.PartialUnitaryProjectionOptimizer(
        gradient_method="finite_difference",
        **kw).compute_optimal_rotation(_brockett, U0, A, B)
    np.testing.assert_allclose(E_auto, E_fd, atol=1e-6)


def test_bb_loop_is_the_jax_loop_step_for_step():
    """_bb_projected_descent's energy trace against the JAX loop's."""
    from esoo_tpu.orbital_optimization.stiefel import (
        _bb_projected_descent as jax_bb)
    import jax
    A, B = _brockett_problem(6, 7, [2.0, 1.0])
    U0 = np.eye(7)[:, :2]
    f64 = torch.float64
    _, _, k, _, tr = _bb_projected_descent(
        value_and_grad(_brockett), torch.as_tensor(U0),
        (torch.as_tensor(A), torch.as_tensor(B)),
        *(torch.tensor(v, dtype=f64) for v in (1e-2, 1e-9, 0.8)), 500)
    _, _, kj, _, trj = jax_bb(
        jax.value_and_grad(lambda U, A, B: jnp.trace(U.T @ A @ U @ B)), 2,
        (jnp.asarray(U0), jnp.asarray(A), jnp.asarray(B)),
        jnp.asarray(1e-2), jnp.asarray(1e-9), jnp.asarray(0.8), 500)
    assert k == int(kj)
    np.testing.assert_allclose(tr.numpy(), np.asarray(trj)[: k + 1],
                               rtol=0, atol=1e-10)


# --- tests/test_complex_rdm.py -----------------------------------------------

def _complex_circuit(ns):
    """A 4-qubit state with genuinely complex amplitudes in the (1, 1)
    sector: HF and a double excitation with a relative phase."""
    qc = ns.QuantumCircuit(4)
    qc.x(0)
    qc.x(2)
    qc.ry(0.7, 1)
    qc.cx(1, 3)
    qc.cx(1, 0)
    qc.cx(3, 2)
    qc.rz(0.9, 1)
    return qc


@pytest.fixture(scope="module")
def complex_state():
    from esoo_tpu.sim.statevector import compile_circuit as jcc
    sv = T.sim.statevector(_complex_circuit(P), device="cpu")
    np.testing.assert_allclose(sv.numpy(), np.asarray(
        jcc(_complex_circuit(J)).state()), rtol=0, atol=1e-12)
    assert np.abs(sv.imag.numpy()).max() > 0.05
    return sv


def _complex_solvers(h2_631g, **kw):
    it = h2_631g.integral_tensors()
    return (JB.BaseOptOrbSolver(num_spin_orbitals=4, integral_tensors=it,
                                **kw),
            TB.BaseOptOrbSolver(num_spin_orbitals=4, integral_tensors=it,
                                **kw, **CPU))


def test_complex_rdms_have_imaginary_parts(h2_631g, complex_state):
    sj, sp = _complex_solvers(h2_631g)
    gamma, Gamma = sp.measure_rdms_direct(complex_state)
    assert gamma.is_complex()
    assert Gamma.imag.abs().max() > 1e-3
    g = gamma.numpy()
    np.testing.assert_allclose(g, g.conj().T, atol=1e-12)
    gj, Gj = sj.measure_rdms_direct(complex_state.numpy())
    np.testing.assert_allclose(gamma.numpy(), gj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Gamma.numpy(), Gj, rtol=0, atol=1e-12)


def test_complex_objective_matches_direct_expectation(h2_631g,
                                                      complex_state):
    """E(U) from the complex-RDM objective == <psi|H(U)|psi> from the
    statevector and the rotated Hamiltonian, at U0 and a rotated U: the
    physically correct E1 + E2, which is also the JAX package's value."""
    from esoo_torch.sim import rdm_energy
    sj, sp = _complex_solvers(h2_631g)
    gamma, Gamma = sp.measure_rdms_direct(complex_state)
    objective, data = sp._inner_objective_and_data([gamma], [Gamma])
    assert objective in (TB._spatial_objective_complex,
                         TB._so_objective_complex)
    assert data[0].is_complex()
    gj, Gj = sj.measure_rdms_direct(complex_state.numpy())
    obj_j, data_j = sj._inner_objective_and_data([gj], [Gj])
    U0 = sp.initial_partial_unitary
    U1 = sp.orth(U0 + 0.1 * np.random.default_rng(3).normal(size=U0.shape))
    for U in (U0, U1):
        e_obj = float(objective(torch.as_tensor(U), *data))
        h_so, g_so = sp.get_rotated_hamiltonian(U)._fermionic_tensors
        e_direct = float(rdm_energy(complex_state, h_so, g_so))
        np.testing.assert_allclose(e_obj, e_direct, atol=1e-10)
        np.testing.assert_allclose(
            e_obj, float(obj_j(jnp.asarray(U), *data_j)), atol=1e-12)


def test_inner_optimization_with_complex_rdms(h2_631g, complex_state):
    """The Stiefel/BB descent runs on complex RDM data: the energy
    decreases, U stays on the manifold, and E matches the JAX package."""
    sj, sp = _complex_solvers(h2_631g)
    gamma, Gamma = sp.measure_rdms_direct(complex_state)
    objective, data = sp._inner_objective_and_data([gamma], [Gamma])
    U0 = torch.as_tensor(sp.initial_partial_unitary)
    e0 = float(objective(U0, *data))
    opt = P.PartialUnitaryProjectionOptimizer(1e-3, 1e-6, 5000, **CPU)
    U_opt, e_opt = sp._run_inner_optimization(opt, U0, [gamma], [Gamma])
    assert e_opt <= e0 + 1e-12
    np.testing.assert_allclose(U_opt.T @ U_opt, torch.eye(2,
                                                          dtype=U_opt.dtype),
                               atol=1e-8)
    gj, Gj = sj.measure_rdms_direct(complex_state.numpy())
    _, e_j = sj._run_inner_optimization(
        J.PartialUnitaryProjectionOptimizer(1e-3, 1e-6, 5000),
        sj.initial_partial_unitary, [gj], [Gj])
    assert abs(e_opt - e_j) <= 1e-10


def test_wavefunction_real_flag_forces_real_path(h2_631g, complex_state):
    _, sp = _complex_solvers(h2_631g, wavefuntion_real=True)
    gamma, Gamma = sp.measure_rdms_direct(complex_state)
    objective, data = sp._inner_objective_and_data([gamma], [Gamma])
    assert not data[0].is_complex()
    assert objective is TB._spatial_objective


# --- tests/test_interop.py ---------------------------------------------------

def _fake_qn_problem(h_so, g_phys_signed, num_particles, e_nn=0.0):
    """Duck-typed qiskit-nature ElectronicStructureProblem (chemist-order
    two-body coefficients, so the adapter's transpose runs)."""

    class Integrals:
        def second_q_coeffs(self):
            chem = (-1.0 * g_phys_signed).transpose(0, 2, 1, 3)
            return {"+-": h_so, "++--": chem}

    class Hamiltonian:
        electronic_integrals = Integrals()
        nuclear_repulsion_energy = e_nn

    class Problem:
        hamiltonian = Hamiltonian()

    Problem.num_particles = num_particles
    return Problem()


def _fake(h2_631g):
    h, g = h2_631g.integral_tensors()
    return _fake_qn_problem(h, g, h2_631g.num_particles,
                            h2_631g.nuclear_repulsion_energy)


def test_detection_and_tensor_identity(h2_631g):
    fake = _fake(h2_631g)
    assert TI.is_qiskit_nature_problem(fake)
    assert not TI.is_qiskit_nature_problem(h2_631g)
    h, g = h2_631g.integral_tensors()
    h2, g2 = TI.from_qiskit_nature(fake).integral_tensors()
    hj, gj = JI.from_qiskit_nature(fake).integral_tensors()
    np.testing.assert_allclose(h2, h, atol=1e-14)
    np.testing.assert_allclose(g2, g, atol=1e-14)
    np.testing.assert_array_equal(g2, gj)


def test_optorbvqe_runs_on_qiskit_nature_problem(problems, h2_631g):
    fake = _fake(h2_631g)
    rj, rp = (optorbvqe(ns, problems, problem=fake,
                        maxiter=20).compute_minimum_energy()
              for ns in (J, P))
    assert_runs_agree(rj, rp)
    np.testing.assert_array_almost_equal(rp.eigenvalue, E_OPTORB_VQE,
                                         decimal=3)


@pytest.mark.parametrize("kind", ["vqe", "mcvqe"])
def test_fused_runs_on_qiskit_nature_problem(h2_631g, kind):
    """test_fused_runs_on_qiskit_nature_problem and
    test_fused_mcvqe_runs_on_qiskit_nature_problem."""
    fake = _fake(h2_631g)
    if kind == "vqe":
        r = T.FusedOptOrbVQE(4, P.UCCSD(2, (1, 1), initial_state=P.HartreeFock(
            2, (1, 1))), problem=fake, maxiter=20, **CPU
        ).compute_minimum_energy()
        np.testing.assert_array_almost_equal(r.eigenvalue, E_OPTORB_VQE,
                                             decimal=3)
    else:
        r = T.FusedOptOrbMCVQE(
            num_spin_orbitals=4, ansatz=P.UCCSD(2, (1, 1), reps=2),
            num_particles=(1, 1), k=2, excitations="s",
            weight_vector=[2, 1], problem=fake, maxiter=20, **CPU
        ).compute_energies()
        np.testing.assert_array_almost_equal(r.eigenvalues, E_OPTORB_MCVQE,
                                             decimal=3)


def test_wrap_qiskit_mapper_by_provenance():
    from esoo_torch.ops import (BravyiKitaevMapper, JordanWignerMapper,
                                ParityMapper)

    def fake(name, **attrs):
        cls = type(name, (), dict(attrs))
        cls.__module__ = "qiskit_nature.second_q.mappers"
        return cls()

    assert isinstance(TI.wrap_qiskit_mapper(fake("JordanWignerMapper")),
                      JordanWignerMapper)
    assert isinstance(TI.wrap_qiskit_mapper(fake("ParityMapper")),
                      ParityMapper)
    assert isinstance(TI.wrap_qiskit_mapper(fake("BravyiKitaevMapper")),
                      BravyiKitaevMapper)
    with pytest.raises(ValueError, match="two-qubit reduction"):
        TI.wrap_qiskit_mapper(fake("ParityMapper", num_particles=(1, 1)))
    with pytest.raises(ValueError, match="no native equivalent"):
        TI.wrap_qiskit_mapper(fake("InterleavedQubitMapper"))
    native = JordanWignerMapper()
    assert TI.adapt(None, native)[1] is native


def test_adapt_in_solver_ctor_with_fake_mapper(problems):
    from esoo_torch.ops import JordanWignerMapper
    jw_fake = type("JordanWignerMapper", (), {})
    jw_fake.__module__ = "qiskit_nature.second_q.mappers"
    solver = optorbvqe(P, problems, mapper=jw_fake(), maxiter=2)
    assert isinstance(solver.mapper, JordanWignerMapper)


# --- the chip smoke's constants ------------------------------------------

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.slow
def test_jax_class_path_constants_of_the_smoke():
    """Recompute chip_smoke.py's JAX_H4_OPTORB_F64 (the JAX class path at
    examples/H4_OptOrbVQE.py's settings: H4 cc-pVTZ -> 8, UCCSD from HF,
    zero start, L-BFGS-B, maxiter 20, float64) and JAX_H2_TZ_OPTORB_F64
    (H2 cc-pVTZ -> 4), and the port's CPU runs against them (~2 min)."""
    from esoo_tpu.chem import MoleculeDriver
    smoke = _smoke()
    for geom, n_act, const in (
            (smoke.H4_GEOM, 4, smoke.JAX_H4_OPTORB_F64),
            (smoke.H2_GEOM, 2, smoke.JAX_H2_TZ_OPTORB_F64)):
        jp = MoleculeDriver(atom=geom, basis="cc-pvtz").run()
        tp = problem_from_numpy(dataclasses.asdict(jp))
        energies = []
        for ns, prob in ((J, jp), (P, tp)):
            parts = prob.num_particles
            ansatz = ns.UCCSD(n_act, parts,
                              initial_state=ns.HartreeFock(n_act, parts))
            vqe = ns.VQE(ns.Estimator(**ns.dk), ansatz, ns.L_BFGS_B(),
                         initial_point=np.zeros(ansatz.num_parameters),
                         **ns.dk)
            energies.append(ns.OptOrbVQE(
                num_spin_orbitals=2 * n_act, ground_state_solver=vqe,
                partial_unitary_optimizer=pupo(ns), problem=prob,
                maxiter=20, wavefuntion_real=True, spin_conserving=True,
                **ns.dk).compute_minimum_energy().eigenvalue)
        assert abs(energies[0] - const) <= 1e-9
        assert abs(energies[1] - const) <= 1e-7
