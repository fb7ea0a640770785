"""esoo_torch's class-based eigensolvers (VQE, SSVQE, MCVQE, VQD,
AdaptVQE), their evaluators (solvers/energy.py) and the optimizers,
against esoo_tpu: float64 on the CPU, on H2 STO-3G (4 qubits, the JAX
Hamiltonian crossing as its Pauli masks and (h, g)) and the reference's
2-qubit H2 Pauli Hamiltonian.

Mirrors tests/test_eigensolvers.py and test_eigensolvers_matrix.py case
for case.  Tolerances: make_evaluators' value and gradient 1e-10 of the
JAX package's; solver energies 1e-7 of its (host optimizers stop on
their own tests); the reference values at the JAX tests' tolerances."""

import functools
import types

import numpy as np
import pytest
import torch

import esoo_torch as T
import esoo_tpu.ops as JOps
import esoo_tpu.sim as JS
import esoo_tpu.solvers as JV
from esoo_torch.convert import pauli_op_from_numpy
from esoo_torch.ops import SparsePauliOp
from esoo_torch.solvers import (NumPyEigensolver, NumPyMinimumEigensolver,
                                OptimizerResult)
from esoo_torch.solvers.energy import make_evaluators
from esoo_tpu.solvers.energy import make_evaluators as jax_make_evaluators
from test_torch_engine import same_eri_engine  # noqa: F401

# the JAX package's simulator and solvers as one namespace, like esoo_torch's
J = types.SimpleNamespace(**{k: getattr(m, k) for m in (JS, JV)
                             for k in dir(m) if not k.startswith("_")})
GROUND = -1.85727503
EXCITED_1 = -1.24458455
CPU = {"device": "cpu"}

# the reference's inline 2-qubit H2 Hamiltonian (test_ssvqe.py:65-75)
H2_LIST = [("II", -1.052373245772859), ("IZ", 0.39793742484318045),
           ("ZI", -0.39793742484318045), ("ZZ", -0.01128010425623538),
           ("XX", 0.18093119978423156)]
H2_PAULI = SparsePauliOp.from_list(H2_LIST)
H2_ENERGIES = [-1.85727503, -1.24458455]
AUX_OP1 = SparsePauliOp.from_list([("II", 2.0)])
AUX_OP2 = SparsePauliOp.from_list(
    [("II", 0.5), ("ZZ", 0.5), ("YY", 0.5), ("XX", -0.5)])


@pytest.fixture(scope="module")
def H(h2_sto3g_hamiltonian):
    """The JAX H2 STO-3G Hamiltonian as the port's operator."""
    jh = h2_sto3g_hamiltonian
    op = pauli_op_from_numpy(*jh.mask_arrays()[:2], jh.coeffs, jh.num_qubits)
    op.fermionic = tuple(np.asarray(a) for a in jh.fermionic)
    return op


def uccsd(pkg=T, **kw):
    return pkg.UCCSD(2, (1, 1), initial_state=pkg.HartreeFock(2, (1, 1)),
                     **kw)


def ryrz():
    return T.TwoLocal(2, ["ry", "rz"], "cz", reps=1)


def ry():
    return T.TwoLocal(2, "ry", "cz")


def test_exact_solver(H):
    res = NumPyMinimumEigensolver().compute_minimum_eigenvalue(H)
    np.testing.assert_allclose(res.eigenvalue, GROUND, atol=1e-7)
    res = NumPyEigensolver(k=2).compute_eigenvalues(H)
    assert res.eigenvalues.shape == (2,)


# --- the evaluators ---------------------------------------------------------

def _pair_circuits(route):
    if route == "sector":
        return uccsd(J), uccsd(T)
    if route in ("fermionic", "pauli_real"):
        return JS.RealAmplitudes(4, reps=2), T.RealAmplitudes(4, reps=2)
    return (JS.TwoLocal(4, ["ry", "rz"], "cz", reps=1),
            T.TwoLocal(4, ["ry", "rz"], "cz", reps=1))


@pytest.mark.parametrize("route", ["sector", "fermionic", "pauli_real",
                                   "pauli_complex"])
def test_make_evaluators_match_jax(h2_sto3g_hamiltonian, H, route):
    """Value and gradient at seeded points on each route, 1e-10."""
    jc, tc = _pair_circuits(route)
    jh = h2_sto3g_hamiltonian
    th = H
    if route.startswith("pauli"):
        jh = JOps.SparsePauliOp((list(jh.xs), list(jh.zs)), jh.coeffs,
                                num_qubits=4)
        th = pauli_op_from_numpy(*H.mask_arrays()[:2], H.coeffs, 4)
    je, jv = jax_make_evaluators(jc, jh)
    te, tv = make_evaluators(tc, th, "cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = rng.normal(0, 0.5, tc.num_parameters)
        vj, gj = jv(x)
        vt, gt = tv(x)
        assert abs(vt - vj) <= 1e-10 and abs(te(x) - je(x)) <= 1e-10
        np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-10)


# --- tests/test_eigensolvers.py ------------------------------------------------

def _vqe(pkg, ansatz, optimizer, **kw):
    dk = CPU if pkg is T else {}
    return pkg.VQE(pkg.Estimator(**dk), ansatz, optimizer,
                   initial_point=np.zeros(ansatz.num_parameters), **dk, **kw)


class TestVQE:
    def test_ground_state(self, h2_sto3g_hamiltonian, H):
        res = _vqe(T, uccsd(), T.L_BFGS_B()).compute_minimum_eigenvalue(H)
        np.testing.assert_allclose(res.eigenvalue, GROUND, atol=1e-5)
        ref = _vqe(J, uccsd(J), JV.L_BFGS_B()
                   ).compute_minimum_eigenvalue(h2_sto3g_hamiltonian)
        assert abs(res.eigenvalue - ref.eigenvalue) <= 1e-7

    def test_callback_invoked(self, h2_sto3g_hamiltonian, H):
        seen = []
        res = _vqe(T, uccsd(), T.L_BFGS_B(),
                   callback=lambda n, p, e, m: seen.append((n, e))
                   ).compute_minimum_eigenvalue(H)
        assert len(seen) > 0
        assert [n for n, _ in seen] == list(range(1, len(seen) + 1))
        assert res.cost_function_evals == len(seen)
        seen_j = []
        _vqe(J, uccsd(J), JV.L_BFGS_B(),
             callback=lambda n, p, e, m: seen_j.append(e)
             ).compute_minimum_eigenvalue(h2_sto3g_hamiltonian)
        assert len(seen_j) == len(seen)

    def test_qubit_mismatch_raises(self, H):
        bad = T.UCCSD(3, (1, 1), initial_state=T.HartreeFock(3, (1, 1)))
        with pytest.raises(T.AlgorithmError):
            _vqe(T, bad, T.L_BFGS_B()).compute_minimum_eigenvalue(H)

    def test_unparameterized_ansatz_raises(self, H):
        with pytest.raises(T.AlgorithmError):
            T.VQE(T.Estimator(**CPU), T.HartreeFock(2, (1, 1)),
                  T.L_BFGS_B(), **CPU).compute_minimum_eigenvalue(H)

    def test_aux_operators(self, H):
        num_op = SparsePauliOp.from_list(
            [("IIII", 2.0), ("IIIZ", -0.5), ("IIZI", -0.5),
             ("IZII", -0.5), ("ZIII", -0.5)])  # total particle number
        res = _vqe(T, uccsd(), T.L_BFGS_B()).compute_minimum_eigenvalue(
            H, aux_operators=[num_op])
        np.testing.assert_allclose(res.aux_operators_evaluated[0][0], 2.0,
                                   atol=1e-8)


def _ssvqe(pkg, **kw):
    ansatz = pkg.UCCSD(2, (1, 1), reps=2)
    init1 = pkg.QuantumCircuit(4)
    init1.x(1)
    init1.x(2)
    # a zero start is a symmetric saddle for the second state; a small
    # seeded random start breaks it (tests/test_eigensolvers.py)
    x0 = np.random.default_rng(2).normal(0, 0.1, ansatz.num_parameters)
    defaults = dict(k=2, ansatz=ansatz, optimizer=pkg.L_BFGS_B(),
                    initial_states=[pkg.HartreeFock(2, (1, 1)), init1],
                    weight_vector=[2, 1], initial_point=x0)
    defaults.update(kw)
    return pkg.SSVQE(**defaults, **(CPU if pkg is T else {}))


class TestSSVQE:
    def test_two_lowest_states(self, h2_sto3g_hamiltonian, H):
        res = _ssvqe(T).compute_eigenvalues(H)
        np.testing.assert_allclose(res.eigenvalues[0], GROUND, atol=1e-5)
        np.testing.assert_allclose(res.eigenvalues[1], EXCITED_1, atol=1e-5)
        ref = _ssvqe(J).compute_eigenvalues(h2_sto3g_hamiltonian)
        np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                                   rtol=0, atol=1e-7)
        assert res.cost_function_evals == ref.cost_function_evals

    def test_wrong_weight_count_raises(self, H):
        with pytest.raises(T.AlgorithmError):
            _ssvqe(T, weight_vector=[1, 2, 3]).compute_eigenvalues(H)

    def test_non_orthogonal_initial_states_raise(self, H):
        same = T.HartreeFock(2, (1, 1))
        with pytest.raises(T.AlgorithmError):
            _ssvqe(T, initial_states=[same, same.copy()]
                   ).compute_eigenvalues(H)

    def test_wrong_initial_state_count_raises(self, H):
        with pytest.raises(T.AlgorithmError):
            _ssvqe(T, initial_states=[T.HartreeFock(2, (1, 1))]
                   ).compute_eigenvalues(H)

    def test_callback(self, H):
        seen = []
        res = _ssvqe(T, callback=lambda n, p, e, m: seen.append(e)
                     ).compute_eigenvalues(H)
        assert len(seen) == res.cost_function_evals
        assert all(len(e) == 2 for e in seen)


class TestMCVQE:
    def test_cis_initialized(self, h2_sto3g, h2_sto3g_hamiltonian, H):
        h, g = h2_sto3g.integral_tensors()
        out = []
        for pkg, op, dk in ((T, H, CPU), (J, h2_sto3g_hamiltonian, {})):
            ansatz = pkg.UCCSD(2, (1, 1), reps=1)
            mc = pkg.MCVQE(k=2, ansatz=ansatz, optimizer=pkg.L_BFGS_B(),
                           num_particles=(1, 1), one_body_integrals=h,
                           two_body_integrals=g, excitations="s",
                           initial_point=np.zeros(ansatz.num_parameters),
                           **dk)
            out.append(mc.compute_eigenvalues(op))
        res = out[0]
        np.testing.assert_allclose(res.eigenvalues[0], GROUND, atol=2e-2)
        np.testing.assert_allclose(res.eigenvalues[1], EXCITED_1, atol=2e-2)
        assert res.contracted_hamiltonian.shape == (2, 2)
        np.testing.assert_allclose(res.contracted_hamiltonian,
                                   out[1].contracted_hamiltonian, rtol=0,
                                   atol=1e-7)


def _vqd(pkg, ansatz, betas, **kw):
    dk = CPU if pkg is T else {}
    return pkg.VQD(pkg.Estimator(**dk), pkg.ComputeUncompute(
        pkg.Sampler(**dk)), ansatz, pkg.L_BFGS_B(), k=2, betas=betas,
        initial_point=np.zeros(ansatz.num_parameters), **dk, **kw)


class TestVQD:
    def test_deflation(self, h2_sto3g_hamiltonian, H):
        res = _vqd(T, uccsd(reps=2), [2, 2]).compute_eigenvalues(H)
        np.testing.assert_allclose(res.eigenvalues[0], GROUND, atol=1e-5)
        assert res.eigenvalues[1] > res.eigenvalues[0] + 0.1
        ref = _vqd(J, uccsd(J, reps=2), [2, 2]).compute_eigenvalues(
            h2_sto3g_hamiltonian)
        np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                                   rtol=0, atol=1e-7)

    def test_auto_betas(self, H):
        res = _vqd(T, uccsd(), None).compute_eigenvalues(H)
        np.testing.assert_allclose(res.eigenvalues[0], GROUND, atol=1e-5)


class TestAdaptVQE:
    def test_ground_state(self, h2_sto3g_hamiltonian, H):
        res = T.AdaptVQE(T.VQE(T.Estimator(**CPU), uccsd(), T.L_BFGS_B(),
                               **CPU)).compute_minimum_eigenvalue(H)
        np.testing.assert_allclose(res.eigenvalue, GROUND, atol=1e-5)
        assert res.num_iterations >= 1
        assert res.termination_criterion is not None
        ref = JV.AdaptVQE(JV.VQE(JS.Estimator(), uccsd(J), JV.L_BFGS_B())
                          ).compute_minimum_eigenvalue(h2_sto3g_hamiltonian)
        assert abs(res.eigenvalue - ref.eigenvalue) <= 1e-7
        assert res.termination_criterion.value == \
            ref.termination_criterion.value

    def test_requires_ucc_ansatz(self, H):
        solver = T.VQE(T.Estimator(**CPU), T.RealAmplitudes(4),
                       T.L_BFGS_B(), **CPU)
        with pytest.raises(T.AlgorithmError):
            T.AdaptVQE(solver).compute_minimum_eigenvalue(H)

    def test_pool_screener_matches_jax(self, h2_sto3g_hamiltonian, H):
        """The growing path's commutator screening, 1e-12."""
        from esoo_torch.solvers.adapt_vqe import _make_pool_screener
        from esoo_tpu.solvers.adapt_vqe import (
            _make_pool_screener as jax_screener)
        import jax.numpy as jnp
        pool = uccsd()._ucc_pool
        sv = T.sim.statevector(uccsd(), np.full(3, 0.3), device="cpu")
        got = _make_pool_screener(pool, H, 4, torch.device("cpu"))(sv)
        want = jax_screener(uccsd(J)._ucc_pool, h2_sto3g_hamiltonian, 4)(
            jnp.asarray(sv.numpy()))
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)


class TestDeviceLBFGS:
    """The counterpart of esoo_tpu.solvers.JaxBFGS (TestJaxBFGS)."""

    def test_vqe_one_dispatch(self, h2_sto3g_hamiltonian, H):
        res = _vqe(T, uccsd(), T.DeviceLBFGS(**CPU)
                   ).compute_minimum_eigenvalue(H)
        np.testing.assert_allclose(res.eigenvalue, GROUND, atol=1e-6)
        assert res.cost_function_evals > 0
        ref = _vqe(J, uccsd(J), JV.JaxBFGS()).compute_minimum_eigenvalue(
            h2_sto3g_hamiltonian)
        assert abs(res.eigenvalue - ref.eigenvalue) <= 1e-7

    def test_optorb_with_device_lbfgs(self, h2_631g):
        import dataclasses
        from esoo_torch.convert import problem_from_numpy
        p = problem_from_numpy(dataclasses.asdict(h2_631g))
        r = T.OptOrbVQE(
            num_spin_orbitals=4,
            ground_state_solver=_vqe(T, uccsd(), T.DeviceLBFGS(**CPU)),
            partial_unitary_optimizer=T.PartialUnitaryProjectionOptimizer(
                1e-3, 1e-5, 10000, **CPU),
            problem=p, maxiter=20, **CPU).compute_minimum_energy()
        np.testing.assert_array_almost_equal(r.eigenvalue,
                                             -1.8661038079694765, decimal=3)

    def test_static_and_growing_agree(self, H):
        def run(static):
            return T.AdaptVQE(T.VQE(T.Estimator(**CPU), uccsd(),
                                    T.L_BFGS_B(), **CPU),
                              static_shapes=static
                              ).compute_minimum_eigenvalue(H).eigenvalue
        np.testing.assert_allclose(run(True), run(False), atol=1e-7)


# --- the optimizers -------------------------------------------------------

def _quadratic():
    A = np.diag([1.0, 3.0, 0.5])
    b = np.array([0.3, -0.2, 0.7])
    return (lambda x: float(0.5 * x @ A @ x - b @ x)), \
        (lambda x: A @ x - b), np.linalg.solve(A, b)


@pytest.mark.parametrize("name,kw", [
    ("GradientDescent", dict(maxiter=200, learning_rate=0.2)),
    ("ADAM", dict(maxiter=300, learning_rate=0.05)),
    ("SPSA", dict(maxiter=200, seed=3)),
    ("L_BFGS_B", {}), ("SLSQP", {}), ("CG", {}), ("COBYLA", {}),
    ("NELDER_MEAD", dict(maxiter=2000)), ("POWELL", {})])
def test_optimizers_match_jax(name, kw):
    """The same host arithmetic (and SPSA's seeded perturbation stream)
    as the JAX package's optimizers: identical iterates."""
    fun, jac, xstar = _quadratic()
    x0 = np.zeros(3)
    got = getattr(T, name)(**kw).minimize(fun, x0, jac=jac)
    want = getattr(JV, name)(**kw).minimize(fun, x0, jac=jac)
    np.testing.assert_array_equal(got.x, want.x)
    assert (got.nfev, got.nit) == (want.nfev, want.nit)
    if name != "SPSA":
        np.testing.assert_allclose(got.x, xstar, atol=1e-2)


# --- tests/test_eigensolvers_matrix.py -----------------------------------------

def make_solver(cls, **kw):
    kw.setdefault("estimator", T.Estimator(**CPU))
    kw.setdefault("k", 2)
    kw.setdefault("optimizer", T.SLSQP())
    kw.setdefault("initial_point",
                  np.linspace(0.1, 1.0, kw["ansatz"].num_parameters))
    return cls(**kw, **CPU)


def _mock_optimizer(fun, x0, jac=None, bounds=None, inputs=None):
    inputs.update({"fun": fun, "x0": x0, "jac": jac, "bounds": bounds})
    return OptimizerResult(x=np.asarray(x0), fun=float(fun(x0)), nfev=1)


@pytest.mark.parametrize("cls", [T.SSVQE, T.MCVQE])
class TestSolverMatrix:
    def test_basic_operator(self, cls):
        solver = make_solver(cls, ansatz=ryrz(), optimizer=T.COBYLA(),
                             initial_point=None)
        result = solver.compute_eigenvalues(H2_PAULI)
        np.testing.assert_array_almost_equal(
            np.real(result.eigenvalues), H2_ENERGIES, decimal=1)
        assert len(result.optimal_point) == 8
        assert result.cost_function_evals is not None
        assert result.optimizer_time is not None

    def test_mismatching_num_qubits(self, cls):
        qc = T.QuantumCircuit(1)
        qc.ry(qc.parameter(), 0)
        solver = make_solver(cls, k=1, ansatz=qc, initial_point=[0.0])
        with pytest.raises(T.AlgorithmError):
            solver.compute_eigenvalues(H2_PAULI)

    def test_missing_ansatz_params(self, cls):
        solver = make_solver(cls, ansatz=T.QuantumCircuit(2),
                             initial_point=None)
        with pytest.raises(T.AlgorithmError):
            solver.compute_eigenvalues(H2_PAULI)

    def test_wrong_initial_point_size_raises(self, cls):
        solver = make_solver(cls, ansatz=ry(), initial_point=[0.1, 0.2])
        with pytest.raises(T.AlgorithmError):
            solver.compute_eigenvalues(H2_PAULI)

    def test_callback_history(self, cls):
        history = {"count": [], "params": [], "energies": [], "meta": []}

        def cb(count, params, energies, metadata):
            history["count"].append(count)
            history["params"].append(params)
            history["energies"].append(energies)
            history["meta"].append(metadata)

        make_solver(cls, ansatz=ry(), optimizer=T.COBYLA(maxiter=3),
                    callback=cb).compute_eigenvalues(H2_PAULI)
        n = len(history["count"])
        assert n >= 3
        assert history["count"] == list(range(1, n + 1))
        for params in history["params"]:
            assert params.shape == (ry().num_parameters,)
        for en in history["energies"]:
            assert np.asarray(en).shape == (2,)
            assert np.all(np.isfinite(en))
        assert all(isinstance(m, dict) for m in history["meta"])

    def test_optimizer_reuse_and_swap(self, cls):
        solver = make_solver(cls, ansatz=T.RealAmplitudes(2, reps=6),
                             optimizer=T.SLSQP(), initial_point=None)

        def run_check():
            result = solver.compute_eigenvalues(H2_PAULI)
            np.testing.assert_array_almost_equal(
                np.real(result.eigenvalues), H2_ENERGIES, decimal=3)

        run_check()
        run_check()
        solver.optimizer = T.L_BFGS_B()
        run_check()

    @pytest.mark.parametrize("optimizer_cls", ["CG", "L_BFGS_B", "SLSQP"])
    def test_gradient_optimizers_decimal5(self, cls, optimizer_cls):
        solver = make_solver(cls, ansatz=ry(),
                             optimizer=getattr(T, optimizer_cls)(),
                             weight_vector=[2, 1])
        result = solver.compute_eigenvalues(H2_PAULI)
        np.testing.assert_array_almost_equal(
            np.real(result.eigenvalues), H2_ENERGIES, decimal=5)

    def test_gradient_descent_run(self, cls):
        solver = make_solver(
            cls, ansatz=ry(),
            optimizer=T.GradientDescent(maxiter=300, learning_rate=0.1))
        result = solver.compute_eigenvalues(H2_PAULI)
        np.testing.assert_array_almost_equal(
            np.real(result.eigenvalues), H2_ENERGIES, decimal=4)

    def test_gradient_passed_to_optimizer(self, cls):
        inputs = {}
        marker = []

        def my_gradient(theta):
            marker.append(1)
            return np.zeros_like(np.asarray(theta))

        make_solver(cls, ansatz=ry(),
                    optimizer=functools.partial(_mock_optimizer,
                                                inputs=inputs),
                    gradient=my_gradient).compute_eigenvalues(H2_PAULI)
        assert inputs["jac"] is not None
        np.testing.assert_array_equal(
            inputs["jac"](np.zeros(ry().num_parameters)),
            np.zeros(ry().num_parameters))
        assert marker

    def test_bounds_passed_to_optimizer(self, cls):
        inputs = {}
        ansatz = ry()
        make_solver(cls, ansatz=ansatz,
                    optimizer=functools.partial(_mock_optimizer,
                                                inputs=inputs)
                    ).compute_eigenvalues(H2_PAULI)
        assert inputs["bounds"] is not None
        assert len(inputs["bounds"]) == ansatz.num_parameters
        lo, hi = inputs["bounds"][0]
        assert lo < 0 < hi

    def test_max_evals_grouped_batch(self, cls):
        captured = {}

        def grouped_optimizer(fun, x0, jac=None, bounds=None):
            batch = np.concatenate([x0, x0 + 0.1, x0 - 0.1])
            captured["vals"] = np.asarray(fun(batch))
            captured["singles"] = [fun(x0), fun(x0 + 0.1), fun(x0 - 0.1)]
            return OptimizerResult(x=np.asarray(x0),
                                   fun=float(captured["singles"][0]),
                                   nfev=6)

        make_solver(cls, ansatz=ry(), optimizer=grouped_optimizer,
                    max_evals_grouped=3).compute_eigenvalues(H2_PAULI)
        assert captured["vals"].shape == (3,)
        np.testing.assert_allclose(captured["vals"], captured["singles"],
                                   atol=1e-12)

    def test_max_evals_grouped_slsqp(self, cls):
        solver = make_solver(cls, ansatz=T.RealAmplitudes(2, reps=6),
                             optimizer=T.SLSQP(), max_evals_grouped=5,
                             initial_point=None)
        result = solver.compute_eigenvalues(H2_PAULI)
        np.testing.assert_array_almost_equal(
            np.real(result.eigenvalues), H2_ENERGIES, decimal=5)

    def test_aux_operators_list(self, cls):
        solver = make_solver(cls, ansatz=ry())
        result = solver.compute_eigenvalues(H2_PAULI, aux_operators=[])
        np.testing.assert_array_almost_equal(
            np.real(result.eigenvalues), H2_ENERGIES, decimal=2)
        assert result.aux_operators_evaluated is None
        result = solver.compute_eigenvalues(
            H2_PAULI, aux_operators=[AUX_OP1, AUX_OP2])
        per_state = result.aux_operators_evaluated
        assert len(per_state) == 2
        assert len(per_state[0]) == 2
        np.testing.assert_allclose(per_state[0][0][0], 2.0, atol=1e-2)
        np.testing.assert_allclose(per_state[0][1][0], 0.0, atol=2e-1)
        assert isinstance(per_state[0][0][1], dict)
        result = solver.compute_eigenvalues(
            H2_PAULI, aux_operators=[AUX_OP1, AUX_OP2, None, 0])
        per_state = result.aux_operators_evaluated
        assert len(per_state[0]) == 4
        assert per_state[0][2][0] == 0.0 and per_state[0][3][0] == 0.0
        assert isinstance(per_state[0][2][1], dict)
        assert isinstance(per_state[0][3][1], dict)

    def test_aux_operators_dict(self, cls):
        solver = make_solver(cls, ansatz=ry())
        result = solver.compute_eigenvalues(H2_PAULI, aux_operators={})
        assert result.aux_operators_evaluated is None
        aux = {"aux_op1": AUX_OP1, "aux_op2": AUX_OP2,
               "None_operator": None, "zero_operator": 0}
        per_state = solver.compute_eigenvalues(
            H2_PAULI, aux_operators=aux).aux_operators_evaluated
        assert len(per_state) == 2
        assert len(per_state[0]) == 3
        np.testing.assert_allclose(per_state[0]["aux_op1"][0], 2.0,
                                   atol=1e-6)
        assert per_state[0]["zero_operator"][0] == 0.0
        assert "None_operator" not in per_state[0]
        assert isinstance(per_state[0]["zero_operator"][1], dict)

    def test_shots_std_dev_metadata(self, cls):
        meta = []
        make_solver(cls, ansatz=ry(),
                    estimator=T.Estimator(shots=2048, seed=50, **CPU),
                    optimizer=T.COBYLA(maxiter=2),
                    callback=lambda c, p, e, m: meta.append(m)
                    ).compute_eigenvalues(H2_PAULI)
        assert meta
        for m in meta:
            assert m["shots"] == 2048
            assert np.asarray(m["variance"]).shape == (2,)
            assert np.all(np.asarray(m["variance"]) >= 0.0)
            assert np.asarray(m["std_dev"]).shape == (2,)


def test_ssvqe_and_mcvqe_match_jax_on_the_pauli_hamiltonian():
    """The complex-circuit Pauli path of both solvers against the JAX
    package's: energies, the weighted optimum and the evaluation count."""
    jh = JOps.SparsePauliOp.from_list(H2_LIST)
    for name in ("SSVQE", "MCVQE"):
        res = []
        for pkg, op, dk in ((T, H2_PAULI, CPU), (J, jh, {})):
            anz = pkg.TwoLocal(2, "ry", "cz")
            res.append(getattr(pkg, name)(
                k=2, ansatz=anz, optimizer=pkg.L_BFGS_B(),
                initial_point=np.linspace(0.1, 1.0, anz.num_parameters),
                weight_vector=[2, 1], **dk).compute_eigenvalues(op))
        np.testing.assert_allclose(res[0].eigenvalues, res[1].eigenvalues,
                                   rtol=0, atol=1e-7)
        assert res[0].cost_function_evals == res[1].cost_function_evals


class TestSSVQESpecific:
    def test_nonpositive_weights_raise(self):
        with pytest.raises(T.AlgorithmError):
            make_solver(T.SSVQE, ansatz=ry(), weight_vector=[1, -1]
                        ).compute_eigenvalues(H2_PAULI)

    def test_weighted_ordering(self):
        result = make_solver(T.SSVQE, ansatz=ry(), weight_vector=[5, 1],
                             optimizer=T.L_BFGS_B()
                             ).compute_eigenvalues(H2_PAULI)
        assert result.eigenvalues[0] < result.eigenvalues[1]


class TestMCVQESpecific:
    def test_contracted_hamiltonian_shape_and_symmetry(self):
        result = make_solver(T.MCVQE, ansatz=ry(), optimizer=T.L_BFGS_B()
                             ).compute_eigenvalues(H2_PAULI)
        Hc = result.contracted_hamiltonian
        assert Hc.shape == (2, 2)
        np.testing.assert_allclose(Hc, Hc.T, atol=1e-12)
        np.testing.assert_array_almost_equal(
            np.sort(np.linalg.eigvalsh(Hc)), np.real(result.eigenvalues),
            decimal=10)


def _make_vqd(**kw):
    ansatz = kw.pop("ansatz", ry())
    kw.setdefault("k", 2)
    kw.setdefault("betas", [10, 10])
    kw.setdefault("initial_point",
                  np.linspace(0.1, 1.0, ansatz.num_parameters))
    return T.VQD(T.Estimator(**CPU), T.ComputeUncompute(T.Sampler(**CPU)),
                 ansatz, kw.pop("optimizer", T.SLSQP()), **kw, **CPU)


class TestVQDMatrix:
    def test_basic_two_states(self):
        res = _make_vqd(optimizer=T.L_BFGS_B()).compute_eigenvalues(H2_PAULI)
        np.testing.assert_array_almost_equal(
            np.real(res.eigenvalues), H2_ENERGIES, decimal=3)
        assert len(res.optimal_points) == 2
        assert len(res.cost_function_evals) == 2
        assert all(t >= 0 for t in res.optimizer_times)
        anz = JS.TwoLocal(2, "ry", "cz")
        jv = JV.VQD(JS.Estimator(), JS.ComputeUncompute(JS.Sampler()), anz,
                    JV.L_BFGS_B(), k=2, betas=[10, 10],
                    initial_point=np.linspace(0.1, 1.0, anz.num_parameters))
        ref = jv.compute_eigenvalues(JOps.SparsePauliOp.from_list(H2_LIST))
        np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                                   rtol=0, atol=1e-7)
        assert res.cost_function_evals == ref.cost_function_evals

    def test_callback_carries_step_index(self):
        seen = {"steps": set(), "counts": []}

        def cb(count, params, value, meta, step):
            seen["steps"].add(step)
            seen["counts"].append(count)
            assert isinstance(meta, dict)

        _make_vqd(callback=cb, optimizer=T.COBYLA(maxiter=4)
                  ).compute_eigenvalues(H2_PAULI)
        assert seen["steps"] == {1, 2}
        assert seen["counts"][0] == 1

    def test_per_state_ansatz_and_optimizer_lists(self):
        ansatze = [ry(), ry()]
        vqd = T.VQD(T.Estimator(**CPU), T.ComputeUncompute(T.Sampler(**CPU)),
                    ansatze, [T.L_BFGS_B(), T.SLSQP()], k=2, betas=[10],
                    initial_point=[np.linspace(0.1, 1.0, a.num_parameters)
                                   for a in ansatze], **CPU)
        res = vqd.compute_eigenvalues(H2_PAULI)
        np.testing.assert_array_almost_equal(
            np.real(res.eigenvalues), H2_ENERGIES, decimal=3)

    def test_wrong_ansatz_count_raises(self):
        vqd = T.VQD(T.Estimator(**CPU), T.ComputeUncompute(T.Sampler(**CPU)),
                    [ry()], T.L_BFGS_B(), k=2, betas=[10], **CPU)
        with pytest.raises(T.AlgorithmError):
            vqd.compute_eigenvalues(H2_PAULI)

    def test_short_betas_raises(self):
        with pytest.raises(T.AlgorithmError):
            _make_vqd(k=2, betas=[]).compute_eigenvalues(H2_PAULI)

    def test_aux_operators_per_state(self):
        res = _make_vqd(optimizer=T.L_BFGS_B()).compute_eigenvalues(
            H2_PAULI, aux_operators=[AUX_OP1, None, 0])
        per_state = res.aux_operators_evaluated
        assert len(per_state) == 2
        for st in per_state:
            np.testing.assert_allclose(st[0][0], 2.0, atol=1e-8)
            assert st[1][0] == 0.0 and st[2][0] == 0.0
            assert isinstance(st[1][1], dict)


class TestVQDMatrixDepth:
    @pytest.mark.parametrize("optimizer_cls", ["CG", "L_BFGS_B", "SLSQP"])
    def test_gradient_optimizers_decimal5(self, optimizer_cls):
        res = _make_vqd(optimizer=getattr(T, optimizer_cls)()
                        ).compute_eigenvalues(H2_PAULI)
        np.testing.assert_array_almost_equal(
            np.real(res.eigenvalues), H2_ENERGIES, decimal=5)

    def test_optimizer_reuse_and_swap(self):
        solver = _make_vqd(optimizer=T.SLSQP())

        def run_check():
            res = solver.compute_eigenvalues(H2_PAULI)
            np.testing.assert_array_almost_equal(
                np.real(res.eigenvalues), H2_ENERGIES, decimal=3)

        run_check()
        run_check()
        solver.optimizer = T.L_BFGS_B()
        run_check()

    def test_callback_history_exact_counts(self):
        history = {"counts": [], "steps": [], "params": [], "values": []}

        def cb(count, params, value, meta, step):
            history["counts"].append(count)
            history["steps"].append(step)
            history["params"].append(np.asarray(params))
            history["values"].append(value)
            assert isinstance(meta, dict)

        _make_vqd(callback=cb, optimizer=T.COBYLA(maxiter=5)
                  ).compute_eigenvalues(H2_PAULI)
        for step in (1, 2):
            counts = [c for c, s in zip(history["counts"],
                                        history["steps"]) if s == step]
            assert counts == list(range(1, len(counts) + 1))
        assert set(history["steps"]) == {1, 2}
        for p, v in zip(history["params"], history["values"]):
            assert p.shape == (ry().num_parameters,)
            assert np.isfinite(v)

    def test_aux_operators_dict(self):
        solver = _make_vqd(optimizer=T.L_BFGS_B())
        res = solver.compute_eigenvalues(H2_PAULI, aux_operators={})
        assert res.aux_operators_evaluated is None
        aux = {"aux_op1": AUX_OP1, "aux_op2": AUX_OP2,
               "None_operator": None, "zero_operator": 0}
        per_state = solver.compute_eigenvalues(
            H2_PAULI, aux_operators=aux).aux_operators_evaluated
        assert len(per_state) == 2
        for st in per_state:
            assert len(st) == 3
            np.testing.assert_allclose(st["aux_op1"][0], 2.0, atol=1e-6)
            assert st["zero_operator"][0] == 0.0
            assert isinstance(st["zero_operator"][1], dict)

    def test_auto_betas(self):
        res = _make_vqd(betas=None, optimizer=T.L_BFGS_B()
                        ).compute_eigenvalues(H2_PAULI)
        np.testing.assert_array_almost_equal(
            np.real(res.eigenvalues), H2_ENERGIES, decimal=3)

    def test_gradient_reaches_callable_optimizer(self):
        inputs = {}

        def mock(fun, x0, jac=None, bounds=None):
            inputs.update({"fun": fun, "x0": x0, "jac": jac})
            return OptimizerResult(x=np.asarray(x0), fun=float(fun(x0)),
                                   nfev=1)

        _make_vqd(optimizer=mock).compute_eigenvalues(H2_PAULI)
        assert inputs["jac"] is not None
        g = inputs["jac"](inputs["x0"])
        assert np.asarray(g).shape == inputs["x0"].shape

    def test_gradient_descent_run(self):
        res = _make_vqd(
            optimizer=T.GradientDescent(maxiter=300, learning_rate=0.1)
        ).compute_eigenvalues(H2_PAULI)
        np.testing.assert_array_almost_equal(
            np.real(res.eigenvalues)[0], H2_ENERGIES[0], decimal=4)


def test_debug_guards():
    """utils/debug.py: residue stripping keeps the device tensor, the
    partial-unitary and RDM checks, and nan_checks' anomaly mode."""
    from esoo_torch.utils.debug import (check_imaginary_residue,
                                        check_partial_unitary,
                                        check_rdm_sanity, nan_checks)
    t = torch.tensor([[1.0 + 1e-3j, 0.0], [0.0, 1.0]])
    with pytest.warns(UserWarning, match="imaginary residue"):
        out = check_imaginary_residue(t)
    assert torch.is_tensor(out) and not out.is_complex()
    assert check_imaginary_residue(t, strip=False) is t
    check_partial_unitary(np.eye(4)[:, :2])
    with pytest.raises(ValueError):
        check_partial_unitary(2.0 * np.eye(4)[:, :2])
    with pytest.raises(ValueError, match="trace"):
        check_rdm_sanity(np.eye(4), np.zeros((4,) * 4), 3)
    x = torch.tensor([0.0], requires_grad=True)
    with pytest.raises(RuntimeError), nan_checks():
        torch.sqrt(x - 1.0).sum().backward()
