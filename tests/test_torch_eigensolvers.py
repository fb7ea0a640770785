"""esoo_torch's excited-state fused solvers (FusedOptOrbSSVQE,
FusedOptOrbMCVQE, FusedOptOrbVQD, FusedOptOrbAdaptVQE), the batched sector
gate scan under them, and the CI initializers (initializations/ci.py,
hf_permutation.py), against esoo_tpu.  Float64 on the CPU; the JAX solver
runs are module-scoped.

Tolerances: 1e-12 of max(1, max|ref|) for the host CI builders and single
sector evaluations; 1e-7 Ha for solver energies, 1e-6 for thetas,
orbitals, transition RDMs and diagnostics (outer loops of L-BFGS and BB
steps, each stopping at its own tolerance: at the f64 gtol of 1e-9 the
two packages' summation orders may take different line-search branches,
tests/test_torch_lbfgs.py); the BASELINE.md anchors at decimal 3."""

import glob
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esoo_tpu.initializations as JI
from esoo_tpu.chem import MoleculeDriver as JMoleculeDriver
from esoo_tpu.orbital_optimization import (
    FusedOptOrbAdaptVQE as JAdapt, FusedOptOrbMCVQE as JMCVQE,
    FusedOptOrbSSVQE as JSSVQE, FusedOptOrbVQD as JVQD)
from esoo_tpu.orbital_optimization.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from esoo_tpu.orbital_optimization.fused import _mcvqe_batched_energies
from esoo_tpu.orbital_optimization.kernels import (
    expand_spin_tensors as j_expand, rotate_one_body as j_rot1,
    rotate_two_body as j_rot2)
from esoo_tpu.sim import HartreeFock as JHF, QuantumCircuit, UCCSD as JUCCSD
from esoo_tpu.sim.sector import SectorUCC as JSector
import esoo_torch.initializations as TI
from esoo_torch import (FusedOptOrbAdaptVQE, FusedOptOrbMCVQE,
                        FusedOptOrbSSVQE, FusedOptOrbVQD, HartreeFock,
                        OccupationState, UCCSD)
from esoo_torch.ops import BravyiKitaevMapper, ParityMapper
from esoo_torch.sim.sector import SectorUCC
from esoo_torch.parallel import make_orbital_state_mesh
from test_torch_engine import same_eri_engine  # noqa: F401

jax.config.update("jax_enable_x64", True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHORS = {"ssvqe": [-1.85403538, -1.37044354],    # BASELINE.md
           "mcvqe": [-1.85703467, -1.46615986],
           "vqd": [-1.8540352, -1.37044389],
           "adapt": [-1.866104213792463]}
SOLVERS = ["ssvqe", "mcvqe", "vqd", "adapt"]


def assert_close(out, ref, rtol=1e-12):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale)


def _x12():
    qc = QuantumCircuit(4)
    qc.x(1)
    qc.x(2)
    return qc


def _jax(name, problem, **kw):
    """The tests/test_fused.py:56-155 configurations, esoo_tpu."""
    if name == "ssvqe":
        return JSSVQE(num_spin_orbitals=4, ansatz=JUCCSD(2, (1, 1), reps=2),
                      initial_states=[JHF(2, (1, 1)), _x12()],
                      weight_vector=[2, 1], problem=problem, **kw)
    if name == "mcvqe":
        return JMCVQE(num_spin_orbitals=4, ansatz=JUCCSD(2, (1, 1), reps=2),
                      num_particles=(1, 1), k=2, excitations="s",
                      weight_vector=[2, 1], problem=problem, **kw)
    if name == "vqd":
        return JVQD(num_spin_orbitals=4, ansatz=JUCCSD(2, (1, 1), reps=2),
                    initial_states=[JHF(2, (1, 1)), _x12()], betas=[2.0],
                    weight_vector=[2, 1], problem=problem, **kw)
    return JAdapt(num_spin_orbitals=4,
                  ansatz=JUCCSD(2, (1, 1), initial_state=JHF(2, (1, 1))),
                  problem=problem, **kw)


def _port(name, problem, **kw):
    """The same configurations in the port: the JAX package's x(1) x(2)
    circuit is the OccupationState 0b0110."""
    kw.setdefault("device", "cpu")
    inits = [HartreeFock(2, (1, 1)), OccupationState(4, 0b0110)]
    if name == "ssvqe":
        return FusedOptOrbSSVQE(4, UCCSD(2, (1, 1), reps=2),
                                initial_states=inits, weight_vector=[2, 1],
                                problem=problem, **kw)
    if name == "mcvqe":
        return FusedOptOrbMCVQE(4, UCCSD(2, (1, 1), reps=2),
                                num_particles=(1, 1), k=2, excitations="s",
                                weight_vector=[2, 1], problem=problem, **kw)
    if name == "vqd":
        return FusedOptOrbVQD(4, UCCSD(2, (1, 1), reps=2),
                              initial_states=inits, betas=[2.0],
                              weight_vector=[2, 1], problem=problem, **kw)
    return FusedOptOrbAdaptVQE(
        4, UCCSD(2, (1, 1), initial_state=HartreeFock(2, (1, 1))),
        problem=problem, **kw)


def _run(solver):
    if isinstance(solver, (JAdapt, FusedOptOrbAdaptVQE)):
        return solver.compute_minimum_energy()
    return solver.compute_energies()


def _energies(r):
    return np.atleast_1d(getattr(r, "eigenvalues", None)
                         if hasattr(r, "eigenvalues") else r.eigenvalue)


@pytest.fixture(scope="module")
def jax_runs(h2_631g):
    return {name: _run(_jax(name, h2_631g, maxiter=20)) for name in SOLVERS}


@pytest.fixture(scope="module")
def jax_tails(h2_631g):
    """maxiter=2: every loop stops at maxiter, before it converges."""
    return {name: _run(_jax(name, h2_631g, maxiter=2)) for name in SOLVERS}


def _assert_matches(r, ref, what=""):
    np.testing.assert_allclose(_energies(r), _energies(ref), rtol=0,
                               atol=1e-7, err_msg=what)
    assert r.outer_iterations == ref.outer_iterations, what
    np.testing.assert_allclose(r.energy_convergence_list,
                               ref.energy_convergence_list, rtol=0,
                               atol=1e-7, err_msg=what)
    for k in ("optimal_point", "optimal_partial_unitary",
              "transition_rdm1_spatial", "natural_occupations",
              "spin_squared", "one_rdm_spatial", "spin_density_spatial",
              "selection_mask"):
        a, b = getattr(r, k, None), getattr(ref, k, None)
        assert (a is None) == (b is None), f"{what} {k}"
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg=f"{what} {k}")


# -- initializations ------------------------------------------------------------

@pytest.mark.parametrize("N,parts", [(6, (1, 1)), (6, (2, 1)), (8, (2, 2))])
def test_ci_builders_match_jax(N, parts):
    rng = np.random.default_rng(N + parts[0])
    h = rng.normal(size=(N, N))
    h = (h + h.T) / 2
    g0 = rng.normal(size=(N,) * 4)
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    from esoo_tpu.initializations import ci as jci
    from esoo_torch.initializations import ci as tci
    for order in (1, 2, sum(parts)):
        dets = TI.enumerate_determinants(N, parts, order)
        assert dets == JI.enumerate_determinants(N, parts, order)
        for vec in (True, False):
            assert_close(TI.ci_matrix(dets, h, g, vectorized=vec),
                         JI.ci_matrix(dets, h, g, vectorized=vec))
        st, jst = (m.slater_condon_structure(dets, N) for m in (tci, jci))
        assert set(st) == set(jst)
        for k in st:
            np.testing.assert_array_equal(st[k], jst[k], err_msg=k)
    for d in JI.enumerate_determinants(N, parts, 2)[:6]:
        for i in range(N):
            for a in range(N):
                assert tci.excite(d, i, a) == jci.excite(d, i, a)
    for kind in ("CIS", "CISD", "FCI"):
        assert_close(getattr(TI, f"get_{kind}_energies")(h, g, parts),
                     getattr(JI, f"get_{kind}_energies")(h, g, parts))
        for rep in ("dense", "sparse"):
            out = getattr(TI, f"get_{kind}_states")(
                h, g, parts, state_representation=rep)
            ref = getattr(JI, f"get_{kind}_states")(
                h, g, parts, state_representation=rep)
            assert len(out) == len(ref)
            for a, b in zip(out, ref):
                if rep == "dense":
                    assert_close(a, b)
                else:
                    assert set(a) == set(b)
                    assert_close([a[k] for k in sorted(a)],
                                 [b[k] for k in sorted(b)])
    assert TI.hf_determinant(N, parts) == JI.hf_determinant(N, parts)
    np.testing.assert_array_equal(TI.get_HF_permutation_matrix(2 * N, N),
                                  JI.get_HF_permutation_matrix(2 * N, N))


# -- the batched sector simulation ---------------------------------------------

def test_batched_apply_equals_one_at_a_time():
    """k states through one theta (one gate scan over a (k, nB, nA) stack)
    give each state's own amplitudes bit for bit, the JAX package's
    SectorUCC.apply to round-off, and the weighted gradient equals the
    weighted sum of the per-state gradients."""
    n, parts = 3, (2, 1)
    ansatz = UCCSD(n, parts, initial_state=HartreeFock(n, parts))
    sec = SectorUCC(ansatz, 2 * n)
    jsec = JSector(JUCCSD(n, parts, initial_state=JHF(n, parts)), 2 * n)
    rng = np.random.default_rng(12)
    V0 = rng.normal(size=(3, sec.dim + 1))
    V0[:, -1] = 0.0
    theta = rng.normal(size=ansatz.num_parameters) * 0.4
    tV0, tth = torch.as_tensor(V0), torch.as_tensor(theta)
    out = sec.apply(tV0, tth)
    for i in range(3):
        assert torch.equal(out[i], sec.apply(tV0[i], tth))
        assert_close(out[i], jsec.apply(jnp.asarray(V0[i]),
                                        jnp.asarray(theta)))
    np.testing.assert_array_equal(sec.project_full(
        np.asarray(jsec.to_full(jnp.asarray(V0[0])))), V0[0])
    h, g = (torch.as_tensor(a) for a in
            (np.eye(6) * np.arange(6.0), np.zeros((6,) * 4)))
    vals = sec.build_values(h, g)
    w = torch.tensor([3.0, 2.0, 1.0], dtype=torch.float64)
    M0 = tV0[:, : sec.dim].reshape(3, sec.nB, sec.nA)

    def grad(fn):
        th = tth.clone().requires_grad_(True)
        return torch.autograd.grad(fn(th), th)[0]

    batched = grad(lambda th: w @ sec.quadform_values(
        sec.apply_matrix(M0, th), vals))
    single = sum(wi * grad(lambda th, m=m: sec.quadform_values(
        sec.apply_matrix(m, th), vals)) for wi, m in zip(w, M0))
    assert_close(batched, single)


# -- the solvers against esoo_tpu ---------------------------------------------

@pytest.mark.parametrize("name", SOLVERS)
def test_solver_matches_jax(name, h2_631g, jax_runs):
    r = _run(_port(name, h2_631g, maxiter=20))
    _assert_matches(r, jax_runs[name], name)
    np.testing.assert_array_almost_equal(_energies(r), ANCHORS[name],
                                         decimal=3)
    st = r.stage_stats
    assert st["lbfgs_evaluations"] >= st["lbfgs_iterations"] > 0
    assert st["bb_iterations"] > 0
    if name != "adapt":
        U = r.optimal_partial_unitary
        np.testing.assert_allclose(U.T @ U, np.eye(2), rtol=0, atol=1e-8)
        t = r.transition_rdm1_spatial
        # diagonal slices are the states' own 1-RDMs
        for i in range(2):
            np.testing.assert_allclose(t[i, i], r.one_rdm_spatial[i],
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", SOLVERS)
def test_tail_after_a_maxiter_stop_matches_jax(name, h2_631g, jax_tails):
    """What follows the loop when it stops at maxiter differs by solver:
    SSVQE and MCVQE evaluate the last theta at the final U, VQD reruns the
    deflation, ADAPT regrows."""
    r = _run(_port(name, h2_631g, maxiter=2))
    assert r.outer_iterations == 2
    _assert_matches(r, jax_tails[name], name)


@pytest.mark.parametrize("name", SOLVERS)
def test_two_dispatches_give_the_one_dispatch_result(name, h2_631g):
    one = _run(_port(name, h2_631g, maxiter=20))
    two = _run(_port(name, h2_631g, maxiter=20, dispatch="two"))
    np.testing.assert_array_equal(_energies(two), _energies(one))
    assert two.outer_iterations == one.outer_iterations
    np.testing.assert_array_equal(two.optimal_partial_unitary,
                                  one.optimal_partial_unitary)


def test_mcvqe_sector_energies_equal_the_full_space_ones(h2_631g, jax_runs):
    """The k + k(k-1) contracted-Hamiltonian energies, computed in the
    sector by the port and in the 2^N space by the JAX package
    (_mcvqe_batched_energies), at the JAX run's final theta and U."""
    ref = jax_runs["mcvqe"]
    jsolver = _jax("mcvqe", h2_631g, maxiter=20)
    port = _port("mcvqe", h2_631g, maxiter=20)
    for a, b in zip(port._ci_vectors, jsolver._ci_vectors):
        assert_close(a, b)
    vecs = jsolver._ci_vectors
    stack = np.stack([vecs[0], vecs[1], (vecs[0] + vecs[1]) / np.sqrt(2),
                      (vecs[0] - vecs[1]) / np.sqrt(2)])
    theta, U = ref.optimal_point, ref.optimal_partial_unitary
    h_so, g_so = j_expand(j_rot1(jsolver._h_sp, jnp.asarray(U)),
                          j_rot2(jsolver._g_sp, jnp.asarray(U)))
    full = _mcvqe_batched_energies(jsolver._apply_raw, jnp.asarray(stack),
                                   jnp.asarray(theta), h_so, g_so)
    sector = port._contracted_energies(torch.as_tensor(theta),
                                       torch.as_tensor(U))
    assert_close(sector, full)


def test_callbacks_checkpoints_and_resume(h2_631g, tmp_path):
    """The callback sees per-state energies whose weighted sum is the
    trace; one checkpoint per outer iteration; a checkpoint resumes the
    port as it resumes the JAX package (VQD: (k, P) thetas)."""
    for name in ("ssvqe", "vqd"):
        seen = []
        d = str(tmp_path / name)
        r = _run(_port(name, h2_631g, maxiter=20, checkpoint_dir=d,
                       outer_loop_callback=lambda it, e: seen.append((it, e))))
        assert [it for it, _ in seen] == list(range(1, r.outer_iterations
                                                    + 1))
        np.testing.assert_allclose([2 * e[0] + e[1] for _, e in seen],
                                   r.energy_convergence_list, rtol=0,
                                   atol=1e-12)
        cks = sorted(glob.glob(os.path.join(d, "*.npz")))
        assert len(cks) == r.outer_iterations
        resumed = _run(_port(name, h2_631g, maxiter=20,
                             resume_from=cks[-1]))
        jresumed = _run(_jax(name, h2_631g, maxiter=20,
                             resume_from=cks[-1]))
        np.testing.assert_allclose(resumed.eigenvalues, jresumed.eigenvalues,
                                   rtol=0, atol=1e-7)
        assert resumed.outer_iterations == jresumed.outer_iterations
    # a JAX-written checkpoint resumes the port's ADAPT loop as it does
    # the JAX package's (the thetas are regrown; U is read)
    ref = _run(_jax("adapt", h2_631g, maxiter=2))
    path = jax_save_checkpoint(
        str(tmp_path / "adapt.npz"), iteration=2,
        partial_unitary=ref.optimal_partial_unitary,
        energy_convergence_list=ref.energy_convergence_list,
        optimal_point=ref.optimal_point)
    assert abs(_run(_port("adapt", h2_631g, maxiter=20,
                          resume_from=path)).eigenvalue
               - ANCHORS["adapt"][0]) <= 1e-3


def test_vqd_deflation_actually_deflates(h2_sto3g):
    """With identical initial states the beta penalty alone keeps state 1
    off the ground state (tests/test_fused.py:100)."""
    r = FusedOptOrbVQD(4, UCCSD(2, (1, 1), reps=2),
                       initial_states=[HartreeFock(2, (1, 1))] * 2,
                       betas=[3.0], problem=h2_sto3g, maxiter=1,
                       vqe_maxiter=400, device="cpu").compute_energies()
    np.testing.assert_allclose(r.eigenvalues[0], -1.85727503, atol=1e-5)
    assert r.eigenvalues[1] > r.eigenvalues[0] + 0.05


def test_error_paths(h2_631g, monkeypatch):
    hf = HartreeFock(2, (1, 1))
    ansatz = UCCSD(2, (1, 1), reps=2)

    def ssvqe(**kw):
        kw.setdefault("initial_states", [hf, OccupationState(4, 0b0110)])
        return FusedOptOrbSSVQE(4, kw.pop("ansatz", ansatz),
                                problem=h2_631g, device="cpu", **kw)

    with pytest.raises(ValueError, match="orthonormal"):
        ssvqe(initial_states=[hf, hf])
    with pytest.raises(ValueError, match="betas"):
        FusedOptOrbVQD(4, ansatz, initial_states=[hf, hf, hf], betas=[1.0],
                       problem=h2_631g, device="cpu")
    with pytest.raises(ValueError, match="one ansatz per state"):
        FusedOptOrbVQD(4, [ansatz], initial_states=[hf, hf],
                       problem=h2_631g, device="cpu")
    # per-state ansatz lists run on the full statevector (the sector
    # compiles one excitation table)
    assert FusedOptOrbVQD(4, [ansatz, ansatz], initial_states=[hf, hf],
                          problem=h2_631g,
                          device="cpu").simulation == "full"
    with pytest.raises(ValueError, match="simulation='full'"):
        FusedOptOrbVQD(4, [ansatz, ansatz], initial_states=[hf, hf],
                       problem=h2_631g, simulation="sector", device="cpu")
    # a determinant of another (na, nb) sector: 'auto' falls back to the
    # full statevector, as in the JAX package
    outside = [hf, OccupationState(4, 0b0111)]
    with pytest.raises(ValueError, match="outside"):
        ssvqe(initial_states=outside, simulation="sector")
    assert ssvqe(initial_states=outside).simulation == "full"
    with pytest.raises(ValueError, match="Jordan-Wigner"):
        ssvqe(ansatz=UCCSD(2, (1, 1), reps=2, qubit_mapper=ParityMapper()))
    with pytest.raises(ValueError, match="Jordan-Wigner"):
        ssvqe(initial_states=[HartreeFock(2, (1, 1),
                                          qubit_mapper=BravyiKitaevMapper())])
    assert ssvqe(simulation="full").simulation == "full"
    with pytest.raises(TypeError, match="OrbitalMesh"):
        ssvqe(mesh=object())
    # the state axis of a 2-D mesh takes the k states in groups; k not
    # divisible by it raises the JAX package's ValueError
    assert len(ssvqe(mesh=make_orbital_state_mesh(
        2, 2, devices=["cpu"] * 4))._groups) == 2
    with pytest.raises(ValueError, match=r"k=2 states not divisible by the "
                       r"state mesh axis \(3\)"):
        ssvqe(mesh=make_orbital_state_mesh(2, 3, devices=["cpu"] * 6))
    with pytest.raises(ValueError, match="dispatch"):
        ssvqe(dispatch="three")
    with pytest.raises(ValueError, match="k=5"):
        FusedOptOrbMCVQE(4, ansatz, num_particles=(1, 1), k=5,
                         problem=h2_631g, device="cpu")
    with pytest.raises(ValueError, match="vqe_chunk"):
        FusedOptOrbAdaptVQE(4, UCCSD(2, (1, 1), initial_state=hf),
                            problem=h2_631g, device="cpu", dispatch="two",
                            vqe_chunk=3)
    with pytest.raises(ValueError, match="UCC"):
        FusedOptOrbAdaptVQE(4, object(), problem=h2_631g, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedOptOrbSSVQE(4, ansatz, initial_states=[hf], problem=h2_631g)


def _chip_smoke_constants():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_h4_ssvqe_at_full_width_matches_the_smoke_constants():
    """chip_smoke.py's excited phase gates the card's float32 energies
    against H4_SSVQE_F64: the JAX package's float64 FusedOptOrbSSVQE on H4
    cc-pVTZ -> 8 (UCCSD, HF and the HOMO->LUMO alpha single, weights
    [2, 1]).  This test is where those constants come from: it reruns the
    JAX package, and the port's float64 CPU run agrees with it: the first
    outer energy to round-off, the final energies to 1e-6 (the BB loop's
    stop test at inner tol 1e-5 turns the packages' 5e-10 difference in
    theta after the first L-BFGS solve into 2.4e-6 in U, measured, and
    after five outer iterations the energies differ by 3e-7)."""
    smoke = _chip_smoke_constants()
    p = JMoleculeDriver(atom=smoke.H4_GEOM, basis="cc-pvtz").run()
    assert p.num_spatial_orbitals == 56
    st = QuantumCircuit(8)
    for q in (0, 2, 4, 5):
        st.x(q)
    ref = JSSVQE(num_spin_orbitals=8, ansatz=JUCCSD(4, (2, 2)),
                 initial_states=[JHF(4, (2, 2)), st],
                 weight_vector=[2.0, 1.0], problem=p, maxiter=20,
                 stopping_tolerance=1e-5,
                 dtype=np.float64).compute_energies()
    np.testing.assert_allclose(ref.eigenvalues, smoke.H4_SSVQE_F64, rtol=0,
                               atol=1e-9)
    r = FusedOptOrbSSVQE(8, UCCSD(4, (2, 2)),
                         initial_states=[HartreeFock(4, (2, 2)),
                                         OccupationState(
                                             8, smoke.H4_EXCITED_MASK)],
                         weight_vector=[2.0, 1.0], problem=p, maxiter=20,
                         stopping_tolerance=1e-5, dtype=torch.float64,
                         diagnostics=False, device="cpu").compute_energies()
    assert abs(r.energy_convergence_list[0]
               - ref.energy_convergence_list[0]) <= 1e-12
    np.testing.assert_allclose(r.eigenvalues, ref.eigenvalues, rtol=0,
                               atol=1e-6)
    assert r.outer_iterations == ref.outer_iterations


def test_vqd_on_h4_matches_jax_one_outer_iteration(h4_631g, monkeypatch):
    """FusedOptOrbVQD at n = 4 (H4 6-31G chain -> 8 spin orbitals, HF and
    the HOMO->LUMO alpha single, betas [3.0], vqe_maxiter 300), one outer
    iteration, against the JAX package to 1e-10.  The agreement rests on
    the L-BFGS exits: state 0's solves end by the gradient test, state
    1's run the full vqe_maxiter in both packages, which take the same
    300 steps (past one outer iteration the orbital step amplifies what
    is left, ~1e-4 after 20 with the default betas): asserted on each
    solve's iteration count."""
    from esoo_torch.convert import problem_from_numpy
    from esoo_torch.orbital_optimization import fused
    import dataclasses

    st = QuantumCircuit(8)
    for q in (0, 2, 4, 5):
        st.x(q)
    ref = JVQD(8, JUCCSD(4, (2, 2)), initial_states=[JHF(4, (2, 2)), st],
               betas=[3.0], problem=h4_631g, maxiter=1,
               vqe_maxiter=300).compute_energies()
    nits = []
    solve = fused.lbfgs_minimize

    def counted(*args, **kw):
        res = solve(*args, **kw)
        nits.append(res.nit)
        return res

    monkeypatch.setattr(fused, "lbfgs_minimize", counted)
    r = FusedOptOrbVQD(8, UCCSD(4, (2, 2)),
                       initial_states=[HartreeFock(4, (2, 2)),
                                       OccupationState(8, 0b110101)],
                       betas=[3.0], problem=problem_from_numpy(
                           dataclasses.asdict(h4_631g)),
                       maxiter=1, vqe_maxiter=300,
                       device="cpu").compute_energies()
    # two states in the loop's solve and again in the final one
    assert len(nits) == 4, nits
    assert max(nits[0::2]) < 300 and nits[1::2] == [300, 300], nits
    assert r.outer_iterations == ref.outer_iterations == 1
    assert_close(r.eigenvalues, ref.eigenvalues, rtol=1e-10)
    assert_close(r.optimal_point, ref.optimal_point, rtol=1e-6)
