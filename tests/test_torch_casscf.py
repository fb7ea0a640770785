"""esoo_torch exact CASSCF against esoo_tpu, float64 on the CPU: the sector
diagonal and transition 1-RDM (sim/strings.py), SectorCI (sim/sector.py),
Davidson (solvers/davidson.py) and FusedOptOrb(SA)CASSCF
(orbital_optimization/casscf.py).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 1e-12 of max(1, max|ref|) for single kernel evaluations and
the dense-H diagonal (the packages sum in different orders); 1e-10 for
Davidson eigenvalues (a converged search, compared with equal iteration
counts); 1e-8 for the CASSCF energies and orbitals (an outer loop of
Davidson and BB steps, each stopping at its own tolerance)."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.orbital_optimization import (
    FusedOptOrbCASSCF as JCASSCF, FusedOptOrbSACASSCF as JSACASSCF)
from esoo_tpu.orbital_optimization import casscf as JCASSCF_MODULE
from esoo_tpu.orbital_optimization.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD
from esoo_tpu.sim import strings as JS
from esoo_tpu.sim.sector import SectorCI as JSectorCI, SectorUCC as JSector
from esoo_tpu.solvers import davidson as JD
from esoo_torch import (FusedOptOrbCASSCF, FusedOptOrbSACASSCF,
                        FusedOptOrbVQE, HartreeFock, SectorCI, UCCSD)
from esoo_torch.convert import tensors_from_numpy
from esoo_torch.orbital_optimization import casscf as TC
from esoo_torch.sim import strings as TS
from esoo_torch.solvers import davidson as TD
from esoo_torch.parallel import make_orbital_state_mesh
from test_torch_engine import same_eri_engine  # noqa: F401

jax.config.update("jax_enable_x64", True)

H2_REFERENCE = -1.8661038                  # tests/test_casscf.py:76
MCVQE_REFERENCE = [-1.85703467, -1.46615986]   # tests/test_casscf.py:203
SECTORS = [(3, (1, 1)), (4, (2, 2)), (4, (2, 1))]


def assert_close(out, ref, rtol=1e-12):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _random_tensors(N, seed):
    """Spin-orbital (h, g) with the index symmetries of chemistry
    tensors (tests/test_casscf.py)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, N))
    g0 = rng.normal(size=(N,) * 4)
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    return (h + h.T) / 2, g


class _Tensors:
    """A problem that hands over spatial tensors as they are."""

    def __init__(self, h, g, num_particles):
        self._t = (h, g)
        self.num_particles = num_particles

    def spatial_integral_tensors(self):
        return self._t


@pytest.fixture(scope="module", params=SECTORS, ids=str)
def sector_pair(request):
    """(n, parts, JAX SectorCI, port SectorCI, h, g, JAX vals, port
    vals) on random integrals."""
    n, parts = request.param
    N = 2 * n
    h, g = _random_tensors(N, seed=n + parts[0])
    js, ts = JSectorCI(N, parts), SectorCI(N, parts)
    jv = js.build_values(jnp.asarray(h), jnp.asarray(g))
    tv = ts.build_values(_t(h), _t(g))
    return n, parts, js, ts, h, g, jv, tv


def test_sector_ci_tables_match_jax(sector_pair):
    n, parts, js, ts, *_ = sector_pair
    assert (ts.dim, ts.nA, ts.nB, ts.init_index) == (
        js.dim, js.nA, js.nB, js.init_index)
    np.testing.assert_array_equal(ts.dets, js.dets)
    jt = js.device_tables()
    tt = ts.device_tables(torch.float64, device="cpu")
    for k in ("MA", "MB", "LIN_A", "LIN_B", "CROSS"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                      err_msg=k)
    assert ts.device_tables(torch.float64, device="cpu") is tt   # cached
    np.testing.assert_array_equal(
        ts.hf_matrix(torch.float64, device="cpu").numpy(),
        np.asarray(js.hf_matrix(jnp.float64)))


def test_sector_ci_sigma_diagonal_rdms_match_jax(sector_pair):
    n, parts, js, ts, h, g, jv, tv = sector_pair
    for k in ("G2", "FA", "FB"):
        assert_close(tv[k], jv[k])
    rng = np.random.default_rng(7)
    V = rng.normal(size=(ts.nB, ts.nA))
    V /= np.linalg.norm(V)
    assert_close(ts.sigma_values(_t(V), tv),
                 js.sigma_values(jnp.asarray(V), jv))
    assert_close(ts.quadform_values(_t(V), tv),
                 js.quadform_values(jnp.asarray(V), jv))
    assert_close(ts.diagonal_values(tv), js.diagonal_values(jv))
    for out, ref in zip(ts.rdms(_t(V)), js.rdms(jnp.asarray(V))):
        assert_close(out, ref)
    full = ts.to_full(_t(V))
    assert_close(full, js.to_full(jnp.asarray(V)))


def test_diagonal_equals_the_dense_sector_hamiltonian(sector_pair):
    """strings.diagonal == diag of the dense sector H, built by the JAX
    package's pairwise kernel (tests/test_casscf.py:52-65)."""
    n, parts, js, ts, h, g, jv, tv = sector_pair
    ans = JUCCSD(n, parts, initial_state=JHF(n, parts))
    H = np.asarray(JSector(ans, 2 * n, kernel="pairs",
                           num_particles=parts).build_hamiltonian(
                               jnp.asarray(h), jnp.asarray(g)))
    d = TS.diagonal(tv, ts.device_tables(torch.float64, device="cpu"))
    np.testing.assert_allclose(d.numpy().reshape(-1), np.diag(H), rtol=0,
                               atol=1e-12)
    assert_close(d, JS.diagonal(jv, js.device_tables()))


@pytest.mark.parametrize("batched", [False, True])
def test_transition_rdm1_matches_jax(sector_pair, batched):
    n, parts, js, ts, *_ = sector_pair
    rng = np.random.default_rng(11)
    V = rng.normal(size=(ts.nB, ts.nA))
    U = rng.normal(size=(3, ts.nB, ts.nA) if batched else (ts.nB, ts.nA))
    out = ts.transition_rdm1(_t(U), _t(V))
    assert_close(out, js.transition_rdm1(jnp.asarray(U), jnp.asarray(V)))
    assert out.shape == ((3,) if batched else ()) + (2 * n, 2 * n)
    # transition_rdm1(v, v) is the 1-RDM
    assert_close(ts.transition_rdm1(_t(V), _t(V)), ts.rdms(_t(V))[0])


def test_sector_ci_storage_outside_the_slice_raises():
    """The compact and int8 tables equal the JAX package's (the kernels
    on them: tests/test_torch_compact.py); an unknown storage raises."""
    ts, js = SectorCI(4, (1, 1)), JSectorCI(4, (1, 1))
    for storage, keys in (("compact", ("MA8", "MB8")), ("int8", ("MA", "MB"))):
        tt = ts.device_tables(torch.float64, device="cpu", storage=storage)
        jt = js.device_tables(np.float64, storage=storage)
        assert set(tt) == set(jt)
        for k in keys + ("LIN_A", "LIN_B", "CROSS"):
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                          err_msg=f"{storage} {k}")
        assert all(tt[k].dtype == torch.int8 for k in keys)
        assert ts.device_tables(torch.float64, device="cpu",
                                storage=storage) is tt           # cached
    with pytest.raises(ValueError):
        ts.device_tables(torch.float64, device="cpu", storage="sparse")


def _matvecs(js, ts, jv, tv):
    def jmv(x):
        return js.sigma_values(x.reshape(js.nB, js.nA), jv).reshape(-1)

    def tmv(x):
        return ts.sigma_values(x.reshape(ts.nB, ts.nA), tv).reshape(-1)

    jd = js.diagonal_values(jv).reshape(-1)
    return jmv, tmv, jd, _t(jd)


def test_davidson_ground_matches_jax(sector_pair):
    n, parts, js, ts, h, g, jv, tv = sector_pair
    jmv, tmv, jd, td = _matvecs(js, ts, jv, tv)
    ref = JD.davidson_ground(jmv, jd, js.hf_matrix(jnp.float64).reshape(-1),
                             max_subspace=12, maxiter=300, tol=1e-10)
    out = TD.davidson_ground(
        tmv, td, ts.hf_matrix(torch.float64, device="cpu").reshape(-1),
        max_subspace=12, maxiter=300, tol=1e-10)
    assert out.iterations == int(ref.iterations)
    assert abs(float(out.eigenvalue) - float(ref.eigenvalue)) <= 1e-10 * max(
        1.0, abs(float(ref.eigenvalue)))
    H = np.stack([tmv(_t(e)).numpy() for e in np.eye(ts.dim)], axis=1)
    w = np.linalg.eigvalsh((H + H.T) / 2)
    assert abs(float(out.eigenvalue) - w[0]) <= 1e-8
    assert float(out.residual_norm) < 1e-10 * max(1.0, abs(w[0]))
    # the eigenvector agrees up to its sign
    x, y = out.eigenvector.numpy(), np.asarray(ref.eigenvector)
    assert abs(abs(x @ y) - 1.0) <= 1e-10


@pytest.mark.parametrize("k", [2, 3])
def test_davidson_block_matches_jax(sector_pair, k):
    n, parts, js, ts, h, g, jv, tv = sector_pair
    jmv, tmv, jd, td = _matvecs(js, ts, jv, tv)
    V0 = np.zeros((k, ts.dim))
    V0[np.arange(k), np.argsort(np.asarray(jd))[:k]] = 1.0
    ref = JD.davidson_block(jmv, jd, jnp.asarray(V0), k=k, max_subspace=18,
                            maxiter=400, tol=1e-10)
    out = TD.davidson_block(tmv, td, _t(V0), k=k, max_subspace=18,
                            maxiter=400, tol=1e-10)
    assert out.iterations == int(ref.iterations)
    assert_close(out.eigenvalues, ref.eigenvalues, rtol=1e-10)
    H = np.stack([tmv(_t(e)).numpy() for e in np.eye(ts.dim)], axis=1)
    np.testing.assert_allclose(out.eigenvalues.numpy(),
                               np.linalg.eigvalsh((H + H.T) / 2)[:k],
                               rtol=0, atol=1e-8)
    X = out.eigenvectors.numpy()
    np.testing.assert_allclose(X @ X.T, np.eye(k), rtol=0, atol=1e-8)


@pytest.mark.parametrize("chunk", [1, 7])
def test_block_davidson_chunked_equals_monolithic(chunk):
    """init + bounded advances + finish == davidson_block, on a spectrum
    that straddles zero (tests/test_casscf.py:374), and both equal the
    JAX package's eigenvalues (its 86-87 iterations end where the
    residual crosses the tolerance, so round-off may move the count by
    one: the count is compared on the sector problems above)."""
    rng = np.random.default_rng(0)
    n, k = 200, 3
    A = rng.normal(size=(n, n))
    A = (A + A.T) / 2 + np.diag(np.arange(n) * 1.0)
    V0 = rng.normal(size=(k, n))
    At = _t(A)

    def mv(x):
        return At @ x

    diag = torch.diagonal(At)
    ref = TD.davidson_block(mv, diag, _t(V0), k=k, max_subspace=12,
                            maxiter=300, tol=1e-10)
    Aj = jnp.asarray(A)
    jref = JD.davidson_block(lambda x: Aj @ x, jnp.diagonal(Aj),
                             jnp.asarray(V0), k=k, max_subspace=12,
                             maxiter=300, tol=1e-10)
    assert abs(ref.iterations - int(jref.iterations)) <= 1
    assert_close(ref.eigenvalues, jref.eigenvalues, rtol=1e-10)
    np.testing.assert_allclose(ref.eigenvalues.numpy(),
                               np.linalg.eigvalsh(A)[:k], rtol=0, atol=1e-8)
    st = TD.davidson_block_init(mv, diag, _t(V0), k=k, max_subspace=12,
                                tol=1e-10)
    while not st.stop and st.it < 300:
        st = TD.davidson_block_advance(mv, diag, st, iters=chunk, tol=1e-10)
    out = TD.davidson_block_finish(mv, diag, st, tol=1e-10)
    assert out.iterations == ref.iterations
    np.testing.assert_array_equal(out.eigenvalues.numpy(),
                                  ref.eigenvalues.numpy())
    np.testing.assert_allclose(
        np.abs(out.eigenvectors.numpy() @ ref.eigenvectors.numpy().T),
        np.eye(k), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="max_subspace"):
        TD.davidson_block(mv, diag, _t(V0), k=k, max_subspace=5)


# -- FusedOptOrbCASSCF -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_h2(h2_631g):
    solver = JCASSCF(4, problem=h2_631g, maxiter=20)
    return solver, solver.compute_minimum_energy()


def _carried(solver, dtype=torch.float64):
    """The JAX solver's integrals, U0 and start vector as port tensors."""
    h, g, U0, v0 = tensors_from_numpy(
        *(np.asarray(a) for a in (solver._h_sp, solver._g_sp, solver._U0,
                                  solver._v0)), dtype=dtype, device="cpu")
    return h, g, U0, v0


def test_casscf_h2_matches_jax(jax_h2, h2_631g):
    solver, ref = jax_h2
    h, g, U0, v0 = _carried(solver)
    port = FusedOptOrbCASSCF(4, problem=_Tensors(h, g,
                                                 h2_631g.num_particles),
                             maxiter=20, initial_partial_unitary=U0.numpy(),
                             device="cpu")
    # the default start vector (the HF determinant) is the JAX one
    np.testing.assert_array_equal(port._v0.numpy(), v0.numpy())
    r = port.compute_minimum_energy()
    assert abs(r.eigenvalue - ref.eigenvalue) <= 1e-8
    assert abs(r.eigenvalue - H2_REFERENCE) <= 1e-4
    assert r.outer_iterations == ref.outer_iterations
    np.testing.assert_allclose(r.energy_convergence_list,
                               ref.energy_convergence_list, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(r.optimal_partial_unitary,
                               ref.optimal_partial_unitary, rtol=0,
                               atol=1e-8)
    assert abs(abs(r.optimal_point @ np.asarray(ref.optimal_point))
               - 1.0) <= 1e-8
    for k in ("natural_occupations", "one_rdm_spatial",
              "spin_density_spatial"):
        np.testing.assert_allclose(getattr(r, k), getattr(ref, k), rtol=0,
                                   atol=1e-8, err_msg=k)
    assert abs(r.spin_squared - ref.spin_squared) <= 1e-8
    st = r.stage_stats
    assert st["davidson_solves"] == r.outer_iterations + 1
    assert st["davidson_matvecs"] == sum(st["davidson_matvecs_per_solve"])
    assert set(st["davidson_exits"]) == {"converged"}
    assert st["bb_iterations"] > 0
    assert 0.0 < st["davidson_s"] and 0.0 < st["bb_s"]


@pytest.mark.parametrize("kw", [dict(dispatch="two"),
                                dict(dispatch="two", davidson_chunk=4),
                                dict(dispatch="two", davidson_chunk=3,
                                     davidson_tol_ladder=True)],
                         ids=["two", "chunk", "ladder"])
def test_casscf_dispatch_options_match_jax(h2_631g, kw):
    ref = JCASSCF(4, problem=h2_631g, maxiter=10,
                  **kw).compute_minimum_energy()
    r = FusedOptOrbCASSCF(4, problem=h2_631g, maxiter=10, device="cpu",
                          **kw).compute_minimum_energy()
    assert abs(r.eigenvalue - ref.eigenvalue) <= 1e-8
    assert r.outer_iterations == ref.outer_iterations
    np.testing.assert_allclose(r.optimal_partial_unitary,
                               ref.optimal_partial_unitary, rtol=0,
                               atol=1e-8)


def test_casscf_checkpoints_and_jax_checkpoint_resume(jax_h2, h2_631g,
                                                      tmp_path):
    _, ref = jax_h2
    seen = []
    r = FusedOptOrbCASSCF(4, problem=h2_631g, maxiter=12, device="cpu",
                          checkpoint_dir=str(tmp_path / "ck"),
                          outer_loop_callback=lambda it, e: seen.append(
                              (it, e))).compute_minimum_energy()
    assert [it for it, _ in seen] == list(range(1, r.outer_iterations + 1))
    cks = sorted(glob.glob(str(tmp_path / "ck" / "*.npz")))
    assert len(cks) == r.outer_iterations
    resumed = FusedOptOrbCASSCF(4, problem=h2_631g, maxiter=12, device="cpu",
                                resume_from=cks[-1]).compute_minimum_energy()
    assert abs(resumed.eigenvalue - r.eigenvalue) <= 1e-4
    assert resumed.eigenvalue <= r.eigenvalue + 1e-9
    # a checkpoint the JAX package wrote resumes both packages alike
    path = jax_save_checkpoint(
        str(tmp_path / "jax.npz"), iteration=ref.outer_iterations,
        partial_unitary=ref.optimal_partial_unitary,
        energy_convergence_list=ref.energy_convergence_list,
        optimal_point=ref.optimal_point)
    port = FusedOptOrbCASSCF(4, problem=h2_631g, maxiter=12, device="cpu",
                             resume_from=path).compute_minimum_energy()
    jax_resumed = JCASSCF(4, problem=h2_631g, maxiter=12,
                          resume_from=path).compute_minimum_energy()
    assert port.outer_iterations == jax_resumed.outer_iterations
    assert abs(port.eigenvalue - jax_resumed.eigenvalue) <= 1e-8


@pytest.fixture(scope="module")
def jax_h4(h4_631g):
    solver = JCASSCF(8, problem=h4_631g, maxiter=20)
    return solver, solver.compute_minimum_energy()


def test_casscf_h4_matches_jax_and_is_below_vqe(jax_h4, h4_631g):
    solver, ref = jax_h4
    h, g, U0, v0 = _carried(solver)
    port = FusedOptOrbCASSCF(8, problem=_Tensors(h, g,
                                                 h4_631g.num_particles),
                             maxiter=20, initial_partial_unitary=U0.numpy(),
                             device="cpu")
    np.testing.assert_array_equal(port._v0.numpy(), v0.numpy())
    r = port.compute_minimum_energy()
    assert abs(r.eigenvalue - ref.eigenvalue) <= 1e-8
    assert r.outer_iterations == ref.outer_iterations
    np.testing.assert_allclose(r.optimal_partial_unitary,
                               ref.optimal_partial_unitary, rtol=0,
                               atol=1e-8)
    vqe = FusedOptOrbVQE(8, UCCSD(4, (2, 2),
                                  initial_state=HartreeFock(4, (2, 2))),
                         problem=h4_631g, maxiter=20, device="cpu",
                         diagnostics=False).compute_minimum_energy()
    assert r.eigenvalue <= vqe.eigenvalue + 1e-9


def test_casscf_float32_on_carried_tensors(jax_h2, h2_631g):
    h, g, U0, v0 = _carried(jax_h2[0], dtype=torch.float32)
    r = FusedOptOrbCASSCF(4, problem=_Tensors(h, g, h2_631g.num_particles),
                          dtype=torch.float32, maxiter=20,
                          device="cpu").compute_minimum_energy()
    assert abs(r.eigenvalue - H2_REFERENCE) <= 1e-4
    assert set(r.stage_stats["davidson_exits"]) == {"converged"}


# -- FusedOptOrbSACASSCF -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_sa(h2_631g):
    solver = JSACASSCF(4, k=2, problem=h2_631g, maxiter=20)
    return solver, solver.compute_energies()


def test_sa_casscf_matches_jax_and_mcvqe(jax_sa, h2_631g):
    solver, ref = jax_sa
    h, g, U0, V0, w = tensors_from_numpy(
        *(np.asarray(a) for a in (solver._h_sp, solver._g_sp, solver._U0,
                                  solver._V0, solver._weights)),
        dtype=torch.float64, device="cpu")
    port = FusedOptOrbSACASSCF(4, k=2, weight_vector=w.numpy(),
                               problem=_Tensors(h, g,
                                                h2_631g.num_particles),
                               maxiter=20,
                               initial_partial_unitary=U0.numpy(),
                               device="cpu")
    # the default seed (lowest diagonal determinants) is the JAX one
    np.testing.assert_array_equal(port._V0.numpy(), V0.numpy())
    r = port.compute_energies()
    np.testing.assert_allclose(r.eigenvalues, ref.eigenvalues, rtol=0,
                               atol=1e-8)
    np.testing.assert_array_almost_equal(r.eigenvalues, MCVQE_REFERENCE,
                                         decimal=5)
    assert r.outer_iterations == ref.outer_iterations
    np.testing.assert_allclose(r.optimal_partial_unitary,
                               ref.optimal_partial_unitary, rtol=0,
                               atol=1e-8)
    for k in ("natural_occupations", "spin_squared", "one_rdm_spatial",
              "spin_density_spatial", "transition_rdm1_spatial"):
        np.testing.assert_allclose(getattr(r, k), getattr(ref, k), rtol=0,
                                   atol=1e-8, err_msg=k)
    with pytest.raises(AttributeError, match="compute_energies"):
        port.compute_minimum_energy()


@pytest.mark.parametrize("kw", [dict(dispatch="two"),
                                dict(dispatch="two", davidson_chunk=3),
                                dict(dispatch="two", davidson_chunk=3,
                                     davidson_tol_ladder=True)],
                         ids=["two", "chunk", "ladder"])
def test_sa_casscf_dispatch_options_match_jax(h2_631g, kw):
    jsolver = JSACASSCF(4, k=2, problem=h2_631g, maxiter=8, **kw)
    ref = jsolver.compute_energies()
    solver = FusedOptOrbSACASSCF(4, k=2, problem=h2_631g, maxiter=8,
                                 device="cpu", **kw)
    r = solver.compute_energies()
    np.testing.assert_allclose(r.eigenvalues, ref.eigenvalues, rtol=0,
                               atol=1e-8)
    assert r.outer_iterations == ref.outer_iterations
    # the JAX package's per-solve stage_stats on the solver
    if "davidson_chunk" in kw:
        assert (solver.stage_stats["davidson_iters"]
                == jsolver.stage_stats["davidson_iters"])
        assert (len(solver.stage_stats["orb_s"])
                == len(jsolver.stage_stats["orb_s"]))
        assert (len(solver.stage_stats["solve_s"])
                == len(solver.stage_stats["finish_s"])
                == len(jsolver.stage_stats["solve_s"]))


def test_sa_resume_seeds_as_jax(jax_sa, h2_631g, tmp_path):
    """A resumed SA run takes the checkpoint's U but, as in the JAX
    package, not its (k, nd) block: the seed stays the lowest-diagonal
    determinants of the resumed U (esoo_tpu casscf.py:408-414, 852-867)."""
    _, ref = jax_sa
    path = jax_save_checkpoint(
        str(tmp_path / "sa.npz"), iteration=ref.outer_iterations,
        partial_unitary=ref.optimal_partial_unitary,
        energy_convergence_list=ref.energy_convergence_list,
        optimal_point=ref.optimal_point)
    port = FusedOptOrbSACASSCF(4, k=2, problem=h2_631g, resume_from=path,
                               device="cpu")
    jax_solver = JSACASSCF(4, k=2, problem=h2_631g, resume_from=path)
    np.testing.assert_array_equal(port._V0.numpy(),
                                  np.asarray(jax_solver._V0))
    np.testing.assert_array_equal(port._U0.numpy(),
                                  ref.optimal_partial_unitary)


# -- options and the device policy -------------------------------------------

def test_casscf_options_validated_as_in_jax(h2_631g, monkeypatch):
    def make(**kw):
        return FusedOptOrbCASSCF(4, problem=h2_631g, device="cpu", **kw)

    # mesh= is ported: a non-mesh raises TypeError, a 2-D state x orb
    # mesh NotImplementedError (its state axis is not ported)
    with pytest.raises(TypeError, match="OrbitalMesh"):
        make(mesh=object())
    with pytest.raises(NotImplementedError, match="state axis"):
        make(mesh=make_orbital_state_mesh(2, 2, devices=["cpu"] * 4))
    # compact storage: the JAX package's int8 stacks
    comp = make(table_storage="compact")
    jcomp = JCASSCF(4, problem=h2_631g, table_storage="compact")
    assert comp.table_storage == jcomp.table_storage == "compact"
    for k in ("MA8", "MB8"):
        np.testing.assert_array_equal(comp._sector_tables[k].numpy(),
                                      np.asarray(jcomp._sector_tables[k]))
    with pytest.raises(ValueError, match="table_storage"):
        make(table_storage="int8")
    with pytest.raises(ValueError, match="davidson_chunk"):
        make(davidson_chunk=3)
    with pytest.raises(ValueError, match="davidson_chunk"):
        make(dispatch="two", davidson_chunk=0)
    with pytest.raises(ValueError, match="davidson_tol_ladder"):
        make(davidson_tol_ladder=True)
    with pytest.raises(ValueError, match="dispatch"):
        make(dispatch="three")
    with pytest.raises(ValueError, match="maxiter"):
        make(maxiter=0)
    with pytest.raises(ValueError, match="num_particles"):
        FusedOptOrbCASSCF(4, integral_tensors=(np.zeros((4, 4)),
                                               np.zeros((4,) * 4)),
                          device="cpu")
    with pytest.raises(ValueError, match="max_subspace"):
        FusedOptOrbSACASSCF(4, k=2, problem=h2_631g, max_subspace=3,
                            device="cpu")
    with pytest.raises(ValueError, match="k="):
        FusedOptOrbSACASSCF(4, k=5, problem=h2_631g, device="cpu")
    # 'auto' resolves to the compact tables past _COMPACT_MIN_ND
    assert make().table_storage == "dense"
    monkeypatch.setattr(TC, "_COMPACT_MIN_ND", 3)
    monkeypatch.setattr(JCASSCF_MODULE, "_COMPACT_MIN_ND", 3)
    auto = make(table_storage="auto")
    assert auto.table_storage == "compact" == JCASSCF(
        4, problem=h2_631g).table_storage
    assert "MA8" in auto._sector_tables
    assert make(table_storage="dense").table_storage == "dense"


def test_casscf_defaults_to_the_card(h2_631g, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedOptOrbCASSCF(4, problem=h2_631g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedOptOrbSACASSCF(4, k=2, problem=h2_631g)
