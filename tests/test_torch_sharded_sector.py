"""esoo_torch's sector tables on a mesh (parallel.shard_sector_tables, the
sharded string kernels of sim/sharded_strings.py) and the state axis of
the 2-D mesh, against the port's unsharded runs and esoo_tpu's, float64
on the CPU.  The port's meshes name the CPU several times (logical
shards); the JAX package's run on the conftest's 8 virtual CPU devices.

Tolerances: the kernels (quadform, its theta-gradient, sigma, the RDMs,
the diagonal, the transition 1-RDM) 1e-12 of max(1, max|ref|) against
the unsharded port and the JAX package's sharded tables; the fused
solvers 1e-9 against the port's unsharded runs (the shards sum in
another order, and L-BFGS and the BB stop test amplify last bits;
tests/test_torch_parallel.py) and 1e-7 against the JAX package's (the
inter-package tolerance of tests/test_torch_eigensolvers.py); the
SSVQE anchors of BASELINE.md at decimal 3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esoo_torch as T
import esoo_tpu.orbital_optimization as JO
import esoo_tpu.parallel as JP
import esoo_tpu.sim.sector as jsector
from conftest import random_hermitian_tensors
from esoo_torch import parallel as TP
from esoo_torch.convert import problem_from_numpy
from esoo_torch.sim import sector as tsector
from esoo_tpu.orbital_optimization.kernels import expand_spin_tensors
from esoo_tpu.sim import HartreeFock as JHF, QuantumCircuit as JQC
from esoo_tpu.sim import UCCSD as JUCCSD
from esoo_tpu.sim import strings as jstrings
from test_torch_engine import same_eri_engine  # noqa: F401

jax.config.update("jax_enable_x64", True)

SSVQE_ANCHORS = [-1.85403538, -1.37044354]       # BASELINE.md
# (n, particles, shards): n^2 = 4 operators padded to 8, and 9 to 12
KERNEL_CASES = [(2, (1, 1), 8), (3, (2, 1), 4)]


def assert_close(out, ref, tol=1e-12):
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale)


def _cpu_mesh(d: int):
    return TP.make_orbital_mesh(devices=["cpu"] * d)


def _integrals(n: int, seed: int):
    h, g = random_hermitian_tensors(n, seed=seed)
    return tuple(np.array(a) for a in expand_spin_tensors(jnp.asarray(h),
                                                          jnp.asarray(g)))


@pytest.fixture(scope="module",
                params=[(c, s) for c in KERNEL_CASES
                        for s in ("dense", "compact")],
                ids=lambda p: f"n{p[0][0]}-d{p[0][2]}-{p[1]}")
def ucc_case(request):
    """(JAX sector and sharded tables, port sector and sharded tables,
    h, g, theta) of a UCCSD sector."""
    (n, parts, D), storage = request.param
    js = jsector.SectorUCC(JUCCSD(n, parts, initial_state=JHF(n, parts)),
                           2 * n, kernel="strings")
    ts = tsector.SectorUCC(T.UCCSD(n, parts,
                                   initial_state=T.HartreeFock(n, parts)),
                           2 * n, kernel="strings")
    jt = JP.shard_sector_tables(JP.make_orbital_mesh(D), js, np.float64,
                                storage=storage)
    tt = TP.shard_sector_tables(_cpu_mesh(D), ts, torch.float64,
                                storage=storage)
    h, g = _integrals(n, 7 + n)
    th = np.random.default_rng(13 + n).normal(size=len(ts._excs)) * 0.3
    return (js, jt), (ts, tt), h, g, th


def test_shard_layout_as_in_jax(ucc_case):
    """D contiguous shards of the zero-padded operator axis, one a mesh
    device; int8 under 'compact'; the rest replicated."""
    (_, jt), (ts, tt), *_ = ucc_case
    D = len(tt.MA)
    q = ts._str_tabs.MA.shape[0]
    assert tt.q_pad == jt["MA"].shape[0] and tt.q_pad % D == 0
    assert tt.q_pad - q < D
    assert tt.storage in ("dense", "compact")
    want = torch.int8 if tt.storage == "compact" else torch.float64
    for d in range(D):
        for M_t, key in ((tt.MA[d], "MA"), (tt.MB[d], "MB")):
            assert M_t.dtype == want and M_t.shape[0] == tt.c
            np.testing.assert_array_equal(
                M_t.numpy(), np.asarray(jt[key])[d * tt.c:(d + 1) * tt.c])
    assert float(tt.MA[-1][q - (D - 1) * tt.c:].abs().max()) == 0.0
    assert "MA" not in tt.rep and "M" in tt.rep and "LIN_A" in tt.rep
    assert tt.rows == (tt,)


def _jax_energy(js, h, g, tables):
    def energy(t):
        v = js.state(t, tables=tables)
        return js.quadform_values(v, js.build_values(
            jnp.asarray(h), jnp.asarray(g), tables=tables), tables=tables)
    return energy


def _port_energy(ts, h, g, tables):
    def energy(t):
        vals = ts.build_values(torch.as_tensor(h), torch.as_tensor(g),
                               tables)
        return ts.quadform_values(ts.state_matrix(t, tables), vals, tables)
    return energy


def test_quadform_and_gradient_on_shards(ucc_case):
    (js, jt), (ts, tt), h, g, th = ucc_case
    e_j, g_j = jax.jit(jax.value_and_grad(_jax_energy(js, h, g, jt)))(
        jnp.asarray(th))
    t = torch.as_tensor(th).requires_grad_(True)
    e_t = _port_energy(ts, h, g, tt)(t)
    (g_t,) = torch.autograd.grad(e_t, t)
    t0 = torch.as_tensor(th).requires_grad_(True)
    e_0 = _port_energy(ts, h, g, None)(t0)
    (g_0,) = torch.autograd.grad(e_0, t0)
    for ref in ((e_0, g_0), (e_j, g_j)):
        assert_close(e_t, ref[0].detach() if torch.is_tensor(ref[0])
                     else ref[0])
        assert_close(g_t, ref[1])


def test_batched_states_through_the_sharded_sigma(ucc_case):
    """(k, nB, nA) states through one theta: the k quadforms and the
    weighted sum's gradient, against the unsharded tables."""
    _, (ts, tt), h, g, th = ucc_case
    rng = np.random.default_rng(2)
    V0 = torch.as_tensor(rng.normal(size=(3,) + ts.state_shape))
    w = torch.tensor([3.0, 2.0, 1.0], dtype=torch.float64)
    out = []
    for tables in (tt, None):
        t = torch.as_tensor(th).requires_grad_(True)
        vals = ts.build_values(torch.as_tensor(h), torch.as_tensor(g),
                               tables)
        es = ts.quadform_values(ts.apply_matrix(V0, t, tables), vals,
                                tables)
        (grad,) = torch.autograd.grad(w @ es, t)
        out.append((es.detach(), grad))
    assert_close(out[0][0], out[1][0].numpy())
    assert_close(out[0][1], out[1][1].numpy())


def test_rdms_on_shards(ucc_case):
    (js, jt), (ts, tt), _, _, th = ucc_case
    r_j = jax.jit(lambda t: js.rdms(js.state(t, tables=jt), tables=jt))(
        jnp.asarray(th))
    r_0 = ts.rdms(ts.state(torch.as_tensor(th)))
    r_t = ts.rdms(ts.state(torch.as_tensor(th), tt), tt)
    for got, ref0, refj in zip(r_t, r_0, r_j):
        assert_close(got, ref0.numpy())
        assert_close(got, refj)


@pytest.fixture(scope="module",
                params=[(c, s) for c in KERNEL_CASES
                        for s in ("dense", "compact")],
                ids=lambda p: f"n{p[0][0]}-d{p[0][2]}-{p[1]}")
def ci_case(request):
    """The gate-free SectorCI of the same sectors: (JAX sector and
    tables, port sector and tables, sigma operators of each, states)."""
    (n, parts, D), storage = request.param
    js, ts = jsector.SectorCI(2 * n, parts), T.SectorCI(2 * n, parts)
    jt = JP.shard_sector_tables(JP.make_orbital_mesh(D), js, np.float64,
                                storage=storage)
    tt = TP.shard_sector_tables(_cpu_mesh(D), ts, torch.float64,
                                storage=storage)
    h, g = _integrals(n, 3 + n)
    rng = np.random.default_rng(9 + n)
    V = rng.normal(size=(ts.nB, ts.nA))
    U = rng.normal(size=(2, ts.nB, ts.nA))
    vals_j = js.build_values(jnp.asarray(h), jnp.asarray(g), tables=jt)
    vals_t = ts.build_values(torch.as_tensor(h), torch.as_tensor(g), tt)
    vals_0 = ts.build_values(torch.as_tensor(h), torch.as_tensor(g))
    return (js, jt, vals_j), (ts, tt, vals_t, vals_0), V, U


def test_sigma_operators_on_shards(ci_case):
    (_, _, vals_j), (_, _, vals_t, vals_0), *_ = ci_case
    for k in ("G2", "FA", "FB"):
        assert_close(vals_t[k], np.asarray(vals_j[k]))
    assert_close(vals_t["FA"], vals_0["FA"].numpy())


def test_sigma_and_diagonal_on_shards(ci_case):
    (js, jt, vals_j), (ts, tt, vals_t, vals_0), V, _ = ci_case
    s_t = ts.sigma_values(torch.as_tensor(V), vals_t, tt)
    assert_close(s_t, ts.sigma_values(torch.as_tensor(V), vals_0).numpy())
    assert_close(s_t, js.sigma_values(jnp.asarray(V), vals_j, tables=jt))
    d_t = ts.diagonal_values(vals_t, tt)
    assert_close(d_t, ts.diagonal_values(vals_0).numpy())
    assert_close(d_t, jstrings.diagonal(vals_j, jt))


def test_ci_rdms_and_transition_rdm1_on_shards(ci_case):
    (js, jt, _), (ts, tt, _, _), V, U = ci_case
    V_t, U_t = torch.as_tensor(V), torch.as_tensor(U)
    for got, ref0, refj in zip(ts.rdms(V_t, tt), ts.rdms(V_t),
                               js.rdms(jnp.asarray(V), tables=jt)):
        assert_close(got, ref0.numpy())
        assert_close(got, refj)
    t1 = ts.transition_rdm1(U_t, V_t, tt)
    assert_close(t1, ts.transition_rdm1(U_t, V_t).numpy())
    assert_close(t1, js.transition_rdm1(jnp.asarray(U), jnp.asarray(V),
                                        tables=jt))
    assert_close(ts.transition_rdm1(U_t[0], V_t, tt),
                 ts.transition_rdm1(U_t[0], V_t).numpy())


def test_state_mesh_tables_hold_each_rows_shards():
    """A 2-D mesh repeats the orb shards on each state row; the
    refusals are the JAX package's."""
    sec = T.SectorCI(6, (2, 1))
    mesh = TP.make_orbital_state_mesh(n_orb=2, n_state=3,
                                      devices=["cpu"] * 6)
    tt = TP.shard_sector_tables(mesh, sec, torch.float64)
    assert len(tt.rows) == 3 and tt.rows[0] is tt
    assert [len(r.MA) for r in tt.rows] == [2, 2, 2]
    for r in tt.rows[1:]:
        for a, b in zip(r.MA, tt.MA):
            assert torch.equal(a, b)
    pairs = tsector.SectorUCC(T.UCCSD(2, (1, 1), initial_state=T.HartreeFock(
        2, (1, 1))), 4, kernel="pairs")
    jpairs = jsector.SectorUCC(JUCCSD(2, (1, 1), initial_state=JHF(
        2, (1, 1))), 4, kernel="pairs")
    for shard, m, s in ((TP.shard_sector_tables, _cpu_mesh(2), pairs),
                        (JP.shard_sector_tables, JP.make_orbital_mesh(2),
                         jpairs)):
        with pytest.raises(ValueError, match="string-factorized"):
            shard(m, s, np.float64)
    with pytest.raises(ValueError, match="storage"):
        TP.shard_sector_tables(_cpu_mesh(2), sec, torch.float64,
                               storage="int8")


# -- the fused solvers on a mesh ----------------------------------------------

@pytest.fixture(scope="module")
def h2(h2_631g):
    return problem_from_numpy(dataclasses.asdict(h2_631g))


def _inits(pkg):
    if pkg == "jax":
        hf = JQC(4); hf.x(0); hf.x(2)
        ex = JQC(4); ex.x(1); ex.x(2)
        return [hf, ex]
    return [T.HartreeFock(2, (1, 1)), T.OccupationState(4, 0b0110)]


def _solver(pkg, name, problem, mesh=None, **kw):
    """H2 6-31G -> 4 spin orbitals: the JAX package's mesh tests'
    configurations (tests/test_parallel.py), in either package."""
    if pkg == "jax":
        O, dk = JO, {}
        U, HF = JUCCSD, JHF
    else:
        O, dk = T, {"device": "cpu"}
        U, HF = T.UCCSD, T.HartreeFock
    kw = dict(problem=problem, mesh=mesh, **dk, **kw)
    if name == "vqe":
        return O.FusedOptOrbVQE(4, U(2, (1, 1), initial_state=HF(2, (1, 1))),
                                maxiter=8, simulation="sector", **kw)
    if name == "ssvqe":
        return O.FusedOptOrbSSVQE(4, U(2, (1, 1), reps=2),
                                  initial_states=_inits(pkg),
                                  weight_vector=[2, 1], maxiter=20, **kw)
    if name == "vqd":
        return O.FusedOptOrbVQD(4, U(2, (1, 1), reps=2),
                                initial_states=_inits(pkg), betas=[2, 2],
                                maxiter=10, simulation="sector", **kw)
    if name == "adapt":
        return O.FusedOptOrbAdaptVQE(
            4, U(2, (1, 1), initial_state=HF(2, (1, 1))), maxiter=8,
            simulation="sector", **kw)
    raise AssertionError(name)


def _energies(solver):
    if hasattr(solver, "compute_energies"):
        return np.asarray(solver.compute_energies().eigenvalues)
    return np.asarray(solver.compute_minimum_energy().eigenvalue)


def test_fused_vqe_on_sharded_tables_matches_jax(h2_631g, h2):
    """tests/test_parallel.py's sharded-tables VQE: the same 4-device
    mesh in both packages, against each other and the unsharded run."""
    solver = _solver("torch", "vqe", h2, _cpu_mesh(4))
    assert isinstance(solver._sector_tables, TP.ShardedStringTables)
    e = _energies(solver)
    jsolver = _solver("jax", "vqe", h2_631g, JP.make_orbital_mesh(4))
    assert jsolver._sector_tables is not None
    np.testing.assert_allclose(e, _energies(jsolver), atol=1e-7)
    np.testing.assert_allclose(e, _energies(_solver("torch", "vqe", h2)),
                               atol=1e-9)


@pytest.mark.parametrize("name", ["ssvqe", "vqd", "adapt"])
def test_fused_family_on_sharded_tables(h2_631g, h2, name):
    """SSVQE, VQD and AdaptVQE on a 4-shard mesh (sector tables sharded)
    against the unsharded port and the JAX package's unsharded run (its
    own tests hold its mesh runs to its unsharded ones at 1e-10)."""
    solver = _solver("torch", name, h2, _cpu_mesh(4))
    assert solver._sector_tables is not None
    e = _energies(solver)
    np.testing.assert_allclose(e, _energies(_solver("torch", name, h2)),
                               atol=1e-9)
    np.testing.assert_allclose(e, _energies(_solver("jax", name, h2_631g)),
                               atol=1e-7)


def test_ssvqe_on_the_2d_state_mesh(h2_631g, h2):
    """tests/test_parallel.py's 2-D mesh (n_orb=4, n_state=2): the two
    states run on their own rows; equal to the unsharded run, to the JAX
    package's 2-D run and the anchors."""
    mesh = TP.make_orbital_state_mesh(n_orb=4, n_state=2,
                                      devices=["cpu"] * 8)
    solver = _solver("torch", "ssvqe", h2, mesh)
    assert [(d, sl) for d, sl, _ in solver._groups] == [
        (torch.device("cpu"), slice(0, 1)), (torch.device("cpu"),
                                             slice(1, 2))]
    assert solver._groups[1][2] is solver._sector_tables.rows[1]
    e = _energies(solver)
    np.testing.assert_allclose(e, _energies(_solver("torch", "ssvqe", h2)),
                               atol=1e-12)
    jmesh = JP.make_orbital_state_mesh(n_orb=4, n_state=2)
    np.testing.assert_allclose(
        e, _energies(_solver("jax", "ssvqe", h2_631g, jmesh)), atol=1e-7)
    np.testing.assert_array_almost_equal(e, SSVQE_ANCHORS, decimal=3)


def test_vqd_on_the_state_mesh_gathers(h2):
    """VQD takes the 2-D mesh and runs its states in sequence: the
    unsharded result."""
    mesh = TP.make_orbital_state_mesh(n_orb=2, n_state=2,
                                      devices=["cpu"] * 4)
    e = _energies(_solver("torch", "vqd", h2, mesh))
    np.testing.assert_allclose(e, _energies(_solver("torch", "vqd", h2)),
                               atol=1e-9)


def test_state_axis_divisibility_raises_as_in_jax(h2_631g, h2):
    three_t = _inits("torch") + [T.OccupationState(4, 0b1001)]
    q = JQC(4); q.x(0); q.x(3)
    three_j = _inits("jax") + [q]
    match = r"k=3 states not divisible by the state mesh axis \(2\)"
    with pytest.raises(ValueError, match=match):
        T.FusedOptOrbSSVQE(4, T.UCCSD(2, (1, 1), reps=2),
                           initial_states=three_t, problem=h2, device="cpu",
                           mesh=TP.make_orbital_state_mesh(
                               n_orb=4, n_state=2, devices=["cpu"] * 8))
    with pytest.raises(ValueError, match=match):
        JO.FusedOptOrbSSVQE(num_spin_orbitals=4, ansatz=JUCCSD(2, (1, 1),
                                                               reps=2),
                            initial_states=three_j, problem=h2_631g,
                            mesh=JP.make_orbital_state_mesh(n_orb=4,
                                                            n_state=2))


@pytest.mark.parametrize("storage", ["auto", "dense", "compact"])
def test_casscf_on_sharded_tables(h2_631g, h2, storage):
    """FusedOptOrb(SA)CASSCF on a mesh reports the JAX package's
    'sharded'/'sharded-compact' and runs Davidson, the RDMs and the
    transition RDMs on the shards: the unsharded energies."""
    want = "sharded-compact" if storage == "compact" else "sharded"
    jlabel = JO.FusedOptOrbCASSCF(4, problem=h2_631g, table_storage=storage,
                                  mesh=JP.make_orbital_mesh(4)).table_storage
    mesh = _cpu_mesh(4)
    kw = dict(problem=h2, table_storage=storage, device="cpu")
    cas = T.FusedOptOrbCASSCF(4, mesh=mesh, **kw)
    assert cas.table_storage == jlabel == want
    assert isinstance(cas._sector_tables, TP.ShardedStringTables)
    np.testing.assert_allclose(
        cas.compute_minimum_energy().eigenvalue,
        T.FusedOptOrbCASSCF(4, **kw).compute_minimum_energy().eigenvalue,
        atol=1e-9)
    sa = T.FusedOptOrbSACASSCF(4, k=2, mesh=mesh, **kw)
    assert sa.table_storage == want
    r = sa.compute_energies()
    r0 = T.FusedOptOrbSACASSCF(4, k=2, **kw).compute_energies()
    np.testing.assert_allclose(r.eigenvalues, r0.eigenvalues, atol=1e-9)
    np.testing.assert_allclose(r.transition_rdm1_spatial,
                               r0.transition_rdm1_spatial, atol=1e-7)
