"""esoo_torch.parallel (the orbital mesh over the integral tensor) against
esoo_tpu.parallel and against the port's unsharded solvers, float64 on
the CPU: the port's meshes name the CPU several times (logical shards),
the JAX package's run on the conftest's 8 virtual CPU devices.

Tolerances: the sharded primitives 1e-12 of max(1, |ref|) against the
JAX package's; solver energies 1e-9 against the port's and the JAX
package's unsharded runs (the shards sum the transform in another order,
and the BB stop test amplifies last-bit differences); the
MULTICHIP_r05.json stanzas (the JAX package's 8-device dry run) at 1e-6.
No JAX fused program is compiled under a mesh here (tests/test_parallel.py
says why): the JAX side of each solver comparison runs unsharded."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esoo_torch.orbital_optimization as TP_FUSED
import esoo_torch.sim as TP_SIM
import esoo_tpu.parallel as JP
from __graft_entry__ import _toy_problem
from conftest import random_hermitian_tensors
from esoo_torch import parallel as TP
from esoo_torch.convert import problem_from_numpy
from esoo_torch.ops import gemm
from esoo_torch.orbital_optimization.kernels import rotate_two_body
from esoo_torch.orbital_optimization.stiefel import orth
from esoo_tpu.orbital_optimization.kernels import (
    expand_spin_tensors as j_expand, rotated_energy_spatial as j_energy)
from test_torch_engine import same_eri_engine  # noqa: F401

jax.config.update("jax_enable_x64", True)

# MULTICHIP_r05.json: dryrun_multichip(8) on the toy problem (m=16 -> 4)
MULTICHIP_VQE = -11.052583
MULTICHIP_CASSCF = -11.052567


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64))


def assert_close(out, ref, rtol=1e-12):
    out, ref = np.asarray(out, dtype=np.float64), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale)


def _cpu_mesh(d: int):
    return TP.make_orbital_mesh(devices=["cpu"] * d)


@pytest.fixture(scope="module")
def toy():
    """tests/test_parallel.py's toy: m = 12 -> n = 3."""
    m, n = 12, 3
    h, g = random_hermitian_tensors(m, seed=42)
    g = g / m
    rng = np.random.default_rng(1)
    gamma_s = np.diag(rng.uniform(0, 2, n))
    Gamma_s = rng.normal(size=(n, n, n, n)) / n
    U = np.asarray(orth(_t(rng.normal(size=(m, n)))))
    return U, gamma_s, Gamma_s, h, g


def _jax_energy(ndev, U, gamma_s, Gamma_s, h, g):
    mesh = JP.make_orbital_mesh(ndev)
    h_rep, g_sh = JP.shard_problem_tensors(mesh, h, g)
    efn = JP.sharded_rotated_energy(mesh)
    return jax.value_and_grad(lambda u: efn(
        u, jnp.asarray(gamma_s), jnp.asarray(Gamma_s), h_rep, g_sh))(
        jnp.asarray(U))


def _torch_energy(ndev, U, gamma_s, Gamma_s, h, g):
    mesh = _cpu_mesh(ndev)
    h_t, shards = TP.shard_problem_tensors(mesh, h, g)
    u = _t(U).requires_grad_(True)
    e = TP.sharded_rotated_energy(mesh)(u, _t(gamma_s), _t(Gamma_s), h_t,
                                        shards)
    (grad,) = torch.autograd.grad(e, u)
    return e.detach(), grad


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_energy_and_gradient_match_jax(toy, ndev):
    e_j, g_j = _jax_energy(ndev, *toy)
    e_t, g_t = _torch_energy(ndev, *toy)
    assert_close(e_t, e_j)
    assert_close(g_t, g_j)
    U, gamma_s, Gamma_s, h, g = toy
    assert_close(e_t, j_energy(*(jnp.asarray(a) for a in toy)))


def test_uneven_padding_matches_jax():
    """m = 10 over 4 shards: g padded to 12 columns, three per shard."""
    m, n = 10, 2
    h, g = random_hermitian_tensors(m, seed=3)
    rng = np.random.default_rng(2)
    gamma_s = np.eye(n)
    Gamma_s = rng.normal(size=(n, n, n, n))
    U = np.asarray(orth(_t(rng.normal(size=(m, n)))))
    h_t, shards = TP.shard_problem_tensors(_cpu_mesh(4), h, g)
    assert [tuple(s.shape) for s in shards] == [(10, 10, 10, 3)] * 4
    assert float(shards[-1][..., 1:].abs().max()) == 0.0
    args = (U, gamma_s, Gamma_s, h, g)
    e_j, g_j = _jax_energy(4, *args)
    e_t, g_t = _torch_energy(4, *args)
    assert_close(e_t, e_j)
    assert_close(g_t, g_j)
    # the padded shards rotate to the unsharded transform
    ref = rotate_two_body(_t(g), _t(U))
    assert_close(TP.rotate_two_body_sharded(_cpu_mesh(4), shards, _t(U)),
                 ref)


@pytest.mark.parametrize("m,n,d", [(12, 3, 4), (10, 5, 4), (16, 2, 8)])
def test_sharded_spatial_energy_matches_the_unsharded_objective(m, n, d):
    """The fused solvers' mesh objective (each shard runs
    rotated_energy_spatial's kron sandwich, n^2 <= 2m, or its minor-axis
    chain, over its s rows) against the JAX package's unsharded
    rotated_energy_spatial and its gradient; (10, 5) pads g to 12."""
    h, g = random_hermitian_tensors(m, seed=m + n)
    rng = np.random.default_rng(d)
    gamma_s = np.diag(rng.uniform(0, 2, n))
    Gamma_s = rng.normal(size=(n, n, n, n)) / n
    U = np.asarray(orth(_t(rng.normal(size=(m, n)))))
    e_j, g_j = jax.value_and_grad(j_energy)(
        jnp.asarray(U), jnp.asarray(gamma_s), jnp.asarray(Gamma_s),
        jnp.asarray(h), jnp.asarray(g))
    mesh = _cpu_mesh(d)
    h_t, shards = TP.shard_problem_tensors(mesh, h, g)
    u = _t(U).requires_grad_(True)
    e = TP.sharded_spatial_energy(mesh)(u, _t(gamma_s), _t(Gamma_s), h_t,
                                        shards)
    (grad,) = torch.autograd.grad(e, u)
    assert_close(e.detach(), e_j)
    assert_close(grad, g_j)


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_bb_step_matches_jax(toy, k):
    U, gamma_s, Gamma_s, h, g = toy
    rng = np.random.default_rng(5)
    U_prev = np.asarray(orth(_t(U + 0.05 * rng.normal(size=U.shape))))
    G_prev = 0.1 * rng.normal(size=U.shape)
    jmesh = JP.make_orbital_mesh(4)
    h_rep, g_sh = JP.shard_problem_tensors(jmesh, h, g)
    ref = JP.sharded_bb_step(jmesh)(
        jnp.asarray(U), jnp.asarray(U_prev), jnp.asarray(G_prev), k,
        jnp.asarray(gamma_s), jnp.asarray(Gamma_s), h_rep, g_sh)
    mesh = _cpu_mesh(4)
    h_t, shards = TP.shard_problem_tensors(mesh, h, g)
    out = TP.sharded_bb_step(mesh)(_t(U), _t(U_prev), _t(G_prev), k,
                                   _t(gamma_s), _t(Gamma_s), h_t, shards)
    for a, b in zip(out, ref):
        assert_close(a, b)


def test_sharded_optimizer_matches_jax(toy):
    """30 BB steps with no early stop on both sides, from the same U."""
    U, gamma_s, Gamma_s, h, g = toy
    jmesh = JP.make_orbital_mesh(8)
    h_rep, g_sh = JP.shard_problem_tensors(jmesh, h, g)
    kw = dict(stopping_tolerance=0.0, maxiter=30)
    U_j, E_j = JP.ShardedOrbitalOptimizer(jmesh, **kw).\
        compute_optimal_rotation(U, jnp.asarray(gamma_s),
                                 jnp.asarray(Gamma_s), h_rep, g_sh)
    mesh = _cpu_mesh(8)
    h_t, shards = TP.shard_problem_tensors(mesh, h, g)
    U_t, E_t = TP.ShardedOrbitalOptimizer(mesh, **kw).\
        compute_optimal_rotation(U, gamma_s, Gamma_s, h_t, shards)
    assert_close(U_t, U_j)
    assert_close(E_t, E_j)


@pytest.mark.parametrize("m,d", [(12, 4), (8, 8), (10, 4)])
def test_shard_transform_plain_sums_to_the_transform(m, d):
    """gemm.rotate_two_body_shard over the shards of g sums to the
    unsharded transform (the JAX package's rotate_two_body at 1e-12)."""
    from esoo_tpu.orbital_optimization.kernels import (
        rotate_two_body as j_rotate)
    n = 3
    _, g = random_hermitian_tensors(m, seed=m)
    U = np.asarray(orth(_t(np.random.default_rng(m).normal(size=(m, n)))))
    _, shards = TP.shard_problem_tensors(_cpu_mesh(d), np.eye(m), g)
    m_loc = shards[0].shape[-1]
    u_pad = np.zeros((m_loc * d, n))
    u_pad[:m] = U
    total = sum(gemm.rotate_two_body_shard(s, _t(U),
                                           _t(u_pad[i * m_loc:(i + 1) * m_loc]))
                for i, s in enumerate(shards))
    assert_close(total, j_rotate(jnp.asarray(g), jnp.asarray(U)))


def test_mesh_construction_and_refusals():
    mesh = _cpu_mesh(4)
    assert mesh.shape == {"orb": 4}
    assert mesh.device == torch.device("cpu")
    assert len(mesh.devices) == 4
    st = TP.make_orbital_state_mesh(n_orb=2, n_state=2, devices=["cpu"] * 4)
    assert st.shape == {"state": 2, "orb": 2}
    with pytest.raises(ValueError, match="n_devices"):
        TP.make_orbital_mesh(3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="at least one"):
        TP.make_orbital_mesh(devices=[])
    if not torch.cuda.is_available():
        # no card: no default mesh, and no CUDA device in a given list
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.make_orbital_mesh()
        with pytest.raises(RuntimeError, match="is_available"):
            TP.make_orbital_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(TypeError, match="OrbitalMesh"):
        TP.shard_problem_tensors(object(), np.eye(4), np.zeros((4,) * 4))
    with pytest.raises(NotImplementedError, match="operator-axis"):
        TP.shard_sector_tables(mesh, None, torch.float64)


# -- the solvers on a mesh -----------------------------------------------------

class _Tensors:
    """A problem that hands over spatial tensors as they are."""

    def __init__(self, h, g, num_particles=(1, 1)):
        self._t = (h, g)
        self.num_particles = num_particles

    def spatial_integral_tensors(self):
        return self._t


@pytest.fixture(scope="module")
def toy16():
    """__graft_entry__.dryrun_multichip(8)'s fused problem: m = 16 -> 4
    spin orbitals, the spin-orbital tensors of _toy_problem(16, 2)."""
    _, _, _, h, g = _toy_problem(16, 2)
    h_so, g_so = (np.asarray(a) for a in j_expand(jnp.asarray(h),
                                                  jnp.asarray(g)))
    return h, g, h_so, g_so


def _t_vqe(**kw):
    return TP_FUSED.FusedOptOrbVQE(
        4, TP_SIM.UCCSD(2, (1, 1), initial_state=TP_SIM.HartreeFock(
            2, (1, 1))), device="cpu", **kw)


def _fused_h4(kind, problem, mesh=None):
    """H4 6-31G -> 8 spin orbitals (m = 8: one row of g a shard on an
    8-shard mesh) in either package."""
    if kind.startswith("jax"):
        from esoo_tpu.orbital_optimization import (FusedOptOrbCASSCF as C,
                                                   FusedOptOrbVQE as V)
        from esoo_tpu.sim import HartreeFock as HF, UCCSD as U
        kw = {}
    else:
        C, V = TP_FUSED.FusedOptOrbCASSCF, TP_FUSED.FusedOptOrbVQE
        HF, U = TP_SIM.HartreeFock, TP_SIM.UCCSD
        kw = dict(device="cpu", mesh=mesh)
    if kind.endswith("casscf"):
        return C(8, problem=problem, **kw).compute_minimum_energy()
    return V(8, U(4, (2, 2), initial_state=HF(4, (2, 2))), problem=problem,
             **kw).compute_minimum_energy()


@pytest.mark.parametrize("kind", ["vqe", "casscf"])
def test_fused_on_8_shards_matches_unsharded_runs(h4_631g, kind):
    tp = problem_from_numpy(dataclasses.asdict(h4_631g))
    r = _fused_h4(kind, tp, _cpu_mesh(8))
    base = _fused_h4(kind, tp)
    ref = _fused_h4("jax" + kind, h4_631g)
    assert r.outer_iterations == base.outer_iterations
    assert abs(r.eigenvalue - base.eigenvalue) <= 1e-9
    assert abs(r.eigenvalue - ref.eigenvalue) <= 1e-9


@pytest.mark.parametrize("case", ["vqe", "vqe_two_dispatch", "casscf"])
def test_multichip_stanzas_on_8_shards(toy16, case):
    """MULTICHIP_r05.json's fused sharded OptOrbVQE (one and two
    dispatches) and sharded exact CASSCF on the toy problem, maxiter 2."""
    h, g, h_so, g_so = toy16
    mesh = _cpu_mesh(8)
    if case == "casscf":
        solver = TP_FUSED.FusedOptOrbCASSCF(4, problem=_Tensors(h, g),
                                            maxiter=2, mesh=mesh,
                                            device="cpu")
        ref = MULTICHIP_CASSCF
    else:
        solver = _t_vqe(integral_tensors=(h_so, g_so), maxiter=2,
                        mesh=mesh, dispatch="two" if "two" in case
                        else "one")
        ref = MULTICHIP_VQE
    assert solver._g_sp is None and len(solver._g_shards) == 8
    r = solver.compute_minimum_energy()
    assert r.outer_iterations == 2
    assert abs(r.eigenvalue - ref) <= 1e-6


def _family(name, h2, mesh):
    """One fused solver of each family on H2 6-31G -> 4."""
    S = TP_SIM
    hf = S.HartreeFock(2, (1, 1))
    kw = dict(problem=h2, mesh=mesh, device="cpu", maxiter=20)
    inits = [hf, S.OccupationState(4, 0b0110)]
    if name == "ssvqe":
        return TP_FUSED.FusedOptOrbSSVQE(4, S.UCCSD(2, (1, 1), reps=2),
                                         initial_states=inits,
                                         weight_vector=[2, 1], **kw)
    if name == "mcvqe":
        return TP_FUSED.FusedOptOrbMCVQE(4, S.UCCSD(2, (1, 1)),
                                         num_particles=(1, 1), k=2, **kw)
    if name == "vqd":
        return TP_FUSED.FusedOptOrbVQD(4, S.UCCSD(2, (1, 1), reps=2),
                                       initial_states=inits, **kw)
    if name == "adapt":
        return TP_FUSED.FusedOptOrbAdaptVQE(
            4, S.UCCSD(2, (1, 1), initial_state=hf), **kw)
    if name == "sacasscf":
        return TP_FUSED.FusedOptOrbSACASSCF(4, k=2, **kw)
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["ssvqe", "mcvqe", "vqd", "adapt",
                                  "sacasscf"])
def test_every_fused_family_takes_a_mesh(h2_631g, name):
    """Each fused solver on a 4-shard mesh (H2 6-31G: m = 4, one row of
    g a shard) against its unsharded run."""
    h2 = problem_from_numpy(dataclasses.asdict(h2_631g))
    run = (lambda s: s.compute_minimum_energy().eigenvalue) \
        if name == "adapt" else \
        (lambda s: s.compute_energies().eigenvalues)
    sharded = run(_family(name, h2, _cpu_mesh(4)))
    base = run(_family(name, h2, None))
    np.testing.assert_allclose(sharded, base, rtol=0, atol=1e-9)


def _class_vqe(pkg, problem, mesh, **kw):
    import esoo_torch as T
    import esoo_tpu.orbital_optimization as JO
    import esoo_tpu.sim as JS
    import esoo_tpu.solvers as JV
    if pkg == "jax":
        S, V, O, dk = JS, JV, JO, {}
    else:
        S = V = O = T
        dk = {"device": "cpu"}
    ans = S.UCCSD(2, (1, 1), initial_state=S.HartreeFock(2, (1, 1)))
    vqe = V.VQE(S.Estimator(**dk), ans, V.L_BFGS_B(),
                initial_point=np.zeros(ans.num_parameters), **dk)
    pupo = O.PartialUnitaryProjectionOptimizer(1e-3, 1e-5, 10000, **dk)
    return O.OptOrbVQE(num_spin_orbitals=4, ground_state_solver=vqe,
                       partial_unitary_optimizer=pupo, problem=problem,
                       maxiter=20, mesh=mesh, **dk, **kw)


def test_class_optorbvqe_on_8_shards(h2_631g):
    """The class-based OptOrbVQE with its BB descent over 8 shards (m = 4
    padded to 8) against the port's and the JAX package's unsharded runs
    and the reference anchor."""
    tp = problem_from_numpy(dataclasses.asdict(h2_631g))
    solver = _class_vqe("torch", tp, _cpu_mesh(8))
    assert [tuple(s.shape) for s in solver._sharded["g"]] == \
        [(4, 4, 4, 1)] * 8
    r = solver.compute_minimum_energy()
    base = _class_vqe("torch", tp, None).compute_minimum_energy()
    ref = _class_vqe("jax", h2_631g, None).compute_minimum_energy()
    assert abs(r.eigenvalue - base.eigenvalue) <= 1e-9
    assert abs(r.eigenvalue - ref.eigenvalue) <= 1e-9
    assert abs(r.eigenvalue - -1.8661038079694765) <= 1e-3


def test_solver_mesh_refusals(h2_631g, toy16):
    _, _, h_so, g_so = toy16
    kw = dict(integral_tensors=(h_so, g_so), maxiter=2)
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        _t_vqe(mesh=_cpu_mesh(3), **kw)
    with pytest.raises(TypeError, match="OrbitalMesh"):
        _t_vqe(mesh=object(), **kw)
    state_mesh = TP.make_orbital_state_mesh(2, 2, devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="state axis"):
        _t_vqe(mesh=state_mesh, **kw)
    with pytest.raises(NotImplementedError, match="state axis"):
        TP_FUSED.FusedOptOrbCASSCF(4, problem=_Tensors(*toy16[:2]),
                                   mesh=state_mesh, device="cpu")
    meta = TP.make_orbital_mesh(devices=["meta"] * 2)
    with pytest.raises(ValueError, match="mesh"):
        _t_vqe(mesh=meta, **kw)
