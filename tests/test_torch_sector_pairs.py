"""esoo_torch's pairwise sector kernels (SectorUCC(kernel='pairs'), the
string kernels' oracle) against esoo_tpu's, float64 on the CPU.

Kernels on three sectors (H2-, H3- and H4-sized: n = 2, 3, 4 spatial
orbitals with (1, 1), (2, 1) and (2, 2) electrons; random integrals with
the chemistry symmetries), to 1e-12 of max(1, max|ref|): the state and
its theta-gradient through the reversible backward (also against
autograd through the plain gate scan), the batched scan,
build_values_pairs (tabled and untabled), build_hamiltonian,
quadform_values (value and gradients in v, diag, s_val and d_val), the
RDMs and the device tables.  Then, to 1e-9: FusedOptOrbVQE and
FusedOptOrbSSVQE with ESOO_SECTOR_KERNEL=pairs in both packages on H2
6-31G, the pairs sector against the string sector within the port (the
fused family on H2 6-31G, VQE on H3 6-31G doublet and H4 6-31G -> 8, the
class-based OptOrbVQE), and the Slater-Condon structure's disk cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esoo_torch as T
import esoo_torch.chem as TC
import esoo_tpu.sim.sector as jsector
from conftest import random_hermitian_tensors
from esoo_torch.convert import problem_from_numpy
from esoo_torch.initializations import ci as tci
from esoo_torch.sim import sector as tsector
from esoo_tpu.orbital_optimization import (FusedOptOrbSSVQE as JSSVQE,
                                           FusedOptOrbVQE as JVQE)
from esoo_tpu.orbital_optimization.kernels import expand_spin_tensors
from esoo_tpu.sim import HartreeFock as JHF, QuantumCircuit as JQC
from esoo_tpu.sim import UCCSD as JUCCSD
from test_torch_engine import same_eri_engine  # noqa: F401

jax.config.update("jax_enable_x64", True)

CASES = {"n2": (2, (1, 1)), "n3": (3, (2, 1)), "n4": (4, (2, 2))}
H3_GEOM = "H 0 0 0; H 0 0 0.9; H 0 0 1.8"


def assert_close(out, ref, rtol=1e-12):
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(JAX sector, port sector, spin-orbital h, g, theta) on kernel
    'pairs'."""
    n, parts = CASES[request.param]
    js = jsector.SectorUCC(JUCCSD(n, parts, initial_state=JHF(n, parts)),
                           2 * n, kernel="pairs")
    ts = tsector.SectorUCC(T.UCCSD(n, parts,
                                   initial_state=T.HartreeFock(n, parts)),
                           2 * n, kernel="pairs")
    h, g = random_hermitian_tensors(n, seed=7 + n)
    h, g = (np.asarray(a) for a in expand_spin_tensors(jnp.asarray(h),
                                                       jnp.asarray(g)))
    th = np.random.default_rng(13 + n).normal(size=len(ts._excs)) * 0.3
    return js, ts, h, g, th


def test_pairs_sector_as_in_jax(case):
    js, ts, *_ = case
    assert ts.kernel == js.kernel == "pairs"
    assert (ts.dim, ts.init_index) == (js.dim, js.init_index)
    assert ts.state_shape == (ts.dim + 1,)
    assert ts._content_key[1:] == js._content_key[1:]
    np.testing.assert_array_equal(ts._PARTNER, js._PARTNER)
    np.testing.assert_array_equal(ts._SFIELD, js._SFIELD)
    for a, b in zip(ts._row_tables(), js._row_tables()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts._rdm_tables(), js._rdm_tables()):
        np.testing.assert_array_equal(a, b)


def test_device_tables_keys_and_values(case):
    js, ts, *_ = case
    ref = js.device_tables()
    got = ts.device_tables(torch.float64, device="cpu")
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.dtype == (torch.int64 if np.asarray(ref[k]).dtype.kind
                           == "i" else torch.float64), k
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert ts.device_tables(torch.float64, device="cpu") is got


def test_state_and_reversible_gradient(case):
    """The state, and the theta-gradient of a seeded linear functional
    of it through the reversible backward, against the JAX package's
    (tabled: its reversible VJP) and autograd through the plain scan."""
    js, ts, _, _, th = case
    w = np.random.default_rng(3).normal(size=ts.dim + 1)
    T_j = js.device_tables()
    v_j, g_j = jax.value_and_grad(
        lambda t: jnp.dot(js.state(t, tables=T_j), jnp.asarray(w)))(
        jnp.asarray(th))
    assert_close(ts.state(_t(th)), js.state(jnp.asarray(th)))
    x = _t(th).requires_grad_(True)
    val = torch.dot(ts.state(x), _t(w))
    (grad,) = torch.autograd.grad(val, x)
    assert_close(val, v_j)
    assert_close(grad, g_j)
    tabs = ts.device_tables(torch.float64, device="cpu")
    x2 = _t(th).requires_grad_(True)
    v0 = torch.zeros(ts.dim + 1, dtype=torch.float64)
    v0[ts.init_index] = 1.0
    plain = tsector._apply_gates_tabled(v0, x2, tabs["PARTNER"],
                                        tabs["SFIELD"])
    (grad_plain,) = torch.autograd.grad(torch.dot(plain, _t(w)), x2)
    assert_close(grad, grad_plain)


def test_batched_gate_scan(case):
    """k = 3 states through one theta: each row is its own run, and the
    theta-gradient sums over the rows."""
    _, ts, _, _, th = case
    rng = np.random.default_rng(21)
    V0 = _t(rng.normal(size=(3, ts.dim + 1)))
    V0[:, -1] = 0.0
    W = _t(rng.normal(size=(3, ts.dim + 1)))
    x = _t(th).requires_grad_(True)
    out = ts.apply_matrix(V0, x)
    (grad,) = torch.autograd.grad(torch.sum(out * W), x)
    rows, grads = [], []
    for v0, w in zip(V0, W):
        xi = _t(th).requires_grad_(True)
        vi = ts.apply(v0, xi)
        rows.append(vi.detach())
        grads.append(torch.autograd.grad(torch.dot(vi, w), xi)[0])
    assert_close(out, torch.stack(rows).numpy())
    assert_close(grad, sum(grads).numpy())


@pytest.mark.parametrize("tabled", [True, False])
def test_build_values_pairs(case, tabled):
    js, ts, h, g, _ = case
    tables = ts.device_tables(torch.float64, device="cpu") if tabled \
        else None
    ref = js.build_values_pairs(jnp.asarray(h), jnp.asarray(g),
                                tables=js.device_tables() if tabled
                                else None)
    got = ts.build_values_pairs(_t(h), _t(g), tables)
    for a, b in zip(got, ref):
        assert_close(a, b)
    # build_values on a pairs sector is the tabled triple
    for a, b in zip(ts.build_values(_t(h), _t(g)), ref):
        assert_close(a, b)


def test_build_hamiltonian(case):
    js, ts, h, g, _ = case
    H = ts.build_hamiltonian(_t(h), _t(g))
    assert_close(H, js.build_hamiltonian(jnp.asarray(h), jnp.asarray(g)))
    assert_close(H, H.T.numpy())


def test_quadform_values_and_gradients(case):
    """<v|H|v> and its gradients in theta (through the state), v, diag,
    s_val and d_val against the JAX package's analytic VJP, and against
    autograd through the pairwise oracle."""
    js, ts, h, g, th = case
    vals_j = js.build_values_pairs(jnp.asarray(h), jnp.asarray(g))
    T_j = js.device_tables()
    v_j = js.state(jnp.asarray(th), tables=T_j)

    def e_j(t, d, s, dd):
        return js.quadform_values(js.state(t, tables=T_j), (d, s, dd),
                                  tables=T_j)

    E_j, G_j = jax.value_and_grad(e_j, argnums=(0, 1, 2, 3))(
        jnp.asarray(th), *vals_j)
    gv_j = jax.grad(lambda v: js.quadform_values(v, vals_j, tables=T_j))(
        v_j)
    vals = [_t(a).requires_grad_(True) for a in vals_j]
    x = _t(th).requires_grad_(True)
    E = ts.quadform_values(ts.state_matrix(x), tuple(vals))
    G = torch.autograd.grad(E, [x] + vals)
    assert_close(E, E_j)
    for a, b in zip(G, G_j):
        assert_close(a, b)
    v = _t(v_j).requires_grad_(True)
    (gv,) = torch.autograd.grad(ts.quadform_values(v, tuple(_t(a) for a in
                                                            vals_j)), v)
    assert_close(gv, gv_j)
    x2 = _t(th).requires_grad_(True)
    vals2 = [_t(a).requires_grad_(True) for a in vals_j]
    E2 = ts._quadform_pairs(ts.state(x2), tuple(vals2))
    G2 = torch.autograd.grad(E2, [x2] + vals2)
    assert_close(E, E2.detach().numpy())
    for a, b in zip(G, G2):
        assert_close(a, b.numpy())
    # a (k, nd + 1) stack gives k values
    stack = torch.stack([v.detach(), 0.5 * v.detach()])
    assert_close(ts.quadform_values(stack, tuple(_t(a) for a in vals_j)),
                 [float(E_j), 0.25 * float(E_j)])


def test_rdms(case):
    js, ts, _, _, th = case
    v_j = js.state(jnp.asarray(th))
    for a, b in zip(ts.rdms(_t(v_j)), js.rdms(v_j)):
        assert_close(a, b)


def test_kernel_choice_auto_and_override(monkeypatch):
    """'auto' falls back to the pairs where the string tables do not
    factorize (here the (1, 1) UCCSD's singles have empty domains in the
    (2, 0) sector), as in the JAX package; ESOO_SECTOR_KERNEL overrides
    the constructor's kernel."""
    ans, jans = T.UCCSD(2, (1, 1)), JUCCSD(2, (1, 1))
    ts = tsector.SectorUCC(ans, 4, num_particles=(2, 0))
    js = jsector.SectorUCC(jans, 4, num_particles=(2, 0))
    assert ts.kernel == js.kernel == "pairs"
    with pytest.raises(ValueError, match="empty domain"):
        tsector.SectorUCC(ans, 4, num_particles=(2, 0), kernel="strings")
    hf = T.UCCSD(2, (1, 1), initial_state=T.HartreeFock(2, (1, 1)))
    assert tsector.SectorUCC(hf, 4).kernel == "strings"
    monkeypatch.setenv("ESOO_SECTOR_KERNEL", "pairs")
    assert tsector.SectorUCC(hf, 4).kernel == "pairs"
    assert tsector.SectorUCC(hf, 4, kernel="strings").kernel == "pairs"
    monkeypatch.setenv("ESOO_SECTOR_KERNEL", "bogus")
    with pytest.raises(ValueError, match="kernel must be"):
        tsector.SectorUCC(hf, 4)


def test_pairs_refusals(case):
    _, ts, *_ = case
    with pytest.raises(ValueError, match="int8"):
        ts.device_tables(torch.float64, device="cpu", storage="int8")
    v = torch.zeros(ts.dim + 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="string kernel"):
        ts.transition_rdm1(v, v)


def test_slater_condon_disk_cache(tmp_path, monkeypatch):
    """Past the threshold the structure is cached under the JAX package's
    file name: a miss writes it (atomically), a second call and the JAX
    package read it back, and both equal a fresh scan."""
    monkeypatch.setenv("ESOO_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tsector, "_SC_CACHE_MIN_ND", 0)
    monkeypatch.setattr(jsector, "_SC_CACHE_MIN_ND", 0)
    dets = [int(d) for d in tci.enumerate_determinants(6, (2, 1), 3)]
    direct = tci.slater_condon_structure(dets, 6)
    first = tsector._slater_condon_structure_cached(dets, 6)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("sector_sc_n6_nd")
    assert files[0].endswith(".npz")

    def no_scan(*a):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(tsector, "slater_condon_structure", no_scan)
    monkeypatch.setattr(jsector, "slater_condon_structure", no_scan)
    second = tsector._slater_condon_structure_cached(dets, 6)
    from_jax = jsector._slater_condon_structure_cached(dets, 6)
    for got in (first, second, from_jax):
        assert set(got) == set(direct)
        for k in direct:
            np.testing.assert_array_equal(np.asarray(got[k]), direct[k],
                                          err_msg=k)


# -- end to end ----------------------------------------------------------------

def _port_problem(jax_problem):
    return problem_from_numpy(dataclasses.asdict(jax_problem))


def test_fused_vqe_pairs_env_matches_jax(h2_631g, monkeypatch):
    monkeypatch.setenv("ESOO_SECTOR_KERNEL", "pairs")
    solver = T.FusedOptOrbVQE(4, T.UCCSD(2, (1, 1), initial_state=
                                         T.HartreeFock(2, (1, 1))),
                              problem=_port_problem(h2_631g), device="cpu")
    assert solver._sector.kernel == "pairs"
    r = solver.compute_minimum_energy()
    jsolver = JVQE(4, JUCCSD(2, (1, 1), initial_state=JHF(2, (1, 1))),
                   problem=h2_631g)
    assert jsolver._sector.kernel == "pairs"
    ref = jsolver.compute_minimum_energy()
    assert abs(r.eigenvalue - ref.eigenvalue) <= 1e-9
    assert r.outer_iterations == ref.outer_iterations
    np.testing.assert_allclose(r.natural_occupations,
                               ref.natural_occupations, rtol=0, atol=1e-9)
    assert abs(r.spin_squared - ref.spin_squared) <= 1e-9


def test_fused_ssvqe_pairs_env_matches_jax(h2_631g, monkeypatch):
    monkeypatch.setenv("ESOO_SECTOR_KERNEL", "pairs")
    solver = T.FusedOptOrbSSVQE(
        4, T.UCCSD(2, (1, 1), reps=2),
        initial_states=[T.HartreeFock(2, (1, 1)),
                        T.OccupationState(4, 0b0110)],
        weight_vector=[2, 1], problem=_port_problem(h2_631g), device="cpu")
    assert solver._sector.kernel == "pairs"
    r = solver.compute_energies()
    s1 = JQC(4)
    s1.x(1)
    s1.x(2)
    jsolver = JSSVQE(4, JUCCSD(2, (1, 1), reps=2),
                     initial_states=[JHF(2, (1, 1)), s1],
                     weight_vector=[2, 1], problem=h2_631g)
    assert jsolver._sector.kernel == "pairs"
    ref = jsolver.compute_energies()
    np.testing.assert_allclose(r.eigenvalues, ref.eigenvalues, rtol=0,
                               atol=1e-9)
    # transition RDMs and per-state diagnostics need the string kernel
    assert r.transition_rdm1_spatial is None is ref.transition_rdm1_spatial
    assert r.natural_occupations is None is ref.natural_occupations


def _family(name, problem):
    hf = T.HartreeFock(2, (1, 1))
    inits = [hf, T.OccupationState(4, 0b0110)]
    kw = dict(problem=problem, device="cpu")
    if name == "vqe":
        return T.FusedOptOrbVQE(4, T.UCCSD(2, (1, 1), initial_state=hf),
                                **kw)
    if name == "ssvqe":
        return T.FusedOptOrbSSVQE(4, T.UCCSD(2, (1, 1), reps=2),
                                  initial_states=inits, **kw)
    if name == "mcvqe":
        return T.FusedOptOrbMCVQE(4, T.UCCSD(2, (1, 1)),
                                  num_particles=(1, 1), k=2, **kw)
    if name == "vqd":
        return T.FusedOptOrbVQD(4, T.UCCSD(2, (1, 1), reps=2),
                                initial_states=inits, **kw)
    return T.FusedOptOrbAdaptVQE(4, T.UCCSD(2, (1, 1), initial_state=hf),
                                 **kw)


@pytest.mark.parametrize("name", ["vqe", "ssvqe", "mcvqe", "vqd", "adapt"])
def test_fused_family_pairs_matches_strings(h2_631g, monkeypatch, name):
    problem = _port_problem(h2_631g)

    def run():
        s = _family(name, problem)
        if name in ("vqe", "adapt"):
            return s._sector.kernel, s.compute_minimum_energy().eigenvalue
        return s._sector.kernel, s.compute_energies().eigenvalues

    k_s, e_s = run()
    monkeypatch.setenv("ESOO_SECTOR_KERNEL", "pairs")
    k_p, e_p = run()
    assert (k_s, k_p) == ("strings", "pairs")
    np.testing.assert_allclose(e_p, e_s, rtol=0, atol=1e-9)


@pytest.mark.parametrize("system", ["h3_631g_doublet", "h4_631g_8"])
def test_vqe_pairs_matches_strings_past_h2(h4_631g, monkeypatch, system):
    if system == "h3_631g_doublet":
        problem = TC.MoleculeDriver(H3_GEOM, basis="6-31g", spin=1).run()
        n, parts = 3, (2, 1)
    else:
        problem, n, parts = _port_problem(h4_631g), 4, (2, 2)

    def run():
        s = T.FusedOptOrbVQE(2 * n, T.UCCSD(n, parts, initial_state=
                                            T.HartreeFock(n, parts)),
                             problem=problem, device="cpu")
        return s._sector.kernel, s.compute_minimum_energy()

    k_s, r_s = run()
    monkeypatch.setenv("ESOO_SECTOR_KERNEL", "pairs")
    k_p, r_p = run()
    assert (k_s, k_p) == ("strings", "pairs")
    assert abs(r_p.eigenvalue - r_s.eigenvalue) <= 1e-9
    # occupations are first order in the converged theta's error (L-BFGS
    # stops at gtol 1e-9), the energy second order: 4e-9 apart at H4
    np.testing.assert_allclose(r_p.natural_occupations,
                               r_s.natural_occupations, rtol=0, atol=1e-7)


def test_class_optorbvqe_pairs_matches_strings_and_jax(h2_631g,
                                                        monkeypatch):
    """The class-based OptOrbVQE measures its RDMs and energies in the
    sector (solvers/energy.py::_sector_for), which the override puts on
    the pairs kernel."""
    import esoo_tpu.orbital_optimization as JO
    import esoo_tpu.sim as JS
    import esoo_tpu.solvers as JV

    def solve(S, V, O, problem, dk):
        ans = S.UCCSD(2, (1, 1), initial_state=S.HartreeFock(2, (1, 1)))
        vqe = V.VQE(S.Estimator(**dk), ans, V.L_BFGS_B(),
                    initial_point=np.zeros(ans.num_parameters), **dk)
        pupo = O.PartialUnitaryProjectionOptimizer(1e-3, 1e-5, 10000, **dk)
        return O.OptOrbVQE(num_spin_orbitals=4, ground_state_solver=vqe,
                           partial_unitary_optimizer=pupo, problem=problem,
                           maxiter=20, **dk).compute_minimum_energy()

    tp = _port_problem(h2_631g)
    cpu = {"device": "cpu"}
    strings = solve(T, T, T, tp, cpu)
    monkeypatch.setenv("ESOO_SECTOR_KERNEL", "pairs")
    from esoo_torch.solvers.energy import _sector_for
    ans = T.UCCSD(2, (1, 1), initial_state=T.HartreeFock(2, (1, 1)))
    assert _sector_for(ans).kernel == "pairs"
    pairs = solve(T, T, T, tp, cpu)
    ref = solve(JS, JV, JO, h2_631g, {})
    assert abs(pairs.eigenvalue - strings.eigenvalue) <= 1e-9
    assert abs(pairs.eigenvalue - ref.eigenvalue) <= 1e-9
