"""SectorCI's sigma through single-excitation lists (sim/strings.py
one_body_lists, build_list_ops and sigma_lists over ops/sigma_lists.py's
plain gathers) against the port's dense string kernels and the JAX
package's, float64 on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the lists exactly (they are read off the int8 stacks); 1e-12
of max(1, max|ref|) for sigma, the one-side matrices and the cross
coupling (the same sums, taken in another order); 1e-10 Ha for a CASSCF
energy on the lists against the dense path (three outer iterations of
Davidson at tol 1e-9 and BB, started alike)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.sim import strings as JS
from esoo_tpu.sim.sector import SectorCI as JSectorCI
from esoo_torch import FusedOptOrbCASSCF, SectorCI
from esoo_torch.ops import sigma_lists as SL
from esoo_torch.sim import strings as TS
from esoo_torch.utils.profiling import collect
from test_torch_engine import same_eri_engine  # noqa: F401

jax.config.update("jax_enable_x64", True)

SECTORS = [(4, (2, 2)), (6, (3, 2)), (6, (3, 3)), (8, (4, 4))]


def assert_close(out, ref, rtol=1e-12):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale)


def _random_tensors(N, seed):
    """Spin-orbital (h, g) with the index symmetries of chemistry
    tensors."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, N))
    g0 = rng.normal(size=(N,) * 4)
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    return (h + h.T) / 2, g


@pytest.fixture(scope="module", params=SECTORS, ids=str)
def case(request):
    """(sector, its dense tables, h, g, the dense operators, the list
    operators) on random integrals."""
    n, parts = request.param
    h, g = _random_tensors(2 * n, seed=10 * n + sum(parts))
    sec = SectorCI(2 * n, parts)
    tabs = sec.device_tables(torch.float64, device="cpu")
    ht, gt = torch.as_tensor(h), torch.as_tensor(g)
    return (sec, tabs, h, g, TS.build_ops(ht, gt, tabs),
            sec.build_values(ht, gt))


def test_lists_rebuild_the_int8_stacks(case):
    sec, tabs, *_ = case
    i8 = sec.device_tables(torch.float64, device="cpu", storage="int8")
    for spin in "AB":
        M = np.asarray(getattr(sec._str_tabs, "M" + spin))
        src, sgn = tabs["SRC_" + spin], tabs["SGN_" + spin]
        assert src.dtype == torch.int32 and sgn.dtype == torch.int8
        assert torch.equal(i8["SRC_" + spin], src)
        assert torch.equal(i8["SGN_" + spin], sgn)
        src, sgn = src.numpy(), sgn.numpy()
        assert np.array_equal(sgn == 0, src < 0)
        rebuilt = np.zeros_like(M)
        q, j = np.nonzero(src >= 0)
        rebuilt[q, j, src[q, j]] = sgn[q, j]
        np.testing.assert_array_equal(rebuilt, M, err_msg=spin)


def test_one_side_matrices_and_cross_coupling(case):
    """HA, HB and GX against dense products by the stacks; V HA^T + HB V
    is the dense sigma with the cross-spin blocks of G2 zeroed."""
    sec, tabs, h, g, ops, lops = case
    for k in ("G2", "FA", "FB"):
        assert_close(lops[k], ops[k])
    q = tabs["MA"].shape[0]
    G2 = ops["G2"]
    for spin, blk in (("A", G2[:q, :q]), ("B", G2[q:, q:])):
        M = tabs["M" + spin]
        ref = ops["F" + spin] + torch.einsum("ab,aji,bik->jk", blk, M, M)
        assert_close(lops["H" + spin], ref)
    assert_close(lops["GX"], G2[q:, :q] + G2[:q, q:].T)
    same = dict(ops, G2=G2.clone())
    same["G2"][:q, q:] = 0.0
    same["G2"][q:, :q] = 0.0
    V = torch.as_tensor(np.random.default_rng(3).normal(
        size=(sec.nB, sec.nA)))
    assert_close(V @ lops["HA"].T + lops["HB"] @ V, TS.sigma(V, same, tabs))


def test_list_sigma_matches_dense_and_jax(case):
    """One state and a batch of two, against the port's dense sigma and
    esoo_tpu.sim.strings.sigma; each state counts one list matvec."""
    sec, tabs, h, g, ops, lops = case
    js = JSectorCI(sec.num_qubits, sec.num_particles)
    jt = js.device_tables()
    jv = js.build_values(jnp.asarray(h), jnp.asarray(g))
    rng = np.random.default_rng(sec.nA)
    V = rng.normal(size=(2, sec.nB, sec.nA))
    stats = {}
    with collect(stats):
        one = sec.sigma_values(torch.as_tensor(V[0]), lops)
        two = sec.sigma_values(torch.as_tensor(V), lops)
    assert stats == {"sigma_list_matvecs": 3}
    assert_close(one, TS.sigma(torch.as_tensor(V[0]), ops, tabs))
    assert_close(one, JS.sigma(jnp.asarray(V[0]), jv, jt))
    assert_close(two, TS.sigma(torch.as_tensor(V), ops, tabs))
    for x, ref in zip(two, V):
        assert_close(x, JS.sigma(jnp.asarray(ref), jv, jt))


@pytest.mark.parametrize("n, parts", SECTORS, ids=str)
def test_float32_list_sigma_as_accurate_as_dense(n, parts):
    """At float32 the list path keeps HA and HB in float64, applies them
    in float64 and sums the back-gather in float64: its sigma of two
    states, against float64 on the same float32 operators, errs no more
    than the dense float32 sigma."""
    h, g = _random_tensors(2 * n, seed=10 * n + sum(parts))
    sec = SectorCI(2 * n, parts)
    t32 = sec.device_tables(torch.float32, device="cpu")
    t64 = sec.device_tables(torch.float64, device="cpu")
    ht, gt = (torch.as_tensor(a).float() for a in (h, g))
    lops = sec.build_values(ht, gt, t32)
    assert lops["HA"].dtype == lops["HB"].dtype == torch.float64
    ops = TS.build_ops(ht, gt, t32)
    V = torch.as_tensor(np.random.default_rng(5).normal(
        size=(2, sec.nB, sec.nA)))
    ref = TS.sigma(V, {k: ops[k].double() for k in ("G2", "FA", "FB")},
                   t64)
    got = sec.sigma_values(V.float(), lops, t32)
    assert got.dtype == torch.float32

    def err(x):
        return float((x.double() - ref).abs().max())

    assert err(got) <= err(TS.sigma(V.float(), ops, t32))


def test_list_path_refuses_grad(case):
    """The list build and sigma compute values only; the dense quadform,
    which the VQE sectors differentiate, still takes gradients."""
    sec, tabs, h, g, ops, lops = case
    ht = torch.as_tensor(h).requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        sec.build_values(ht, torch.as_tensor(g))
    V = torch.as_tensor(np.ones((sec.nB, sec.nA))).requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        sec.sigma_values(V, lops)
    TS.quadform(V, ops, tabs).backward()
    assert V.grad is not None


def test_plain_gathers_term_by_term():
    """The plain gathers against loops over their terms, bit for bit: the
    back-gather adds in ascending q, the kernel's order."""
    rng = np.random.default_rng(5)
    q, K, ns, C = 5, 2, 4, 3
    src = torch.as_tensor(rng.integers(-1, ns, size=(q, ns)),
                          dtype=torch.int32)
    sgn = torch.as_tensor(np.where(src.numpy() >= 0,
                                   rng.choice([-1, 1], size=(q, ns)), 0),
                          dtype=torch.int8)
    Y = torch.as_tensor(rng.normal(size=(q, K, ns, C)))
    base = torch.as_tensor(rng.normal(size=(K, ns, C)))
    out = SL.beta_gather(Y, src, sgn, base)
    for k in range(K):
        for j in range(ns):
            acc = base[k, j].clone()
            for b in range(q):
                if src[b, j] >= 0:
                    acc = acc + float(sgn[b, j]) * Y[b, k, int(src[b, j])]
            assert torch.equal(out[k, j], acc)
    V = torch.as_tensor(rng.normal(size=(3, ns)))
    T = SL.alpha_gather(V, src, sgn)
    assert T.shape == (q, 3, ns)
    for b in range(q):
        for j in range(ns):
            want = (V[:, int(src[b, j])] * float(sgn[b, j])
                    if src[b, j] >= 0 else torch.zeros(3, dtype=V.dtype))
            assert torch.equal(T[b, :, j], want)


def test_casscf_on_lists_matches_the_dense_path(h4_631g, monkeypatch):
    """FusedOptOrbCASSCF on H4 6-31G -> 8 spin orbitals, three outer
    iterations: on the lists (every matvec counted; an alpha gather a
    matvec, a back-gather a matvec and two a Davidson build) and on the
    same tables without them (the dense sigma, none counted, no gather)."""
    calls = {"alpha": 0, "beta": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(SL, f"{name}_gather")):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(SL, f"{name}_gather", counted)

    def run(strip):
        calls.update(alpha=0, beta=0)
        solver = FusedOptOrbCASSCF(8, problem=h4_631g, maxiter=3,
                                   device="cpu")
        if strip:
            solver._sector_tables = {
                k: v for k, v in solver._sector_tables.items()
                if k not in TS.LIST_KEYS}
        return solver.compute_minimum_energy()

    lists = run(False)
    on_lists = dict(calls)
    dense = run(True)
    assert abs(lists.eigenvalue - dense.eigenvalue) <= 1e-10
    assert lists.outer_iterations == dense.outer_iterations
    st = lists.stage_stats
    assert st["sigma_list_matvecs"] == st["davidson_matvecs"] > 0
    assert on_lists == {"alpha": st["sigma_list_matvecs"],
                        "beta": st["sigma_list_matvecs"]
                        + 2 * st["davidson_solves"]}
    assert dense.stage_stats["sigma_list_matvecs"] == 0
    assert calls == {"alpha": 0, "beta": 0}
