"""esoo_torch's compact int8 string kernels (sim/strings.py: compact_tables,
_sigma_compact, _rdms_compact, _diagonal_compact, the compact branches of
build_ops and transition_rdm1), the compact and int8 table storages of
SectorCI and SectorUCC, and FusedOptOrbCASSCF(table_storage='compact'),
against esoo_tpu's compact kernels and the port's dense ones.  Float64 on
the CPU, inputs made with numpy from a seed.

Tolerances: 1e-12 of max(1, max|ref|) for single kernel evaluations (the
chunked and dense kernels sum in different orders); 1e-8 for CASSCF
energies, orbitals and natural occupations (an outer loop of Davidson and
BB steps, each stopping at its own tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.orbital_optimization import (
    FusedOptOrbCASSCF as JCASSCF, FusedOptOrbSACASSCF as JSACASSCF)
from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD
from esoo_tpu.sim import strings as JS
from esoo_tpu.sim.sector import SectorCI as JSectorCI, SectorUCC as JSector
from esoo_torch import (FusedOptOrbCASSCF, FusedOptOrbSACASSCF, HartreeFock,
                        SectorCI, UCCSD)
from esoo_torch.orbital_optimization import casscf as TC
from esoo_torch.sim import strings as TS
from esoo_torch.sim.sector import SectorUCC
from test_torch_engine import same_eri_engine  # noqa: F401

jax.config.update("jax_enable_x64", True)

# (n, parts): the operator axis q = n^2 pads to a multiple of 32 (16 ->
# 32, 36 -> 64 over two chunks) except at n = 8 (q = 64, two full chunks)
CASES = [(4, (2, 2)), (6, (3, 3)), (4, (3, 2)), (8, (2, 2))]


def assert_close(out, ref, rtol=1e-12):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale)


def _random_tensors(N, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, N))
    g0 = rng.normal(size=(N,) * 4)
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    return (h + h.T) / 2, g


@pytest.fixture(scope="module", params=CASES, ids=str)
def case(request):
    """The port's dense and compact tables and operators, the JAX
    package's compact ones, and one seeded unit vector."""
    n, parts = request.param
    N = 2 * n
    h, g = _random_tensors(N, seed=7 * n + parts[0])
    ts, js = SectorCI(N, parts), JSectorCI(N, parts)
    dense = ts.device_tables(torch.float64, device="cpu")
    comp = ts.device_tables(torch.float64, device="cpu", storage="compact")
    jcomp = js.device_tables(np.float64, storage="compact")
    th, tg = torch.as_tensor(h), torch.as_tensor(g)
    V = np.random.default_rng(5).normal(size=(ts.nB, ts.nA))
    V /= np.linalg.norm(V)
    return dict(n=n, ts=ts, js=js, dense=dense, comp=comp, jcomp=jcomp,
                ops_d=TS.build_ops(th, tg, dense),
                ops_c=TS.build_ops(th, tg, comp),
                ops_j=JS.build_ops(jnp.asarray(h), jnp.asarray(g), jcomp),
                V=V, tV=torch.as_tensor(V))


def test_compact_tables_match_jax(case):
    comp, jcomp = case["comp"], case["jcomp"]
    assert set(comp) == set(jcomp) == {"MA8", "MB8", "LIN_A", "LIN_B",
                                       "CROSS"}
    n = case["n"]
    q_pad = comp["MA8"].shape[0]
    assert q_pad % TS._OP_CHUNK == 0 and q_pad - n * n < TS._OP_CHUNK
    for k in comp:
        np.testing.assert_array_equal(comp[k].numpy(), np.asarray(jcomp[k]),
                                      err_msg=k)
    assert comp["MA8"].dtype == torch.int8
    # the padded operators are zero
    assert not comp["MA8"][n * n:].any() and not comp["MB8"][n * n:].any()


def test_compact_build_ops_match_jax_and_dense(case):
    ops_c, ops_d, ops_j = case["ops_c"], case["ops_d"], case["ops_j"]
    for k in ("G2", "FA", "FB"):
        assert_close(ops_c[k], ops_j[k])
    assert_close(ops_c["FA"], ops_d["FA"])
    assert_close(ops_c["FB"], ops_d["FB"])
    # G2 is the dense coupling embedded at the padded block offsets
    P, q = ops_d["G2"].shape[0] // 2, case["comp"]["MA8"].shape[0]
    for r in (0, 1):
        for c in (0, 1):
            np.testing.assert_array_equal(
                ops_c["G2"][r * q:r * q + P, c * q:c * q + P].numpy(),
                ops_d["G2"][r * P:(r + 1) * P, c * P:(c + 1) * P].numpy())
    assert float(ops_c["G2"].abs().sum()) == pytest.approx(
        float(ops_d["G2"].abs().sum()), rel=1e-14)


def test_compact_sigma_and_quadform_match_jax_and_dense(case):
    tV, ops_c, comp = case["tV"], case["ops_c"], case["comp"]
    out = TS.sigma(tV, ops_c, comp)
    assert_close(out, JS.sigma(jnp.asarray(case["V"]), case["ops_j"],
                               case["jcomp"]))
    assert_close(out, TS.sigma(tV, case["ops_d"], case["dense"]))
    assert_close(TS.quadform(tV, ops_c, comp),
                 TS.quadform(tV, case["ops_d"], case["dense"]))


def test_compact_diagonal_matches_jax_and_dense(case):
    out = TS.diagonal(case["ops_c"], case["comp"])
    assert_close(out, JS.diagonal(case["ops_j"], case["jcomp"]))
    assert_close(out, TS.diagonal(case["ops_d"], case["dense"]))


def test_compact_rdms_match_jax_and_dense(case):
    n, ts, comp = case["n"], case["ts"], case["comp"]
    q_pad = comp["MA8"].shape[0]
    out = TS.rdms(case["tV"], comp, TS.build_rdm_maps(n, q_pad=q_pad))
    ref = JS.rdms(jnp.asarray(case["V"]), case["jcomp"],
                  JS.build_rdm_maps(n, q_pad=q_pad))
    dense = ts.rdms(case["tV"])
    for o, r, d in zip(out, ref, dense):
        assert_close(o, r)
        assert_close(o, d)
    # SectorCI.rdms builds the maps for the tables' padded operator axis
    for o, d in zip(ts.rdms(case["tV"], comp), dense):
        assert_close(o, d)


@pytest.mark.parametrize("batched", [False, True])
def test_compact_transition_rdm1_matches_jax_and_dense(case, batched):
    ts, comp = case["ts"], case["comp"]
    rng = np.random.default_rng(11)
    U = rng.normal(size=(3, ts.nB, ts.nA) if batched else (ts.nB, ts.nA))
    out = ts.transition_rdm1(torch.as_tensor(U), case["tV"], comp)
    assert_close(out, JS.transition_rdm1(jnp.asarray(U),
                                         jnp.asarray(case["V"]),
                                         case["jcomp"]))
    assert_close(out, ts.transition_rdm1(torch.as_tensor(U), case["tV"]))
    assert out.shape == ((3,) if batched else ()) + (2 * case["n"],) * 2


def test_int8_storage_runs_the_dense_kernels():
    """storage='int8' keeps the stacks int8 under the dense keys: the
    dense kernels cast them, so every number equals the dense storage's
    exactly, for SectorCI and for SectorUCC, and the tables equal the JAX
    package's int8 tables."""
    n, parts = 4, (2, 2)
    N = 2 * n
    h, g = (torch.as_tensor(a) for a in _random_tensors(N, seed=3))
    ts = SectorCI(N, parts)
    i8 = ts.device_tables(torch.float64, device="cpu", storage="int8")
    dense = ts.device_tables(torch.float64, device="cpu")
    assert i8["MA"].dtype == torch.int8 and "MA8" not in i8
    V = torch.as_tensor(np.random.default_rng(4).normal(size=(ts.nB, ts.nA)))
    ops_i, ops_d = TS.build_ops(h, g, i8), TS.build_ops(h, g, dense)
    assert torch.equal(TS.sigma(V, ops_i, i8), TS.sigma(V, ops_d, dense))
    assert torch.equal(TS.diagonal(ops_i, i8), TS.diagonal(ops_d, dense))
    for a, b in zip(ts.rdms(V, i8), ts.rdms(V, dense)):
        assert torch.equal(a, b)

    ansatz = UCCSD(n, parts, initial_state=HartreeFock(n, parts))
    sec = SectorUCC(ansatz, N)
    jsec = JSector(JUCCSD(n, parts, initial_state=JHF(n, parts)), N)
    ui8 = sec.device_tables(torch.float64, device="cpu", storage="int8")
    ud = sec.device_tables(torch.float64, device="cpu")
    ji8 = jsec.device_tables(np.float64, storage="int8")
    for k in ("MA", "MB"):
        assert ui8[k].dtype == torch.int8
        np.testing.assert_array_equal(ui8[k].numpy(), np.asarray(ji8[k]))
    assert sec.device_tables(torch.float64, device="cpu",
                             storage="int8") is ui8              # cached
    theta = torch.as_tensor(np.random.default_rng(6).normal(
        size=ansatz.num_parameters) * 0.3)
    vals_i = sec.build_values(h, g, ui8)
    assert torch.equal(sec.energy_values(theta, vals_i, ui8),
                       sec.energy_values(theta, sec.build_values(h, g, ud),
                                         ud))
    with pytest.raises(ValueError, match="storage"):
        sec.device_tables(torch.float64, device="cpu", storage="compact")


# -- FusedOptOrbCASSCF(table_storage='compact') ------------------------------

def test_casscf_compact_h4_matches_jax_and_dense(h4_631g):
    """H4 6-31G -> 8 (tests/test_casscf.py:242): compact storage equals
    the JAX package's compact run and the port's dense run."""
    ref = JCASSCF(8, problem=h4_631g, maxiter=8,
                  table_storage="compact").compute_minimum_energy()
    comp = FusedOptOrbCASSCF(8, problem=h4_631g, maxiter=8, device="cpu",
                             table_storage="compact")
    assert comp.table_storage == "compact"
    r = comp.compute_minimum_energy()
    dense = FusedOptOrbCASSCF(8, problem=h4_631g, maxiter=8, device="cpu",
                              table_storage="dense").compute_minimum_energy()
    for other in (ref, dense):
        assert abs(r.eigenvalue - other.eigenvalue) <= 1e-8
        assert r.outer_iterations == other.outer_iterations
        np.testing.assert_allclose(r.optimal_partial_unitary,
                                   other.optimal_partial_unitary, rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(r.natural_occupations,
                                   other.natural_occupations, rtol=0,
                                   atol=1e-8)


def test_casscf_compact_two_dispatch_and_sa_match_jax(h2_631g):
    """H2 6-31G -> 4 (tests/test_casscf.py:262): compact storage through
    dispatch='two' and the state-averaged block-Davidson variant."""
    one = FusedOptOrbCASSCF(4, problem=h2_631g, maxiter=10, device="cpu",
                            table_storage="compact").compute_minimum_energy()
    two = FusedOptOrbCASSCF(4, problem=h2_631g, maxiter=10, device="cpu",
                            dispatch="two", table_storage="compact"
                            ).compute_minimum_energy()
    ref = JCASSCF(4, problem=h2_631g, maxiter=10, dispatch="two",
                  table_storage="compact").compute_minimum_energy()
    assert two.eigenvalue == one.eigenvalue
    assert abs(two.eigenvalue - ref.eigenvalue) <= 1e-8

    sa = FusedOptOrbSACASSCF(4, problem=h2_631g, k=2, maxiter=8,
                             device="cpu",
                             table_storage="compact").compute_energies()
    jsa = JSACASSCF(4, problem=h2_631g, k=2, maxiter=8,
                    table_storage="compact").compute_energies()
    np.testing.assert_allclose(sa.eigenvalues, jsa.eigenvalues, rtol=0,
                               atol=1e-8)
    for k in ("natural_occupations", "transition_rdm1_spatial"):
        np.testing.assert_allclose(getattr(sa, k), getattr(jsa, k), rtol=0,
                                   atol=1e-8, err_msg=k)


def test_auto_storage_resolves_to_compact_past_the_threshold(h2_631g,
                                                             monkeypatch):
    """'auto' takes the compact tables when nd > _COMPACT_MIN_ND (1.1M, as
    in the JAX package): H2 -> 4 has nd = 4, so a threshold of 3 gives
    compact and one of 4 gives dense; both give the same energy."""
    assert TC._COMPACT_MIN_ND == 1_100_000
    energies = {}
    for threshold, storage in ((4, "dense"), (3, "compact")):
        monkeypatch.setattr(TC, "_COMPACT_MIN_ND", threshold)
        solver = FusedOptOrbCASSCF(4, problem=h2_631g, maxiter=10,
                                   device="cpu")
        assert solver.table_storage == storage
        assert ("MA8" in solver._sector_tables) == (storage == "compact")
        energies[storage] = solver.compute_minimum_energy().eigenvalue
    assert abs(energies["compact"] - energies["dense"]) <= 1e-10
