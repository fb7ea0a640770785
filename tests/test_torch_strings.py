"""esoo_torch string-sector kernels against esoo_tpu (sim/strings.py,
sim/sector.py) on H2 6-31G -> 4 and a random N=8, (2, 2) sector: host
tables identical, device kernels at float64 to 1e-12 of max(1, max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.initializations.ci import enumerate_determinants as jax_dets
from esoo_tpu.orbital_optimization.kernels import expand_spin_tensors
from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD
from esoo_tpu.sim import ansatz as JA
from esoo_tpu.sim import strings as JS
from esoo_tpu.sim.sector import SectorUCC as JSector
from esoo_torch.convert import string_tables_from_numpy
from esoo_torch.initializations.ci import enumerate_determinants
from esoo_torch.sim import HartreeFock, UCCSD, ansatz as TA
from esoo_torch.ops import ParityMapper
from esoo_torch.sim import strings as TS
from esoo_torch.sim.sector import SectorUCC
from test_torch_engine import same_eri_engine  # noqa: F401

jax.config.update("jax_enable_x64", True)

CASES = {"h2_631g": (2, (1, 1)), "random_n8": (4, (2, 2))}


def assert_close(out, ref, rtol=1e-12):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _sectors(case):
    n, parts = CASES[case]
    js = JSector(JUCCSD(n, parts, initial_state=JHF(n, parts)), 2 * n)
    ts = SectorUCC(UCCSD(n, parts, initial_state=HartreeFock(n, parts)),
                   2 * n)
    return js, ts


def _integrals(case, h2_631g):
    """Spin-orbital (h, g): the H2 6-31G molecular tensors over the two
    lowest MOs, or random ones with the physicist symmetries of the
    package's ingestion."""
    n = CASES[case][0]
    if case == "h2_631g":
        h, g = h2_631g.spatial_integral_tensors()
        h, g = expand_spin_tensors(jnp.asarray(h[:n, :n]),
                                   jnp.asarray(g[:n, :n, :n, :n]))
        return np.asarray(h), np.asarray(g)
    N = 2 * n
    rng = np.random.default_rng(0)
    h = rng.normal(size=(N, N))
    g0 = rng.normal(size=(N,) * 4)
    return ((h + h.T) / 2, g0 + g0.transpose(1, 0, 3, 2)
            + g0.transpose(2, 3, 0, 1) + g0.transpose(3, 2, 1, 0))


def _apply_gates_plain(V0, theta, tabs):
    """Plain gate scan, differentiated by autograd (the oracle for the
    reversible backward of `apply_gates`)."""
    M, S, flat = TS.gate_fields(tabs)
    c, s = torch.cos(theta), torch.sin(theta)
    V = V0
    for k in range(theta.shape[0]):
        V = TS._gate_step_str(V, flat[k], M[k], S[k], c[k], s[k])
    return V


def _state(ts, seed):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(ts.nB, ts.nA))
    return V / np.linalg.norm(V)


@pytest.mark.parametrize("case", CASES)
def test_host_tables_identical(case):
    js, ts = _sectors(case)
    n, parts = CASES[case]
    assert ts.dim == js.dim and ts.init_index == js.init_index
    np.testing.assert_array_equal(ts.dets, js.dets)
    assert enumerate_determinants(2 * n, parts, sum(parts)) == \
        jax_dets(2 * n, parts, sum(parts))
    assert TA.generate_excitations(n, parts) == \
        JA.generate_excitations(n, parts)
    assert TA.hartree_fock_bitmask(n, parts) == \
        JA.hartree_fock_bitmask(n, parts)
    jt, tt = js._str_tabs._asdict(), ts._str_tabs._asdict()
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    for a, b in zip(TS.build_rdm_maps(n), JS.build_rdm_maps(n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_apply_gates_forward(case):
    js, ts = _sectors(case)
    rng = np.random.default_rng(3)
    th = rng.normal(size=len(ts._excs)) * 0.4
    V0 = _state(ts, 4)
    ref = JS.apply_gates(jnp.asarray(V0), jnp.asarray(th),
                         js._str_tabs._asdict())
    tabs = ts.device_tables(torch.float64, device="cpu")
    assert_close(TS.apply_gates(_t(V0), _t(th), tabs), ref)
    assert_close(_apply_gates_plain(_t(V0), _t(th), tabs), ref)


@pytest.mark.parametrize("case", CASES)
def test_apply_gates_reversible_backward(case):
    """The reversible backward against the JAX package's reversible VJP and
    against torch autograd of the plain gate scan."""
    js, ts = _sectors(case)
    rng = np.random.default_rng(5)
    th = rng.normal(size=len(ts._excs)) * 0.4
    V0, ct = _state(ts, 6), rng.normal(size=(ts.nB, ts.nA))
    jt = js._str_tabs._asdict()
    _, vjp = jax.vjp(lambda v, t: JS.apply_gates(v, t, jt),
                     jnp.asarray(V0), jnp.asarray(th))
    dV_ref, dth_ref = vjp(jnp.asarray(ct))
    tabs = ts.device_tables(torch.float64, device="cpu")
    grads = []
    for fn in (TS.apply_gates, _apply_gates_plain):
        v, t = _t(V0).requires_grad_(), _t(th).requires_grad_()
        torch.autograd.backward(fn(v, t, tabs), _t(ct))
        grads.append((v.grad, t.grad))
    for dV, dth in grads:
        assert_close(dV, dV_ref)
        assert_close(dth, dth_ref)


@pytest.mark.parametrize("case", CASES)
def test_build_ops_sigma_quadform(case, h2_631g):
    js, ts = _sectors(case)
    h, g = _integrals(case, h2_631g)
    jt = js._str_tabs._asdict()
    tabs = ts.device_tables(torch.float64, device="cpu")
    ops_ref = JS.build_ops(jnp.asarray(h), jnp.asarray(g), jt)
    ops = TS.build_ops(_t(h), _t(g), tabs)
    for k in ("G2", "FA", "FB"):
        assert_close(ops[k], ops_ref[k])
    V = _state(ts, 7)
    assert_close(TS.sigma(_t(V), ops, tabs),
                 JS.sigma(jnp.asarray(V), ops_ref, jt))
    E_ref, dV_ref = jax.value_and_grad(JS.quadform)(jnp.asarray(V),
                                                    ops_ref, jt)
    v = _t(V).requires_grad_()
    E = TS.quadform(v, ops, tabs)
    E.backward()
    assert_close(E.detach(), E_ref)
    assert_close(v.grad, dV_ref)


@pytest.mark.parametrize("case", CASES)
def test_rdms(case):
    js, ts = _sectors(case)
    V = _state(ts, 8)
    n = CASES[case][0]
    ref = JS.rdms(jnp.asarray(V), js._str_tabs._asdict(),
                  JS.build_rdm_maps(n))
    out = TS.rdms(_t(V), ts.device_tables(torch.float64, device="cpu"),
                  TS.build_rdm_maps(n))
    for a, b in zip(out, ref):
        assert_close(a, b)
    for a, b in zip(ts.rdms(_t(V).reshape(-1)),
                    js.rdms(jnp.asarray(np.append(V.reshape(-1), 0.0)))):
        assert_close(a, b)


@pytest.mark.parametrize("case", CASES)
def test_sector_energy_value_and_grad(case, h2_631g):
    """SectorUCC.energy_values (the L-BFGS cost) and its theta gradient."""
    js, ts = _sectors(case)
    h, g = _integrals(case, h2_631g)
    th = np.random.default_rng(9).normal(size=len(ts._excs)) * 0.3
    vals_ref = js.build_values(jnp.asarray(h), jnp.asarray(g))
    E_ref, G_ref = jax.value_and_grad(js.energy_values)(jnp.asarray(th),
                                                        vals_ref)
    vals = ts.build_values(_t(h), _t(g))
    t = _t(th).requires_grad_()
    E = ts.energy_values(t, vals)
    E.backward()
    assert_close(E.detach(), E_ref)
    assert_close(t.grad, G_ref)
    assert_close(ts.state(_t(th)), js.state(jnp.asarray(th)))


@pytest.mark.parametrize("case", CASES)
def test_kernels_run_on_tables_carried_from_jax(case, h2_631g):
    """convert.string_tables_from_numpy of the JAX sector's tables drives
    the port's kernels to the same numbers as the port's own tables."""
    js, ts = _sectors(case)
    carried = string_tables_from_numpy(js._str_tabs._asdict(),
                                       dtype=torch.float64, device="cpu")
    own = ts.device_tables(torch.float64, device="cpu")
    h, g = _integrals(case, h2_631g)
    th = _t(np.random.default_rng(10).normal(size=len(ts._excs)) * 0.3)
    V0 = torch.zeros(ts.nB, ts.nA, dtype=torch.float64)
    V0.view(-1)[ts.init_index] = 1.0
    for tabs in (carried, own):
        V = TS.apply_gates(V0, th, tabs)
        E = TS.quadform(V, TS.build_ops(_t(h), _t(g), tabs), tabs)
        assert_close(E, ts.energy_values(th, ts.build_values(_t(h), _t(g))))


def test_sector_rejects_what_is_not_ported():
    ansatz = UCCSD(2, (1, 1), initial_state=HartreeFock(2, (1, 1)))
    # the pairwise gather kernels are ported: kernel='pairs' builds them
    pairs = SectorUCC(ansatz, 4, kernel="pairs")
    assert pairs.kernel == "pairs" and pairs.state_shape == (pairs.dim + 1,)
    with pytest.raises(ValueError):
        SectorUCC(object(), 4)
    # a parity-mapped circuit is built, and the sector refuses it (its
    # amplitudes are not in the occupation basis)
    parity = UCCSD(2, (1, 1), qubit_mapper=ParityMapper(),
                   initial_state=HartreeFock(2, (1, 1),
                                             qubit_mapper=ParityMapper()))
    assert parity._encoding == "paritymapper"
    with pytest.raises(ValueError, match="Jordan-Wigner"):
        SectorUCC(parity, 4)
