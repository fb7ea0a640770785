"""The port's full-space simulator (esoo_torch/sim: circuit, ansatz,
statevector, rdm, estimator) against esoo_tpu/sim on the same seeded
inputs, at float64 on the CPU.

Circuits cross as plain gate data (`convert.circuit_from_gates`), so
arbitrary user circuits go through both simulators.  Tolerances:
statevectors, RDMs, energies, Estimator values, Sampler
probabilities and fidelities 1e-12; d rdm_energy / d theta 1e-10
against jax.grad; the per-gate sign tables equal."""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esoo_tpu.ops as JO
import esoo_tpu.sim as J
from esoo_tpu.ops import ActiveSpaceHamiltonianBuilder as JBuilder
from esoo_tpu.ops import SparsePauliOp as JPauli
from esoo_tpu.orbital_optimization.kernels import (
    expand_spin_tensors as jexpand)
from esoo_tpu.sim import rdm as JR
import esoo_torch.ops as TO
import esoo_torch.sim as T
from esoo_torch.convert import circuit_from_gates
from esoo_torch.ops import ActiveSpaceHamiltonianBuilder, SparsePauliOp
from esoo_torch.orbital_optimization.kernels import expand_spin_tensors
from esoo_torch.sim import rdm as TR
from esoo_torch.utils import precision_mode
from test_torch_engine import same_eri_engine  # noqa: F401

TV = importlib.import_module("esoo_torch.sim.statevector")
JV = sys.modules["esoo_tpu.sim.statevector"]

SV_TOL = 1e-12       # statevectors, RDMs, energies, primitives
GRAD_TOL = 1e-10     # d rdm_energy / d theta against jax.grad


def _mixed(lib):
    """A circuit of every 1q/2q gate kind, with constant and linear
    parameter angles (complex path)."""
    qc = lib.QuantumCircuit(4)
    a, b, c = qc.parameter(), qc.parameter(), qc.parameter()
    qc.x(0).h(1).y(2).z(3).s(0).sdg(1).t(2)
    qc.rx(a, 0).ry(b * 0.5 + 0.1, 1).rz(-c, 2).p(0.3, 3)
    qc.cx(0, 1).cz(1, 2).cy(2, 3).swap(0, 3)
    qc.crx(a, 1, 0).cry(b, 2, 1).crz(c * 2.0, 3, 2).cp(a + 0.2, 0, 2)
    qc.pauli_rot(b, 0b1011, 0b0110)
    return qc


def _circuits(lib):
    return {
        "uccsd": lib.UCCSD(3, (2, 1), initial_state=lib.HartreeFock(3, (2, 1)),
                           reps=4),
        "real_amplitudes": lib.RealAmplitudes(4),
        "efficient_su2": lib.EfficientSU2(4, reps=2),
        "mixed": _mixed(lib),
    }


NAMES = ["uccsd", "real_amplitudes", "efficient_su2", "mixed"]


def _pair(name):
    """(JAX circuit, the port's own build, the JAX circuit carried over)."""
    jc = _circuits(J)[name]
    return jc, _circuits(T)[name], circuit_from_gates(
        jc.num_qubits, jc.gates, jc.num_parameters,
        parameter_bounds=jc.parameter_bounds)


def _theta(n, seed=0, scale=1.0):
    return np.random.default_rng(seed).normal(size=n) * scale


def _tensors(n, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, n))
    h = (h + h.T) / 2
    g = rng.normal(size=(n, n, n, n)) * 0.1
    g = (g + g.transpose(1, 0, 3, 2)) / 2
    return h, g


@pytest.mark.parametrize("name", NAMES)
def test_circuit_builders_and_circuit_from_gates(name):
    jc, own, carried = _pair(name)
    assert own.fingerprint() == jc.fingerprint() == carried.fingerprint()
    assert own.num_parameters == jc.num_parameters
    assert own.parameter_bounds == jc.parameter_bounds
    assert (T.compile_circuit(own).is_real
            == J.compile_circuit(jc).is_real)


def test_ucc_metadata_and_mappers_match_jax():
    for mapper in (None, "ParityMapper", "BravyiKitaevMapper"):
        jm = None if mapper is None else getattr(JO, mapper)()
        tm = None if mapper is None else getattr(TO, mapper)()
        jc = J.UCCSD(2, (1, 1), qubit_mapper=jm,
                     initial_state=J.HartreeFock(2, (1, 1), qubit_mapper=jm))
        tc = T.UCCSD(2, (1, 1), qubit_mapper=tm,
                     initial_state=T.HartreeFock(2, (1, 1), qubit_mapper=tm))
        assert tc.fingerprint() == jc.fingerprint()
        assert tc._encoding == jc._encoding
        assert tc._ucc_pool == jc._ucc_pool
        assert tc._ucc_excitations == jc._ucc_excitations
        assert (tc._ucc_initial_state.fingerprint()
                == jc._ucc_initial_state.fingerprint())
    with pytest.raises(ValueError, match="encoding"):
        T.UCCSD(2, (1, 1), qubit_mapper=TO.ParityMapper(),
                initial_state=T.HartreeFock(2, (1, 1)))
    qc = T.QuantumCircuit(2)
    qc.initialize_statevector(np.array([0.6, 0, 0, 0.8]))
    both = qc.compose(T.RealAmplitudes(2, reps=1))
    assert both.num_parameters == 4 and len(both.parameter_bounds) == 4


@pytest.mark.parametrize("name", NAMES)
def test_statevector_matches_jax(name):
    jc, own, _ = _pair(name)
    theta = _theta(jc.num_parameters, seed=1)
    want = np.asarray(J.compile_circuit(jc).state(theta))
    got = T.statevector(own, theta, device="cpu")
    assert got.dtype == (torch.float64 if np.isrealobj(want)
                         else torch.complex128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SV_TOL)


def test_init_sv_and_primitives_match_jax():
    rng = np.random.default_rng(2)
    vec = rng.normal(size=8) + 1j * rng.normal(size=8)
    vec /= np.linalg.norm(vec)
    circuits = []
    for lib in (J, T):
        qc = lib.QuantumCircuit(3)
        qc.initialize_statevector(vec)
        qc.ry(qc.parameter(), 1).cx(1, 2).h(0)
        circuits.append(qc)
    got = T.statevector(circuits[1], [0.4], device="cpu").numpy()
    np.testing.assert_allclose(
        got, np.asarray(J.statevector(circuits[0], np.array([0.4]))),
        atol=SV_TOL)
    s = torch.as_tensor(vec)
    js = jnp.asarray(vec)
    U = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    U4 = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    pairs = [
        (TV.apply_x_mask(s, 0b101), JV.apply_x_mask(js, 0b101)),
        (TV.pauli_action(s, 0b110, 0b011, 1),
         JV.pauli_action(js, 0b110, 0b011, 1)),
        (TV.apply_pauli_rotation(s, 0b110, 0b011, 1, 0.7),
         JV.apply_pauli_rotation(js, 0b110, 0b011, 1, 0.7)),
        (TV.apply_1q(s, torch.as_tensor(U), 1), JV.apply_1q(js, U, 1)),
        (TV.apply_2q(s, torch.as_tensor(U4), 2, 0),
         JV.apply_2q(js, U4, 2, 0)),
        (TV.pauli_quadforms(s, [1, 3, 6], [0, 5, 7]),
         JV.pauli_quadforms(js, jnp.array([1, 3, 6]), jnp.array([0, 5, 7])))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SV_TOL)
    args = ([1, 3, 6], [0, 5, 7], [0, 1, 2], [0.5, -0.2, 1.1])
    assert abs(TV.expectation_pauli(s, *args)
               - JV.expectation_pauli(js, *map(np.asarray, args))) <= SV_TOL
    z = TV.zero_state(3, device="cpu")
    assert z.dtype == torch.complex128 and float(z[0].real) == 1.0


def test_per_gate_signs_equal_jax():
    """The scan's sign tables against the JAX package's
    population_count parities, gate by gate."""
    jc = J.UCCSD(3, (2, 1), initial_state=J.HartreeFock(3, (2, 1)))
    xs, zs = (np.array([g.data[i] for g in jc.gates if g.name == "prot"])
              for i in (0, 1))
    idx = jnp.arange(64)
    want = np.stack([np.asarray(
        1 - 2 * (jax.lax.population_count((idx ^ x) & z) & 1))
        for x, z in zip(xs, zs)])
    got = TV._prot_signs(xs, zs, 64, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("force_complex", [False, True])
def test_scan_path_matches_unrolled(force_complex, monkeypatch):
    """Runs of Pauli rotations at or past _SCAN_THRESHOLD go through
    _ProtScan; below it, gate by gate.  Same state and gradient to
    1e-13 (the two order a gate's products differently)."""
    ans = T.UCCSD(3, (1, 1), initial_state=T.HartreeFock(3, (1, 1)), reps=3)
    theta = torch.as_tensor(_theta(ans.num_parameters))
    h, g = expand_spin_tensors(*map(torch.as_tensor, _tensors(3)))

    def run(threshold):
        monkeypatch.setattr(TV, "_SCAN_THRESHOLD", threshold)
        cc = TV.CompiledCircuit(ans, force_complex=force_complex)
        t = theta.clone().requires_grad_(True)
        s = cc.state_fn(t)
        TR.rdm_energy(s, h, g).backward()
        return s.detach(), t.grad

    (su, gu), (ss, gs) = run(10 ** 9), run(4)
    torch.testing.assert_close(ss, su, rtol=0, atol=1e-13)
    torch.testing.assert_close(gs, gu, rtol=0, atol=1e-13)


def test_remat_chunked_gradient_is_identical(monkeypatch):
    """Past _REMAT_RESIDUAL_BUDGET the scan keeps every sqrt(K)-th state
    and recomputes the rest in the backward: state, energy and gradient
    bit for bit those of the unchunked scan (tests/test_sim.py:199)."""
    ans = T.UCCSD(3, (2, 1), initial_state=T.HartreeFock(3, (2, 1)), reps=3)
    theta = torch.as_tensor(_theta(ans.num_parameters, scale=0.1))
    h, g = expand_spin_tensors(*map(torch.as_tensor, _tensors(3)))

    def run(budget):
        monkeypatch.setattr(TV, "_REMAT_RESIDUAL_BUDGET", budget)
        cc = TV.CompiledCircuit(ans)
        t = theta.clone().requires_grad_(True)
        s = cc.state_fn(t)
        e = TR.rdm_energy(s, h, g)
        e.backward()
        return s.detach(), e.detach(), t.grad

    plain, remat = run(1 << 40), run(1)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["uccsd", "uccsd_complex", "efficient_su2"])
def test_rdm_energy_gradient_matches_jax(case):
    if case == "efficient_su2":
        jc = J.EfficientSU2(6, reps=2)
        tc = T.EfficientSU2(6, reps=2)
    else:
        jc = J.UCCSD(3, (2, 1), initial_state=J.HartreeFock(3, (2, 1)),
                     reps=4)
        tc = T.UCCSD(3, (2, 1), initial_state=T.HartreeFock(3, (2, 1)),
                     reps=4)
    fc = case == "uccsd_complex"
    jcc = JV.CompiledCircuit(jc, force_complex=fc)
    tcc = TV.CompiledCircuit(tc, force_complex=fc)
    h, g = _tensors(3, seed=4)
    jh, jg = jexpand(jnp.asarray(h), jnp.asarray(g))
    th, tg = expand_spin_tensors(torch.as_tensor(h), torch.as_tensor(g))
    theta = _theta(jc.num_parameters, seed=5, scale=0.5)
    e, grad = jax.value_and_grad(
        lambda t: JR.rdm_energy(jcc.state_fn(t), jh, jg))(jnp.asarray(theta))
    t = torch.as_tensor(theta).requires_grad_(True)
    E = TR.rdm_energy(tcc.state_fn(t), th, tg)
    E.backward()
    assert abs(float(E.detach()) - float(e)) <= SV_TOL
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), rtol=0,
                               atol=GRAD_TOL)


@pytest.mark.parametrize("complex_state", [False, True])
def test_rdms_match_jax(complex_state):
    rng = np.random.default_rng(6)
    N = 6
    v = rng.normal(size=2 ** N)
    if complex_state:
        v = v + 1j * rng.normal(size=2 ** N)
    v /= np.linalg.norm(v)
    h, g = _tensors(N, seed=7)
    s, js = torch.as_tensor(v), jnp.asarray(v)
    for got, want in ((TR.one_rdm(s, N), JR.one_rdm(js, N)),
                      (TR.two_rdm(s, N), JR.two_rdm(js, N)),
                      (TR.annihilate(s, 3), JR.annihilate(js, 3)),
                      (TR.rdm_energy(s, torch.as_tensor(h),
                                     torch.as_tensor(g)),
                       JR.rdm_energy(js, jnp.asarray(h), jnp.asarray(g)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SV_TOL)
    # leading batch axes: each state as its own run
    both = torch.stack([s, 2 * s])
    np.testing.assert_allclose(
        TR.one_rdm(both, N)[1].numpy(), 4 * np.asarray(JR.one_rdm(js, N)),
        atol=SV_TOL)


def test_batched_apply_matches_jax():
    jc = J.UCCSD(3, (2, 1), reps=4)
    tc = T.UCCSD(3, (2, 1), reps=4)
    theta = _theta(jc.num_parameters, seed=8)
    V = np.random.default_rng(9).normal(size=(3, 64))
    got = T.compile_circuit(tc).apply_raw(torch.as_tensor(V),
                                          torch.as_tensor(theta))
    fn = J.compile_circuit(jc).apply_fn
    want = np.stack([np.asarray(fn(jnp.asarray(v), jnp.asarray(theta)))
                     for v in V])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SV_TOL)
    with pytest.raises(ValueError, match="complex circuit"):
        T.compile_circuit(T.EfficientSU2(6)).apply_raw(
            torch.as_tensor(V), torch.zeros(T.EfficientSU2(6).num_parameters))


def test_precision_mode_sets_the_state_dtype():
    ra = T.RealAmplitudes(3, reps=1)
    with precision_mode("fast"):
        assert T.statevector(ra, device="cpu").dtype == torch.float32
        assert T.statevector(T.EfficientSU2(3, reps=1),
                             device="cpu").dtype == torch.complex64
    assert T.statevector(ra, device="cpu").dtype == torch.float64


def _hamiltonians(h2):
    h, g = h2.integral_tensors()
    return JBuilder(4).build(h, g), ActiveSpaceHamiltonianBuilder(4).build(h, g)


def test_estimator_matches_jax(h2_sto3g):
    jH, tH = _hamiltonians(h2_sto3g)
    jP = JPauli((jH.xs, jH.zs), jH.coeffs, num_qubits=4)     # no (h, g) tag
    tP = SparsePauliOp((tH.xs, tH.zs), tH.coeffs, num_qubits=4)
    jc = J.UCCSD(2, (1, 1), initial_state=J.HartreeFock(2, (1, 1)))
    tc = T.UCCSD(2, (1, 1), initial_state=T.HartreeFock(2, (1, 1)))
    pts = [list(_theta(3, seed=s, scale=0.3)) for s in range(3)]
    want = J.Estimator().run([jc] * 3, [jH, jP, jH], pts).result().values
    got = T.Estimator(device="cpu").run([tc] * 3, [tH, tP, tH],
                                        pts).result().values
    np.testing.assert_allclose(got, want, rtol=0, atol=SV_TOL)
    # one flat parameter set broadcast over observables
    np.testing.assert_allclose(
        T.Estimator(device="cpu").run(tc, [tH, tP], pts[0]).result().values,
        want[:1].repeat(2), atol=SV_TOL)
    with pytest.raises(ValueError):
        T.Estimator(device="cpu").run([tc, tc], [tH] * 3, pts)
    # shots: Gaussian noise of the exact variance, from a seeded generator
    shot = [T.Estimator(shots=10 ** 4, seed=3, device="cpu").run(
        tc, tH, pts[1]).result() for _ in range(2)]
    assert shot[0].values[0] == shot[1].values[0]
    var = shot[0].metadata[0]["variance"]
    assert var > 0.0
    assert abs(shot[0].values[0] - want[1]) < 10 * np.sqrt(var / 10 ** 4)


def test_sampler_and_fidelity_match_jax():
    jc, tc = J.RealAmplitudes(3, reps=2), T.RealAmplitudes(3, reps=2)
    a, b = _theta(9, seed=10), _theta(9, seed=11)
    want = J.Sampler().run([jc, jc], [a, b]).result().quasi_dists
    got = T.Sampler(device="cpu").run([tc, tc], [a, b]).result().quasi_dists
    for dg, dw in zip(got, want):
        assert dg.keys() == dw.keys()
        np.testing.assert_allclose([dg[k] for k in dw], list(dw.values()),
                                   rtol=0, atol=SV_TOL)
    jf = J.ComputeUncompute(J.Sampler()).run([jc, jc], jc, [a, b],
                                             [b, b]).result().fidelities
    tf = T.ComputeUncompute(T.Sampler(device="cpu")).run(
        [tc, tc], tc, [a, b], [b, b]).result().fidelities
    np.testing.assert_allclose(tf, jf, rtol=0, atol=SV_TOL)
    assert abs(tf[1] - 1.0) <= SV_TOL
