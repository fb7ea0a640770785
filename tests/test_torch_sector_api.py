"""The rest of esoo_torch.sim.SectorUCC's public API (to_full, full_state,
quadform(v, H), energy(theta, H)) against esoo_tpu's, and SectorCI's
content-key equality, float64 on the CPU.

Sectors of H2-, H3- and H4-size (n = 2, 3, 4 spatial orbitals with
(1, 1), (2, 1) and (2, 2) electrons), on both kernels ('strings' and
'pairs'), seeded angles and integrals with the chemistry symmetries.
Tolerance: 1e-12 of max(1, max|ref|) against the JAX package (the
mirror of tests/test_sector.py's full-state, dense-quadform and
RDM-from-to_full checks); the full-space RDMs of to_full against the
sector RDMs at 1e-10, as tests/test_sector.py holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esoo_torch as T
import esoo_tpu.sim.sector as jsector
from conftest import random_hermitian_tensors
from esoo_torch.sim import rdm as trdm
from esoo_torch.sim import sector as tsector
from esoo_tpu.orbital_optimization.kernels import expand_spin_tensors
from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD

jax.config.update("jax_enable_x64", True)

CASES = [(n, parts, kernel)
         for n, parts in ((2, (1, 1)), (3, (2, 1)), (4, (2, 2)))
         for kernel in ("strings", "pairs")]


def assert_close(out, ref, tol=1e-12):
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"n{n}-{k}" for n, _, k in CASES])
def case(request):
    """(JAX sector, port sector, spin-orbital h, g, theta)."""
    n, parts, kernel = request.param
    js = jsector.SectorUCC(JUCCSD(n, parts, initial_state=JHF(n, parts)),
                           2 * n, kernel=kernel)
    ts = tsector.SectorUCC(T.UCCSD(n, parts,
                                   initial_state=T.HartreeFock(n, parts)),
                           2 * n, kernel=kernel)
    assert ts.kernel == js.kernel == kernel
    h, g = random_hermitian_tensors(n, seed=3 + n)
    h, g = (np.array(a) for a in expand_spin_tensors(jnp.asarray(h),
                                                     jnp.asarray(g)))
    th = np.random.default_rng(5 + n).normal(size=len(ts._excs)) * 0.4
    return js, ts, h, g, th


def test_to_full_and_full_state_as_in_jax(case):
    js, ts, _, _, th = case
    ref_state = np.asarray(js.state(jnp.asarray(th)))
    ref_full = np.asarray(js.full_state(jnp.asarray(th)))
    assert_close(ts.full_state(torch.as_tensor(th)), ref_full)
    # every layout of the same amplitudes scatters alike: the padded
    # vector, the native layout, and a leading batch axis
    v = ts.state(torch.as_tensor(th))
    assert_close(v, ref_state)
    assert_close(ts.to_full(v), ref_full)
    assert_close(ts.to_full(ts.to_native(v)), ref_full)
    assert_close(ts.to_full(torch.stack([v, 2 * v])),
                 np.stack([ref_full, 2 * ref_full]))
    assert_close(ts.to_full(v), np.asarray(js.to_full(jnp.asarray(
        ref_state))))


def test_quadform_and_energy_over_the_dense_hamiltonian(case):
    js, ts, h, g, th = case
    H_j = js.build_hamiltonian(jnp.asarray(h), jnp.asarray(g))
    H_t = ts.build_hamiltonian(torch.as_tensor(h), torch.as_tensor(g))
    assert_close(H_t, H_j)
    v_j = js.state(jnp.asarray(th))
    v_t = ts.state(torch.as_tensor(th))
    assert_close(ts.quadform(v_t, H_t), js.quadform(v_j, H_j))
    assert_close(ts.quadform(ts.to_native(v_t), H_t),
                 js.quadform(v_j, H_j))
    assert_close(ts.energy(torch.as_tensor(th), H_t),
                 js.energy(jnp.asarray(th), H_j))
    # the dense form equals the production quadform over build_values
    vals = ts.build_values(torch.as_tensor(h), torch.as_tensor(g))
    assert_close(ts.quadform_values(ts.to_native(v_t), vals),
                 ts.quadform(v_t, H_t))


def test_energy_gradient_as_in_jax(case):
    js, ts, h, g, th = case
    H_j = js.build_hamiltonian(jnp.asarray(h), jnp.asarray(g))
    ref = jax.grad(lambda t: js.energy(t, H_j))(jnp.asarray(th))
    H_t = ts.build_hamiltonian(torch.as_tensor(h), torch.as_tensor(g))
    t = torch.as_tensor(th).requires_grad_(True)
    (got,) = torch.autograd.grad(ts.energy(t, H_t), t)
    assert_close(got, ref)


def test_rdms_of_to_full_equal_the_sector_rdms(case):
    """tests/test_sector.py's check: the full-space RDMs of the scattered
    state equal the sector-native ones (1e-10)."""
    _, ts, _, _, th = case
    v = ts.state(torch.as_tensor(th))
    g1, g2 = ts.rdms(v)
    full = ts.to_full(v)
    N = ts.num_qubits
    assert_close(trdm.one_rdm(full, N), g1.numpy(), tol=1e-10)
    assert_close(trdm.two_rdm(full, N), g2.numpy(), tol=1e-10)


def test_sector_ci_compares_by_content():
    """SectorCI's content key (the JAX package's __eq__/__hash__): equal
    for the same (N, particles), so the instances key one cache entry."""
    a, b = T.SectorCI(4, (1, 1)), T.SectorCI(4, (1, 1))
    ja, jb = jsector.SectorCI(4, (1, 1)), jsector.SectorCI(4, (1, 1))
    assert (a == b) is (ja == jb) is True
    assert hash(a) == hash(b)
    assert len({a, b}) == 1
    assert a != T.SectorCI(4, (2, 0)) and a != T.SectorCI(6, (1, 1))
    assert (ja != jsector.SectorCI(4, (2, 0))) is True
    ucc = tsector.SectorUCC(T.UCCSD(2, (1, 1),
                                    initial_state=T.HartreeFock(2, (1, 1))),
                            4)
    assert a != ucc and a.kernel == ucc.kernel == "strings"
    assert a._content_key == ja._content_key
