"""The plain reference against the port's CPU path at float64 on small
problems, and against itself (a dense Hamiltonian, the RDM energy); it
rejects perturbed outputs."""

import numpy as np
import pytest
import torch

from portbench.reference import checker, orbitals, ucc
from portbench.reference.sector import Sector

H4 = "H 0 0 0; H 0 0 1.23; H 0 0 2.46; H 0 0 3.69"


@pytest.fixture(scope="module")
def h4_631g():
    from esoo_torch.chem import MoleculeDriver
    p = MoleculeDriver(atom=H4, basis="6-31g").run()
    return {"h": p.hcore_mo, "eri": p.eri_mo, "num_particles": (2, 2),
            "problem": p}


def _start(m, n, seed=7):
    from scipy.linalg import expm
    rng = np.random.default_rng(seed)
    k = rng.normal(scale=0.05, size=(m, m))
    return expm(k - k.T)[:, :n]


def _random_integrals(n, seed=3):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, n))
    h = h + h.T
    a = rng.normal(size=(n, n, n, n))
    eri = (a + a.transpose(1, 0, 2, 3) + a.transpose(0, 1, 3, 2)
           + a.transpose(1, 0, 3, 2))
    eri = eri + eri.transpose(2, 3, 0, 1)
    return torch.as_tensor(h), torch.as_tensor(eri)


def test_sigma_matches_the_dense_hamiltonian_of_the_port():
    """Sector.sigma against the port's SectorCI sigma at float64 on
    random integrals over every basis vector (3 orbitals, (2, 1))."""
    from esoo_torch.orbital_optimization.kernels import expand_spin_tensors
    from esoo_torch.sim.sector import SectorCI
    n, na, nb = 3, 2, 1
    h, eri = _random_integrals(n)
    sec = Sector(n, na, nb)
    port = SectorCI(2 * n, (na, nb))
    g_sp = 0.5 * eri.permute(0, 2, 1, 3)
    vals = port.build_values(*expand_spin_tensors(h, g_sp))
    for k in range(sec.dim):
        v = torch.zeros(sec.nB, sec.nA, dtype=torch.float64)
        v.view(-1)[k] = 1.0
        ours = sec.sigma(v, h, eri)
        theirs = port.sigma_values(v, vals)
        assert torch.allclose(ours, theirs, atol=1e-12)


def test_rdm1_traces_to_the_electrons_and_gives_the_one_body_energy():
    n = 4
    h, eri = _random_integrals(n, 5)
    sec = Sector(n, 2, 1)
    v = torch.as_tensor(np.random.default_rng(1).normal(
        size=(sec.nB, sec.nA)))
    v = v / torch.linalg.vector_norm(v)
    gamma, _ = sec.rdm12(v)
    assert float(torch.trace(gamma)) == pytest.approx(3.0)
    zero = torch.zeros_like(eri)
    assert float((h * gamma).sum()) == pytest.approx(
        float((v * sec.sigma(v, h, zero)).sum()), abs=1e-12)


def test_rdm12_gives_the_energy_of_sigma_and_its_orbital_gradient():
    """orbitals.energy of (gamma, P) is v^T H v at U = 1, and its gradient
    on the partial unitaries matches a central difference along a
    tangent direction."""
    n = 4
    h, eri = _random_integrals(n, 9)
    sec = Sector(n, 2, 2)
    v = torch.as_tensor(np.random.default_rng(2).normal(
        size=(sec.nB, sec.nA)))
    v = v / torch.linalg.vector_norm(v)
    gamma, P = sec.rdm12(v)
    eye = torch.eye(n, dtype=torch.float64)
    assert float(orbitals.energy(h, eri, eye, gamma, P)) == pytest.approx(
        float((v * sec.sigma(v, h, eri)).sum()), abs=1e-10)
    m = 6
    hm, erim = _random_integrals(m, 4)
    U = torch.as_tensor(_start(m, 3, seed=5))
    sec3 = Sector(3, 1, 1)
    w = torch.as_tensor(np.random.default_rng(3).normal(size=(3, 3)))
    gamma, P = sec3.rdm12(w)
    with torch.enable_grad():
        X = U.clone().requires_grad_(True)
        (G,) = torch.autograd.grad(orbitals.energy(hm, erim, X, gamma, P), X)
    K = torch.as_tensor(np.random.default_rng(8).normal(size=(m, m)))
    K = K - K.T
    t = 1e-5
    e = [float(orbitals.energy(hm, erim, torch.linalg.matrix_exp(s * K) @ U,
                               gamma, P)) for s in (t, -t)]
    assert (e[0] - e[1]) / (2 * t) == pytest.approx(
        float((G * (K @ U)).sum()), rel=1e-6)
    S = U.T @ G
    want = float(torch.linalg.matrix_norm(G - 0.5 * U @ (S + S.T)))
    assert orbitals.gradient_norm(hm, erim, U, gamma, P) == pytest.approx(
        want)


def test_ucc_generators_are_antisymmetric_with_cubic_identity():
    sec = Sector(4, 2, 2)
    G = ucc.generators(sec)
    assert G.shape == (26, 36, 36)
    assert torch.allclose(G, -G.transpose(1, 2))
    assert torch.allclose(G @ G @ G, -G, atol=1e-12)


def _vqe(inputs, seed=7):
    import esoo_torch
    p = inputs["problem"]
    ans = esoo_torch.UCCSD(4, (2, 2), initial_state=esoo_torch.HartreeFock(
        4, (2, 2)))
    r = esoo_torch.FusedOptOrbVQE(
        num_spin_orbitals=8, ansatz=ans, problem=p,
        initial_partial_unitary=_start(8, 4, seed), maxiter=20,
        device="cpu", dtype=torch.float64).compute_minimum_energy()
    return {"energy": r.eigenvalue, "theta": r.optimal_point,
            "U": r.optimal_partial_unitary, "one_rdm": r.one_rdm_spatial,
            "start": _start(8, 4, seed)}


def _casscf(inputs, seed=7):
    import esoo_torch
    r = esoo_torch.FusedOptOrbCASSCF(
        num_spin_orbitals=8, problem=inputs["problem"],
        initial_partial_unitary=_start(8, 4, seed), maxiter=20,
        device="cpu", dtype=torch.float64).compute_minimum_energy()
    return {"energy": r.eigenvalue, "ci": r.optimal_point,
            "U": r.optimal_partial_unitary, "one_rdm": r.one_rdm_spatial,
            "start": _start(8, 4, seed)}


@pytest.fixture(scope="module")
def vqe_out(h4_631g):
    return _vqe(h4_631g)


@pytest.fixture(scope="module")
def casscf_out(h4_631g):
    return _casscf(h4_631g)


def test_vqe_reference_agrees_with_the_port_at_float64(h4_631g, vqe_out):
    got = checker("vqe")(h4_631g, 4, "cpu").readings(vqe_out,
                                                     vqe_out["start"])
    assert got["energy_gap_ha"] < 1e-12
    assert got["rdm_gap"] < 1e-12
    assert got["ortho_gap"] < 1e-12
    assert got["theta_grad"] < 1e-6
    assert abs(got["theta_excess_ha"]) < 1e-10
    assert got["orbital_grad_ratio"] < 0.05


def test_casscf_reference_agrees_with_the_port_at_float64(h4_631g,
                                                          casscf_out):
    got = checker("casscf")(h4_631g, 4, "cpu").readings(casscf_out,
                                                        casscf_out["start"])
    assert got["energy_gap_ha"] < 1e-12
    assert got["residual_ha"] < 1e-8
    assert got["rdm_gap"] < 1e-12
    assert got["ortho_gap"] < 1e-12
    assert got["orbital_grad_ratio"] < 0.05


def _past(limits, number):
    """Ten times the cell's limit of `number` (1e-3 where it has none)."""
    return 10 * limits.get(number, 1e-4)


@pytest.mark.parametrize("field,change,number", [
    ("energy", lambda x, d: x + d, "energy_gap_ha"),
    ("one_rdm", lambda x, d: x + d * np.eye(4), "rdm_gap"),
    ("theta", lambda x, d: np.zeros_like(x), "theta_excess_ha"),
    ("U", lambda x, d: x * (1 + d), "ortho_gap")])
def test_vqe_reference_rejects_a_perturbed_output(h4_631g, vqe_out, field,
                                                  change, number):
    from portbench.harness import manifest
    lim = manifest.limits("h4_ccpvtz.vqe8")["limits"]
    bad = dict(vqe_out, **{field: change(vqe_out[field], _past(lim,
                                                               number))})
    got = checker("vqe")(h4_631g, 4, "cpu").readings(bad, bad["start"])
    assert got[number] > lim.get(number, 1e-5)


@pytest.mark.parametrize("field,change,number", [
    ("energy", lambda x, d: x + d, "energy_gap_ha"),
    ("one_rdm", lambda x, d: x + d * np.eye(4), "rdm_gap"),
    ("ci", lambda x, d: np.roll(x, 1), "residual_ha"),
    ("U", lambda x, d: x * (1 + d), "ortho_gap")])
def test_casscf_reference_rejects_a_perturbed_output(h4_631g, casscf_out,
                                                     field, change, number):
    from portbench.harness import manifest
    lim = manifest.limits("h8_ccpvtz_f64.casscf28")["limits"]
    bad = dict(casscf_out, **{field: change(casscf_out[field],
                                            _past(lim, number))})
    got = checker("casscf")(h4_631g, 4, "cpu").readings(bad, bad["start"])
    assert got[number] > lim.get(number, 1e-5)


@pytest.mark.parametrize("kind,cell", [("vqe", "h4_ccpvtz.vqe8"),
                                       ("casscf", "h8_ccpvtz_f64.casscf28")])
def test_orbitals_returned_at_their_start_read_one(h4_631g, vqe_out,
                                                   casscf_out, kind, cell):
    from portbench.harness import manifest
    out = vqe_out if kind == "vqe" else casscf_out
    bad = dict(out, U=out["start"])
    got = checker(kind)(h4_631g, 4, "cpu").readings(bad, bad["start"])
    assert got["orbital_grad_ratio"] == pytest.approx(1.0, abs=1e-12)
    assert got["orbital_grad_ratio"] > \
        manifest.limits(cell)["limits"]["orbital_grad_ratio"]
