"""portbench/reference/vqe_lists.py, the benchmark's plain check of a
UCCSD-VQE request over excitation lists, against the dense check
(portbench/reference/vqe.py) and the port's FusedOptOrbVQE at float64 on
the CPU; and the limits of the float32 H8 -> 16 cell (h8_ccpvtz.vqe16)
against perturbed outputs.

Tolerances: the two checks compute the same sums over the same terms, so
every reading agrees to 1e-12; the port at float64 agrees with the
reference to 1e-10 on the energy and 1-RDM (its own CPU parity tests hold
it to the JAX package at 1e-12).
"""

import numpy as np
import pytest
import torch

import esoo_torch as T
from esoo_torch.chem import ElectronicStructureProblem, MoleculeDriver
from portbench.harness import manifest
from portbench.reference import checker, ucc, vqe_lists
from portbench.reference.sector import Sector

H4 = "H 0 0 0; H 0 0 1.23; H 0 0 2.46; H 0 0 3.69"
CELL = "h8_ccpvtz.vqe16"


def _start(m, n, seed=7):
    from scipy.linalg import expm
    k = np.random.default_rng(seed).normal(scale=0.05, size=(m, m))
    return expm(k - k.T)[:, :n]


def _random_integrals(m, seed):
    """A seeded (h, chemist eri) over m orbitals with the integrals'
    symmetries: h symmetric about spread orbital energies, eri = sum_L
    B_L (x) B_L over symmetric B_L (positive semidefinite, 8-fold)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(scale=0.1, size=(m, m))
    h = np.diag(np.linspace(-2.0, 2.0, m)) + a + a.T
    B = rng.normal(scale=0.3, size=(m, m, m))
    B = B + B.transpose(0, 2, 1)
    return h, np.einsum("lpq,lrs->pqrs", B, B)


@pytest.fixture(scope="module")
def h4_631g():
    p = MoleculeDriver(atom=H4, basis="6-31g").run()
    return {"h": p.hcore_mo, "eri": p.eri_mo, "num_particles": (2, 2),
            "problem": p}


def _vqe(problem, n, particles, start, maxiter, **kw):
    ans = T.UCCSD(n, particles, initial_state=T.HartreeFock(n, particles))
    r = T.FusedOptOrbVQE(
        num_spin_orbitals=2 * n, ansatz=ans, problem=problem,
        initial_partial_unitary=start, maxiter=maxiter, device="cpu",
        dtype=torch.float64, **kw).compute_minimum_energy()
    return {"energy": r.eigenvalue, "theta": r.optimal_point,
            "U": r.optimal_partial_unitary, "one_rdm": r.one_rdm_spatial,
            "start": start}


@pytest.fixture(scope="module")
def h4_out(h4_631g):
    return _vqe(h4_631g["problem"], 4, (2, 2), _start(8, 4), 20)


@pytest.mark.parametrize("n,na,nb", [(3, 2, 1), (4, 2, 2), (5, 2, 2)])
def test_the_state_from_lists_is_the_dense_generators_state(n, na, nb):
    sec = Sector(n, na, nb)
    G = ucc.generators(sec)
    theta = torch.as_tensor(np.random.default_rng(n).normal(
        scale=0.4, size=G.shape[0]))
    lists = vqe_lists.excitation_lists(sec)
    assert len(lists) == G.shape[0]
    for (dst, src, sign), Gk in zip(lists, G):
        x = torch.as_tensor(np.random.default_rng(1).normal(size=sec.dim))
        assert torch.allclose(vqe_lists._apply_generator(x, dst, src, sign),
                              Gk @ x, rtol=0, atol=1e-15)
    assert torch.allclose(vqe_lists.state(sec, lists, theta),
                          ucc.state(sec, G, theta), rtol=0, atol=1e-14)


def _random_case():
    """Seeded integrals over m = 7 orbitals, an active (5, (2, 2)) sector,
    a partial unitary, theta and outputs to read."""
    m, n = 7, 5
    h, eri = _random_integrals(m, 11)
    rng = np.random.default_rng(12)
    dim = len(ucc.excitations(n, 2, 2))
    out = {"energy": -3.0, "theta": rng.normal(scale=0.05, size=dim),
           "U": _start(m, n, 13), "one_rdm": np.eye(n)}
    return {"h": h, "eri": eri, "num_particles": (2, 2)}, n, out, \
        _start(m, n, 14)


def test_list_check_reads_as_the_dense_check_on_h4(h4_631g, h4_out):
    dense = checker("vqe")(h4_631g, 4, "cpu").readings(h4_out,
                                                       h4_out["start"])
    lists = checker("vqe_lists")(h4_631g, 4, "cpu").readings(
        h4_out, h4_out["start"])
    assert set(lists) == set(dense)
    for k, v in dense.items():
        assert lists[k] == pytest.approx(v, rel=0, abs=1e-12), k


def test_list_check_reads_as_the_dense_check_on_random_integrals():
    """From a theta away from the optimum both searches take vqe.py's
    budget of 500 iterations, so that they stop at the same minimum."""
    inputs, n, out, start = _random_case()
    dense = checker("vqe")(inputs, n, "cpu").readings(out, start)
    check = checker("vqe_lists")(inputs, n, "cpu")
    check.max_iter = 500
    lists = check.readings(out, start)
    for k, v in dense.items():
        assert lists[k] == pytest.approx(v, rel=0, abs=1e-12), k


def test_port_agrees_with_the_list_reference_on_a_synthetic_problem():
    """FusedOptOrbVQE at float64 on the CPU, m = 12 -> 12 spin orbitals
    (3, 3), seeded random integrals, UCCSD (117 gates, 400 determinants),
    two outer iterations of at most 20 L-BFGS iterations: the agreement
    holds at any state the solver returns."""
    m, n = 12, 6
    h, eri = _random_integrals(m, 21)
    prob = ElectronicStructureProblem(
        num_particles=(3, 3), num_spatial_orbitals=m,
        nuclear_repulsion_energy=0.0, hcore_mo=h, eri_mo=eri)
    out = _vqe(prob, n, (3, 3), _start(m, n, 22), 2, vqe_maxiter=20)
    got = vqe_lists.Check({"h": h, "eri": eri, "num_particles": (3, 3)},
                          n, "cpu").readings(out, out["start"])
    assert got["energy_gap_ha"] <= 1e-10
    assert got["rdm_gap"] <= 1e-10
    assert got["ortho_gap"] <= 1e-12


@pytest.mark.parametrize("field,number", [
    ("theta", "energy_gap_ha"), ("energy", "optimum_gap_ha"),
    ("U", "energy_gap_ha"), ("start", "orbital_grad_ratio")])
def test_the_cell_limits_reject_a_perturbed_output(h4_631g, h4_out, field,
                                                   number):
    """theta moved off the returned optimum, the energy reported off it,
    U made non-orthonormal (the cell compares no ortho_gap: its TF32
    control reads it no higher than the program, so U's columns scaled
    by 1 + 1e-3 are caught by the energy of the integrals at U), U left
    at its start: each reads past one of the cell's limits."""
    lim = manifest.limits(CELL)["limits"]
    bad = dict(h4_out)
    if field == "theta":
        bad["theta"] = h4_out["theta"] + 0.05
    elif field == "energy":
        bad["energy"] = h4_out["energy"] + 10 * lim["optimum_gap_ha"]
    elif field == "U":
        bad["U"] = h4_out["U"] * (1 + 1e-3)
    else:
        bad["U"] = h4_out["start"]
    got = vqe_lists.Check(h4_631g, 4, "cpu").readings(bad, bad["start"])
    assert got[number] > lim[number]
