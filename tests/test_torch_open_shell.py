"""Open-shell chemistry through the port's solvers against esoo_tpu,
float64 on the CPU: ROHF problems from the ported driver (until now the
open-shell sectors reached the port's solvers only through synthetic
tables).

- H3 6-31G chain (0.9 A spacing, doublet) -> 6 spin orbitals:
  FusedOptOrbVQE, and FusedOptOrbCASSCF with dense and compact tables;
- C cc-pVDZ triplet, frozen 1s core -> 8 spin orbitals:
  FusedOptOrbCASSCF.

Each package solves its own driver's problem (the two are bitwise
equal); energies agree to 1e-8, <S^2> is S(S+1)."""

import numpy as np
import pytest

import esoo_torch.chem as TC
import esoo_tpu.chem as JC
from esoo_torch import FusedOptOrbCASSCF, FusedOptOrbVQE, HartreeFock, UCCSD
from esoo_tpu.orbital_optimization import (FusedOptOrbCASSCF as JCASSCF,
                                           FusedOptOrbVQE as JVQE)
from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD
from test_torch_engine import same_eri_engine  # noqa: F401

H3_GEOM = "H 0 0 0; H 0 0 0.9; H 0 0 1.8"


@pytest.fixture(scope="module")
def h3():
    tp = TC.MoleculeDriver(H3_GEOM, basis="6-31g", spin=1).run()
    jp = JC.MoleculeDriver(H3_GEOM, basis="6-31g", spin=1).run()
    assert tp.num_particles == (2, 1) and tp.num_spatial_orbitals == 6
    np.testing.assert_array_equal(tp.eri_mo, jp.eri_mo)
    return tp, jp


@pytest.fixture(scope="module")
def carbon():
    tp = TC.MoleculeDriver("C 0 0 0", basis="cc-pvdz", spin=2).run()
    jp = JC.MoleculeDriver("C 0 0 0", basis="cc-pvdz", spin=2).run()
    ta, ja = tp.active_space(), jp.active_space()
    assert ta.num_particles == (3, 1) and ta.num_spatial_orbitals == 13
    np.testing.assert_array_equal(ta.hcore_mo, ja.hcore_mo)
    return ta, ja


def _assert_results_close(r, ref, s2):
    assert abs(r.eigenvalue - ref.eigenvalue) <= 1e-8
    assert r.outer_iterations == ref.outer_iterations
    np.testing.assert_allclose(r.energy_convergence_list,
                               ref.energy_convergence_list, rtol=0,
                               atol=1e-8)
    assert r.spin_squared == pytest.approx(s2, abs=1e-6)
    assert abs(r.spin_squared - ref.spin_squared) <= 1e-8
    np.testing.assert_allclose(r.natural_occupations,
                               ref.natural_occupations, rtol=0, atol=1e-6)


def test_h3_doublet_vqe_matches_jax(h3):
    tp, jp = h3
    r = FusedOptOrbVQE(6, UCCSD(3, (2, 1), initial_state=HartreeFock(
        3, (2, 1))), problem=tp, maxiter=20, stopping_tolerance=1e-5,
        device="cpu").compute_minimum_energy()
    ref = JVQE(num_spin_orbitals=6, ansatz=JUCCSD(
        3, (2, 1), initial_state=JHF(3, (2, 1))), problem=jp, maxiter=20,
        stopping_tolerance=1e-5).compute_minimum_energy()
    _assert_results_close(r, ref, 0.75)
    assert r.eigenvalue < tp.scf.energy_electronic


@pytest.mark.parametrize("storage", ["dense", "compact"])
def test_h3_doublet_casscf_matches_jax(h3, storage):
    tp, jp = h3
    r = FusedOptOrbCASSCF(6, problem=tp, table_storage=storage,
                          device="cpu").compute_minimum_energy()
    ref = JCASSCF(6, problem=jp,
                  table_storage=storage).compute_minimum_energy()
    assert r.eigenvalue <= r.energy_convergence_list[0] + 1e-12
    _assert_results_close(r, ref, 0.75)


def test_carbon_triplet_frozen_core_casscf_matches_jax(carbon):
    ta, ja = carbon
    r = FusedOptOrbCASSCF(8, problem=ta, device="cpu",
                          maxiter=20).compute_minimum_energy()
    ref = JCASSCF(8, problem=ja, maxiter=20).compute_minimum_energy()
    _assert_results_close(r, ref, 2.0)
    # the port's properties on the open-shell result: two unpaired
    # electrons on the one atom, no dipole
    g, U = r.one_rdm_spatial, r.optimal_partial_unitary
    pops = TC.populations(ta, r.spin_density_spatial, U, include_core=False)
    assert pops[0].sum() == pytest.approx(2.0, abs=1e-8)
    np.testing.assert_allclose(TC.dipole_moment(ta, g, U), 0.0, atol=1e-8)
    assert TC.populations(ta, g, U)[0].sum() == pytest.approx(6.0,
                                                               abs=1e-8)
