"""esoo_torch.chem post-processing against esoo_tpu.chem, float64 on the
CPU: properties, MP2, CISD, CCSD, localization, thermochemistry, cube
files (chem/{properties,mp2,cisd,cc,localize,thermo,cube}.py) and the
geometry drivers (chem/geometry.py).

Each function of the port runs on the port driver's problem and its JAX
twin on the JAX driver's (the two are bitwise equal, test_torch_chem.py)
with the same seeded inputs.  Tolerances: 1e-10 for the post-processing
(the same NumPy on the same inputs; 1e-12 for cube values); 1e-8 for
what a solver computes (the port's FusedOptOrbCASSCF against the JAX
one, each stopping at its own tolerance)."""

import numpy as np
import pytest
import torch

import esoo_torch.chem as TC
import esoo_tpu.chem as JC
from esoo_torch import FusedOptOrbCASSCF, FusedOptOrbSACASSCF
from esoo_torch.chem import geometry as TGEO, properties as TP
from esoo_tpu.chem import geometry as JGEO, properties as JP
from test_torch_engine import same_eri_engine  # noqa: F401

H2O_GEOM = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
LIH_GEOM = "Li 0 0 0; H 0 0 1.5949"
H2_GEOM = "H 0 0 0; H 0 0 0.735"
TOL = 1e-10


def assert_close(out, ref, atol=TOL):
    if isinstance(ref, dict):
        assert set(out) == set(ref)
        for k in ref:
            assert_close(out[k], ref[k], atol)
    elif isinstance(ref, (tuple, list)) and not np.isscalar(ref):
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            assert_close(a, b, atol)
    elif isinstance(ref, (str, bool, type(None))):
        assert out == ref
    else:
        np.testing.assert_allclose(np.asarray(out, dtype=float),
                                   np.asarray(ref, dtype=float), rtol=0,
                                   atol=atol * max(1.0, float(np.nanmax(
                                       np.abs(np.asarray(ref, float)),
                                       initial=0.0))))


@pytest.fixture(scope="module")
def h2o():
    """(port, JAX) H2O STO-3G problems, full space."""
    return (TC.MoleculeDriver(H2O_GEOM, basis="sto-3g").run(),
            JC.MoleculeDriver(H2O_GEOM, basis="sto-3g").run())


@pytest.fixture(scope="module")
def lih():
    """(port, JAX) LiH STO-3G problems and the port's CASSCF (8 spin
    orbitals) and SA-CASSCF (k=2) results on the frozen-core problem."""
    tp = TC.MoleculeDriver(LIH_GEOM, basis="sto-3g").run()
    jp = JC.MoleculeDriver(LIH_GEOM, basis="sto-3g").run()
    ta = tp.active_space()
    r = FusedOptOrbCASSCF(8, problem=ta, device="cpu").compute_minimum_energy()
    sa = FusedOptOrbSACASSCF(8, k=2, problem=ta,
                             device="cpu").compute_energies()
    return tp, jp, ta, jp.active_space(), r, sa


def _seeded_state(n_active, m, seed):
    """A symmetric positive 1-RDM over n_active orbitals and an (m,
    n_active) partial unitary, from numpy's generator."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n_active, n_active))
    gamma = a @ a.T / n_active
    U = np.linalg.qr(rng.normal(size=(m, n_active)))[0]
    return gamma, U


# -- properties ----------------------------------------------------------

@pytest.mark.parametrize("state", ["mean_field", "seeded", "casscf"])
def test_properties_match_jax(lih, state):
    tp, jp, ta, ja, r, _ = lih
    if state == "mean_field":
        tprob, jprob, g, U = tp, jp, None, None
    elif state == "seeded":
        tprob, jprob = tp, jp
        g, U = _seeded_state(3, tp.num_spatial_orbitals, 3)
    else:
        tprob, jprob = ta, ja
        g, U = r.one_rdm_spatial, r.optimal_partial_unitary
    for unit in ("au", "debye"):
        assert_close(TP.dipole_moment(tprob, g, U, unit=unit),
                     JP.dipole_moment(jprob, g, U, unit=unit))
    for traceless in (True, False):
        for unit in ("au", "buckingham"):
            assert_close(
                TP.quadrupole_moment(tprob, g, U, traceless, unit),
                JP.quadrupole_moment(jprob, g, U, traceless, unit))
    assert_close(TP.density_ao(tprob, g, U), JP.density_ao(jprob, g, U))
    for method in ("mulliken", "lowdin"):
        assert_close(TP.populations(tprob, g, U, method),
                     JP.populations(jprob, g, U, method))
    spin = None if state == "mean_field" else (
        r.spin_density_spatial if state == "casscf" else 0.1 * g)
    assert_close(TP.bond_orders(tprob, g, U, spin),
                 JP.bond_orders(jprob, g, U, spin))
    if g is not None:
        assert_close(TP.natural_orbitals(tprob, g, U),
                     JP.natural_orbitals(jprob, g, U))
    assert_close(TP.hf_density_spatial(tprob), JP.hf_density_spatial(jprob))
    if state == "casscf":
        # LiH is polar along z; the populations sum to the 4 electrons
        mu = TP.dipole_moment(ta, g, U)
        assert abs(mu[2]) > 1.0 and np.allclose(mu[:2], 0, atol=1e-8)
        assert TP.populations(ta, g, U)[0].sum() == pytest.approx(4.0,
                                                                   abs=1e-10)


def test_properties_take_tensors_at_the_boundary(lih):
    """A torch tensor (the solvers hand over NumPy) is read as NumPy."""
    tp, _, ta, _, r, sa = lih
    g, U = r.one_rdm_spatial, r.optimal_partial_unitary
    tg, tU = torch.as_tensor(g), torch.as_tensor(U)
    np.testing.assert_array_equal(TP.dipole_moment(ta, tg, tU),
                                  TP.dipole_moment(ta, g, U))
    np.testing.assert_array_equal(TP.quadrupole_moment(ta, tg, tU),
                                  TP.quadrupole_moment(ta, g, U))
    np.testing.assert_array_equal(TP.populations(ta, tg, tU)[0],
                                  TP.populations(ta, g, U)[0])
    t, V = sa.transition_rdm1_spatial, sa.optimal_partial_unitary
    np.testing.assert_array_equal(
        TP.transition_dipoles(ta, torch.as_tensor(t), torch.as_tensor(V)),
        TP.transition_dipoles(ta, t, V))
    with pytest.raises(ValueError, match="dipole_mo"):
        TP.dipole_moment(TC.ElectronicStructureProblem(
            num_particles=(1, 1), num_spatial_orbitals=2,
            nuclear_repulsion_energy=0.0, hcore_mo=np.eye(2),
            eri_mo=np.zeros((2,) * 4)))


def test_transition_dipoles_and_oscillator_strengths_match_jax(lih):
    _, _, ta, ja, _, sa = lih
    t, U = sa.transition_rdm1_spatial, sa.optimal_partial_unitary
    for unit in ("au", "debye"):
        assert_close(TP.transition_dipoles(ta, t, U, unit=unit),
                     JP.transition_dipoles(ja, t, U, unit=unit))
    mu = TP.transition_dipoles(ta, t, U)
    f = TP.oscillator_strengths(sa.eigenvalues, mu)
    assert_close(f, JP.oscillator_strengths(sa.eigenvalues, mu))
    assert f[0, 1] > 0 and f[0, 1] == pytest.approx(-f[1, 0])


def test_field_and_polarizability_match_jax(h2o):
    tp, jp = h2o
    F = np.array([1e-3, -2e-3, 3e-3])
    tf, jf = TP.apply_field(tp, F), JP.apply_field(jp, F)
    np.testing.assert_array_equal(tf.hcore_mo, jf.hcore_mo)
    assert tp.hcore_mo is not tf.hcore_mo
    a_t = TP.polarizability(tp, lambda p: TC.mp2(p)["e_total"])
    a_j = JP.polarizability(jp, lambda p: JC.mp2(p)["e_total"])
    assert_close(a_t, a_j)
    assert np.allclose(a_t, a_t.T) and a_t[2, 2] > 0
    zz = TP.polarizability(tp, lambda p: TC.mp2(p)["e_total"],
                           components=[(2, 2)])
    assert zz[2, 2] == pytest.approx(a_t[2, 2], abs=1e-10)


# -- correlated methods --------------------------------------------------

@pytest.mark.parametrize("method", ["mp2", "cisd", "ccsd", "ccsd_t"])
def test_correlated_methods_match_jax(h2o, method):
    tp, jp = h2o
    if method == "mp2":
        for nf in (0, 1):
            assert_close(TC.mp2(tp, n_frozen=nf), JC.mp2(jp, n_frozen=nf))
        with pytest.raises(ValueError, match="closed-shell"):
            TC.mp2(TC.MoleculeDriver("H 0 0 0; H 0 0 0.9; H 0 0 1.8",
                                     basis="sto-3g", spin=1).run())
    elif method == "cisd":
        assert_close(TC.cisd(tp, k=2), JC.cisd(jp, k=2))
        ta, ja = tp.active_space(), jp.active_space()
        assert_close(TC.cisd(ta), JC.cisd(ja))
    else:
        kw = dict(n_frozen=1, triples=method == "ccsd_t")
        out, ref = TC.ccsd(tp, **kw), JC.ccsd(jp, **kw)
        assert out["converged"] and out["n_iter"] == ref["n_iter"]
        assert_close(out, ref)


def test_open_shell_ccsd_and_cisd_match_jax():
    atom = "H 0 0 0; H 0 0 0.9; H 0 0 1.8"
    tp = TC.MoleculeDriver(atom, basis="sto-3g", spin=1).run()
    jp = JC.MoleculeDriver(atom, basis="sto-3g", spin=1).run()
    assert_close(TC.ccsd(tp), JC.ccsd(jp))
    assert_close(TC.cisd(tp), JC.cisd(jp))


@pytest.mark.parametrize("method", ["pipek", "boys"])
def test_localize_orbitals_match_jax(h2o, method):
    tp, jp = h2o
    for orbitals in (None, [1, 2, 3, 4], np.arange(7) < 5):
        assert_close(TC.localize_orbitals(tp, orbitals, method),
                     JC.localize_orbitals(jp, orbitals, method))
    with pytest.raises(ValueError, match="duplicate"):
        TC.localize_orbitals(tp, [1, 1], method)


# -- thermochemistry -----------------------------------------------------

def test_thermochemistry_and_eyring_match_jax():
    atom = "O 0 0 0; H 0.7572 0 0.5865; H -0.7572 0 0.5865"
    kw = dict(frequencies_cm1=[1595.0, 3657.0, 3756.0], temperature=350.0,
              pressure=1e5, symmetry_number=2, electronic_energy=-76.0)
    assert_close(TC.thermochemistry(atom, **kw),
                 JC.thermochemistry(atom, **kw))
    # a harmonic_frequencies-style result: trans/rot rows and one
    # imaginary mode dropped by the mask and the sign
    fr = {"frequencies_cm1": np.array([-300.0, 1.0, 2.0, 3.0, 4.0, 5.0,
                                       6.0, 1500.0, 3700.0]),
          "vib_mask": np.array([True] + [False] * 6 + [True, True])}
    assert_close(TC.thermochemistry(atom, fr, multiplicity=3),
                 JC.thermochemistry(atom, fr, multiplicity=3))
    assert_close(TC.thermochemistry("He 0 0 0"),
                 JC.thermochemistry("He 0 0 0"))
    for dg, T in ((0.02, 298.15), (0.035, 500.0)):
        assert_close(TC.eyring_rate(dg, T), JC.eyring_rate(dg, T))
    assert TGEO.ISOTOPE_MASSES == JGEO.ISOTOPE_MASSES


# -- cube files ----------------------------------------------------------

def test_cube_values_and_round_trip_match_jax(lih, tmp_path):
    tp, jp, ta, ja, r, _ = lih
    g, U = r.one_rdm_spatial, r.optimal_partial_unitary
    rng = np.random.default_rng(5)
    pts = rng.normal(scale=1.5, size=(40, 3)) + [0.0, 0.0, 1.5]
    tol = 1e-12
    assert_close(TC.evaluate_aos(tp.ao_basis.shells, pts),
                 JC.evaluate_aos(jp.ao_basis.shells, pts), tol)
    assert_close(TC.density_values(ta, pts, g, U),
                 JC.density_values(ja, pts, g, U), tol)
    assert_close(TC.density_values(ta, pts, r.spin_density_spatial, U,
                                   spin=True),
                 JC.density_values(ja, pts, r.spin_density_spatial, U,
                                   spin=True), tol)
    assert_close(TC.orbital_values(tp, pts, tp.mo_coeff_ao[:, :3]),
                 JC.orbital_values(jp, pts, jp.mo_coeff_ao[:, :3]), tol)
    assert_close(TC.esp_values(ta, pts[:6], g, U),
                 JC.esp_values(ja, pts[:6], g, U), tol)
    assert_close(TC.esp_charges(tp, points_per_shell=12),
                 JC.esp_charges(jp, points_per_shell=12), tol)
    origin, axes, shape = ([-2.0, -2.0, -2.0], np.diag([0.5, 0.6, 0.7]),
                           (5, 4, 7))
    grid = TC.grid_points(origin, axes, shape)
    assert_close(grid, JC.grid_points(origin, axes, shape), tol)
    rho = TC.density_values(ta, grid, g, U)
    path = str(tmp_path / "rho.cube")
    TC.write_cube(path, ta, rho, origin, axes, shape)
    back, ref = TC.read_cube(path), JC.read_cube(path)
    assert_close(back, ref, tol)
    # 5 significant digits on the page
    np.testing.assert_allclose(back["values"], rho, rtol=1e-5, atol=1e-12)
    assert back["shape"] == shape
    np.testing.assert_allclose(back["coords"], ta.ao_basis.coords,
                               atol=1e-6)
    out_t = TC.cube_density(ta, str(tmp_path / "t.cube"), g, U,
                            spacing=0.6, margin=3.0)
    out_j = JC.cube_density(ja, str(tmp_path / "j.cube"), g, U,
                            spacing=0.6, margin=3.0)
    assert_close(out_t, out_j, tol)


# -- geometry drivers ----------------------------------------------------

def _model_energy(atom):
    """A Morse pair potential of the geometry (Hartree, bohr)."""
    symbols, R = TGEO.parse_geometry(atom)
    e = 0.0
    for i in range(len(symbols)):
        for j in range(i):
            r = np.linalg.norm(R[i] - R[j])
            e += 0.17 * (1.0 - np.exp(-1.1 * (r - 1.5 - 0.3 * (i + j))))**2
    return e


def _model_dipole(atom):
    symbols, R = TGEO.parse_geometry(atom)
    q = np.array([0.3, -0.5, 0.2][:len(symbols)])
    return q @ R + 0.01 * R[0] * np.linalg.norm(R[1] - R[0]) ** 2


def _model_alpha(atom):
    symbols, R = TGEO.parse_geometry(atom)
    d = R[-1] - R[0]
    return np.eye(3) * 5.0 + 0.2 * np.outer(d, d)


def test_geometry_finite_differences_match_jax():
    """The finite-difference drivers on model surfaces: the same code
    paths, no solver."""
    atom = "O 0 0 0; H 0 0.76 0.59; H 0 -0.76 0.59"
    assert_close(TC.nuclear_gradient(atom, _model_energy),
                 JC.nuclear_gradient(atom, _model_energy))
    assert_close(TC.hessian(atom, _model_energy),
                 JC.hessian(atom, _model_energy))
    ft = TC.harmonic_frequencies(atom, _model_energy)
    fj = JC.harmonic_frequencies(atom, _model_energy)
    assert_close(ft, fj)
    assert_close(TC.dipole_derivatives(atom, _model_dipole),
                 JC.dipole_derivatives(atom, _model_dipole))
    assert_close(TC.ir_intensities(atom, _model_dipole, ft),
                 JC.ir_intensities(atom, _model_dipole, fj))
    assert_close(TC.raman_activities(atom, _model_alpha, ft),
                 JC.raman_activities(atom, _model_alpha, fj))
    assert_close(TC.optimize_geometry(atom, _model_energy),
                 JC.optimize_geometry(atom, _model_energy))

    def saddle(a):                     # a maximum along one bond
        return -_model_energy(a)
    diatomic = "H 0 0 0; H 0 0 0.83"
    ts_t = TC.optimize_transition_state(diatomic, saddle)
    ts_j = JC.optimize_transition_state(diatomic, saddle)
    assert_close(ts_t, ts_j)
    mode = ts_t["frequencies"]["modes"][0]
    for direction in (+1, -1):
        assert_close(TC.reaction_path(ts_t["atom"], saddle, mode, direction,
                                      max_steps=3),
                     JC.reaction_path(ts_j["atom"], saddle, mode, direction,
                                      max_steps=3))
    assert_close(TC.counterpoise_interaction("H 0 0 0", "He 0 0 2.5",
                                             _model_energy_ghost),
                 JC.counterpoise_interaction("H 0 0 0", "He 0 0 2.5",
                                             _model_energy_ghost))


def _model_energy_ghost(atom):
    """The model energy with ghost atoms counted at a tenth."""
    n_ghost = sum(p.split()[0].startswith("@") for p in atom.split(";"))
    return _model_energy(atom.replace("@", "")) - 0.01 * n_ghost


@pytest.mark.parametrize("atom", [H2_GEOM, LIH_GEOM], ids=["h2", "lih"])
def test_casscf_energy_and_gradient_match_jax(atom):
    te = TC.casscf_energy_fn("sto-3g", device="cpu")
    je = JC.casscf_energy_fn("sto-3g")
    assert te(atom) == pytest.approx(je(atom), abs=1e-8)
    np.testing.assert_allclose(TC.nuclear_gradient(atom, te),
                               JC.nuclear_gradient(atom, je), rtol=0,
                               atol=1e-8)


def test_solver_backed_surfaces_match_jax():
    """casscf_dipole_fn, casscf_polarizability_fn (alpha_zz),
    casscf_state_energy_fn and ccsd_energy_fn on HeH+ STO-3G."""
    atom = "He 0 0 0; H 0 0 0.774"
    kw = dict(charge=1)
    pairs = [
        (TC.casscf_dipole_fn("sto-3g", device="cpu", **kw),
         JC.casscf_dipole_fn("sto-3g", **kw), 1e-7),
        (TC.casscf_polarizability_fn("sto-3g", components=[(2, 2)],
                                     device="cpu", **kw),
         JC.casscf_polarizability_fn("sto-3g", components=[(2, 2)], **kw),
         1e-4),
        (TC.casscf_state_energy_fn("sto-3g", state=1, device="cpu", **kw),
         JC.casscf_state_energy_fn("sto-3g", state=1, **kw), 1e-8),
        (TC.ccsd_energy_fn("sto-3g", device="cpu", **kw),
         JC.ccsd_energy_fn("sto-3g", **kw), 1e-10)]
    for t, j, tol in pairs:
        np.testing.assert_allclose(t(atom), j(atom), rtol=0, atol=tol)


def test_geometry_drivers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (TC.casscf_energy_fn, TC.casscf_dipole_fn,
                 TC.casscf_polarizability_fn, TC.casscf_state_energy_fn,
                 TC.ccsd_energy_fn):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make("sto-3g")


def test_optimize_geometry_h2_lands_in_the_jax_window():
    """tests/test_geometry.py:115-128 through the port."""
    energy = TC.casscf_energy_fn(basis="sto-3g", device="cpu")
    res = TC.optimize_geometry("H 0 0 0; H 0 0 0.90", energy)
    assert res["converged"]
    r = np.linalg.norm(res["coords"][1] - res["coords"][0])
    assert 1.30 < r < 1.45
    assert np.abs(res["gradient"]).max() < 3e-4
    symbols, coords = TGEO.parse_geometry(res["atom"])
    for d in (+0.02, -0.02):
        c = coords.copy()
        c[1, 2] += d
        assert energy(TC.geometry_string(symbols, c)) > res["energy"]
