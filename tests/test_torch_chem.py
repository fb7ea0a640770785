"""esoo_torch.chem ingestion against esoo_tpu.chem, float64 on the CPU:
basis tables and shells (chem/basis.py, chem/gbs.py), integrals and
multipoles (chem/integrals.py), the driver, active spaces and AO metadata
(chem/driver.py), FCIDUMP (chem/fcidump.py) and problem_from_numpy
(convert.py).

Both packages run the same NumPy/SciPy/LAPACK calls on the same inputs,
so the driver's tensors are compared bit for bit; integrals and moments
of the two engines to atol 1e-12.  The literature anchors are the JAX
package's own (tests/test_basis_universal.py)."""

import dataclasses
import os

import numpy as np
import pytest

import esoo_torch.chem as TC
import esoo_tpu.chem as JC
from esoo_torch.chem import basis as TB, gbs as TG
from esoo_torch.chem.integrals import IntegralEngine as TEngine
from esoo_torch.convert import problem_from_numpy
from esoo_tpu.chem import basis as JB, gbs as JG
from esoo_tpu.chem.integrals import IntegralEngine as JEngine
from test_torch_engine import same_eri_engine  # noqa: F401

H2O_GEOM = ("O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692")
H2S_GEOM = "S 0 0 0; H 0 0.9617 0.9269; H 0 -0.9617 0.9269"
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "h2s_effective_core.fcidump")

# (atom, basis, spin) of the driver comparisons
DRIVER_CASES = {
    "h2o_ccpvdz": (H2O_GEOM, "cc-pvdz", 0),
    "c_ccpvdz_triplet": ("C 0 0 0", "cc-pvdz", 2),
    "he_ghost_he": ("He 0 0 0; @He 0 0 3.0", "cc-pvdz", 0),
}
_PROBLEMS = {}


def _problems(case):
    """(port problem, JAX problem) of a DRIVER_CASES entry, built once."""
    if case not in _PROBLEMS:
        atom, basis, spin = DRIVER_CASES[case]
        _PROBLEMS[case] = (
            TC.MoleculeDriver(atom, basis=basis, spin=spin).run(),
            JC.MoleculeDriver(atom, basis=basis, spin=spin).run())
    return _PROBLEMS[case]


def _assert_fields_equal(tp, jp, names):
    for k in names:
        a, b = getattr(tp, k), getattr(jp, k)
        if a is None or b is None:
            assert a is None and b is None, k
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k


_PROBLEM_ARRAYS = ("hcore_mo", "eri_mo", "dipole_mo", "nuclear_dipole",
                   "dipole_core", "quadrupole_mo", "quadrupole_core",
                   "mo_coeff_ao", "density_core_ao")
_PROBLEM_SCALARS = ("num_particles", "num_spatial_orbitals",
                    "nuclear_repulsion_energy", "core_energy", "atom",
                    "basis")


def _assert_problems_equal(tp, jp):
    _assert_fields_equal(tp, jp, _PROBLEM_ARRAYS + _PROBLEM_SCALARS)
    ta, ja = tp.ao_basis, jp.ao_basis
    for k in ("overlap", "ao_atoms", "atomic_numbers", "coords"):
        np.testing.assert_array_equal(getattr(ta, k), getattr(ja, k),
                                      err_msg=k)
    assert ta.symbols == ja.symbols
    _assert_shells_equal(ta.shells, ja.shells)


def _assert_shells_equal(ts, js):
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        assert (a.l, a.pure) == (b.l, b.pure)
        for k in ("center", "exps", "coeffs", "cnorm"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# -- basis library -------------------------------------------------------

def test_basis_tables_match_jax():
    assert set(TB.BASIS_SETS) == set(JB.BASIS_SETS)
    for name, table in JB.BASIS_SETS.items():
        assert set(TB.BASIS_SETS[name]) == set(table), name
        for el, shells in table.items():
            assert TB.BASIS_SETS[name][el] == shells, (name, el)
    assert TB.ATOMIC_NUMBERS == JB.ATOMIC_NUMBERS
    assert TB.ATOMIC_NUMBERS["Kr"] == 36
    assert TB.ANGSTROM_TO_BOHR == JB.ANGSTROM_TO_BOHR
    # Pople polarization d is cartesian (6d)
    d = [sh for sh in TB.BASIS_SETS["6-31g*"]["O"] if sh["l"] == 2]
    assert len(d) == 1 and d[0]["pure"] is False
    for sym in ("@He", "ghost:He", "He"):
        assert TB.is_ghost(sym) == JB.is_ghost(sym)
        assert TB.element_symbol(sym) == JB.element_symbol(sym) == "He"


@pytest.mark.parametrize("case", ["ghost", "pople_631g_star", "gbs_file"])
def test_build_shells_match_jax(case, tmp_path):
    if case == "ghost":
        atom, basis = "He 0 0 0; @He 0 0 3.0", "cc-pvdz"
    elif case == "pople_631g_star":
        atom, basis = H2O_GEOM, "6-31g*"
    else:
        atom = "N 0 0 0; N 0 0 1.0977"
        basis = str(tmp_path / "n.gbs")
        text = TG.format_gbs({"N": TB.BASIS_SETS["cc-pvdz"]["N"]})
        assert text == JG.format_gbs({"N": JB.BASIS_SETS["cc-pvdz"]["N"]})
        with open(basis, "w") as f:
            f.write(text)
        assert TG.load_gbs(basis) == JG.load_gbs(basis)
    ts, tsym, tc = TB.build_shells(atom, basis)
    js, jsym, jc = JB.build_shells(atom, basis)
    assert tsym == jsym
    np.testing.assert_array_equal(tc, jc)
    _assert_shells_equal(ts, js)
    if case == "pople_631g_star":
        assert [sh.nfunc for sh in ts if sh.l == 2] == [6]


def test_gbs_parser_and_errors_match_jax():
    for name in ("sto-3g", "6-31g", "6-31g**", "cc-pvdz", "cc-pvtz"):
        text = TG.format_gbs(TB.BASIS_SETS[name])
        assert TG.parse_gbs(text) == JG.parse_gbs(text)
    with pytest.raises(ValueError, match="no basis entries"):
        TG.parse_gbs("! nothing here\n****\n")
    with pytest.raises(ValueError, match="unrecognized shell"):
        TG.parse_gbs("****\nH 0\nQ 1 1.00\n 1.0 1.0\n****\n")
    with pytest.raises(ValueError, match="gbs"):
        TB.build_shells("H 0 0 0", "no-such-basis")


# -- integrals and multipoles --------------------------------------------

@pytest.mark.parametrize("atom,basis", [
    ("H 0 0 0; Cl 0 0 1.2746", "sto-3g"),
    (H2O_GEOM, "6-31g*"),
    ("Li 0 0 0; H 0 0 1.5949", "cc-pvdz")], ids=["hcl", "h2o", "lih"])
def test_integrals_and_moments_match_jax(atom, basis):
    shells, symbols, coords = TB.build_shells(atom, basis)
    jshells = JB.build_shells(atom, basis)[0]
    charges = np.array([TB.ATOMIC_NUMBERS[s] for s in symbols], float)
    te, je = (TEngine(shells, charges, coords),
              JEngine(jshells, charges, coords))
    assert te.nbf == je.nbf
    for out, ref in zip(te.one_electron(), je.one_electron()):
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(te.eri(), je.eri(), rtol=0, atol=1e-12)
    origin = (0.1, -0.2, 0.3)
    for name in ("dipole", "quadrupole"):
        for o in ((0.0, 0.0, 0.0), origin):
            out = getattr(te, name)(o)
            np.testing.assert_allclose(out, getattr(je, name)(o), rtol=0,
                                       atol=1e-12)
            assert np.allclose(out, out.transpose(0, 2, 1), atol=1e-14)
    assert TEngine.QUAD_COMPS == JEngine.QUAD_COMPS
    # the origin shift of a dipole is the overlap: <r - o> = <r> - o S
    S = te.one_electron()[0]
    np.testing.assert_allclose(
        te.dipole(origin), te.dipole() - np.asarray(origin)[:, None, None]
        * S, atol=1e-12)


# -- driver, active spaces, FCIDUMP --------------------------------------

@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_driver_matches_jax(case):
    tp, jp = _problems(case)
    for k in ("energy_total", "energy_electronic", "nuclear_repulsion",
              "converged", "n_iter"):
        assert getattr(tp.scf, k) == getattr(jp.scf, k), k
    np.testing.assert_array_equal(tp.scf.mo_coeff, jp.scf.mo_coeff)
    np.testing.assert_array_equal(tp.scf.mo_energy, jp.scf.mo_energy)
    _assert_problems_equal(tp, jp)
    assert tp.eri_engine in ("native", "python")
    for a, b in zip(tp.spatial_integral_tensors(),
                    jp.spatial_integral_tensors()):
        np.testing.assert_array_equal(a, b)
    if case == "he_ghost_he":
        assert tp.num_particles == (1, 1)
        assert tp.nuclear_repulsion_energy == 0.0
        assert tp.ao_basis.atomic_numbers.tolist() == [2, 0]


@pytest.mark.parametrize("window", [{}, {"n_frozen": 1},
                                    {"n_frozen": 1, "n_active_orbitals": 6},
                                    {"n_frozen": 0, "n_active_orbitals": 9}],
                         ids=["auto", "n_frozen", "window", "virtuals"])
def test_active_space_matches_jax(window):
    tp, jp = _problems("h2o_ccpvdz")
    ta, ja = tp.active_space(**window), jp.active_space(**window)
    _assert_problems_equal(ta, ja)
    assert ta.eri_engine == tp.eri_engine
    # the HF energy is the core energy plus the active HF determinant's
    na = ta.num_particles[0]
    h, eri = ta.hcore_mo, ta.eri_mo
    e_act = (2 * np.trace(h[:na, :na])
             + 2 * np.einsum("iijj->", eri[:na, :na, :na, :na])
             - np.einsum("ijji->", eri[:na, :na, :na, :na]))
    np.testing.assert_allclose(e_act + ta.core_energy,
                               tp.scf.energy_electronic, atol=1e-10)
    # a second reduction accumulates the frozen core as the JAX one does
    if window.get("n_frozen") == 1:
        _assert_problems_equal(ta.active_space(n_frozen=1),
                               ja.active_space(n_frozen=1))
    with pytest.raises(ValueError, match="cannot freeze"):
        tp.active_space(n_frozen=6)
    with pytest.raises(ValueError, match="out of range"):
        tp.active_space(n_frozen=1, n_active_orbitals=100)


def test_fcidump_round_trips_and_reads_match_jax(tmp_path):
    tp, jp = _problems("h2o_ccpvdz")
    ta = tp.active_space(n_frozen=1, n_active_orbitals=6)
    ja = jp.active_space(n_frozen=1, n_active_orbitals=6)
    ft, fj = str(tmp_path / "t.fcidump"), str(tmp_path / "j.fcidump")
    TC.write_fcidump(ta, ft)
    JC.write_fcidump(ja, fj)
    with open(ft) as a, open(fj) as b:
        assert a.read() == b.read()
    for path in (ft, FIXTURE):
        tr, jr = TC.read_fcidump(path), JC.read_fcidump(path)
        _assert_fields_equal(tr, jr, ("hcore_mo", "eri_mo", "num_particles",
                                      "num_spatial_orbitals",
                                      "nuclear_repulsion_energy", "atom"))
    back = TC.read_fcidump(ft)
    np.testing.assert_allclose(back.hcore_mo, ta.hcore_mo, atol=1e-14)
    np.testing.assert_allclose(back.eri_mo, ta.eri_mo, atol=1e-14)
    assert back.nuclear_repulsion_energy == pytest.approx(
        ta.nuclear_repulsion_energy + ta.core_energy, abs=1e-12)


@pytest.mark.parametrize("case", ["h2o_ccpvdz", "he_ghost_he"])
def test_problem_from_numpy_round_trips(case):
    tp, jp = _problems(case)
    ja = jp.active_space()
    for src, ref in ((jp, tp), (ja, tp.active_space())):
        fields = dataclasses.asdict(src)
        got = problem_from_numpy(fields)
        assert type(got) is TC.ElectronicStructureProblem
        _assert_problems_equal(got, src)
        _assert_fields_equal(got, ref, _PROBLEM_ARRAYS + _PROBLEM_SCALARS)
        np.testing.assert_array_equal(got.scf.mo_coeff, src.scf.mo_coeff)
    # the port's own fields (eri_engine too) and the dataclasses as they are
    again = problem_from_numpy(dataclasses.asdict(tp))
    assert again.eri_engine == tp.eri_engine
    kept = problem_from_numpy({f.name: getattr(jp, f.name)
                               for f in dataclasses.fields(jp)})
    _assert_problems_equal(kept, jp)
    with pytest.raises(TypeError):
        problem_from_numpy({**dataclasses.asdict(jp), "no_such_field": 1})


# -- the JAX package's tier-1 literature anchors --------------------------

def test_h2s_sto3g_rhf_literature():
    """tests/test_basis_universal.py:99-101: H2S STO-3G RHF = -394.3116."""
    p = TC.MoleculeDriver(atom=H2S_GEOM, basis="sto-3g").run()
    np.testing.assert_allclose(
        p.scf.energy_electronic + p.nuclear_repulsion_energy, -394.3116,
        atol=5e-4)
    a = p.active_space()               # auto core: S -> 5 frozen
    assert a.num_particles == (4, 4) and a.num_spatial_orbitals == 6


def test_c_atom_ccpvtz_rohf_literature():
    """tests/test_basis_universal.py:146-147: C cc-pVTZ triplet ROHF."""
    p = TC.MoleculeDriver(atom="C 0 0 0", basis="cc-pvtz", spin=2).run()
    np.testing.assert_allclose(p.scf.energy_electronic, -37.6867, atol=3e-4)


@pytest.mark.slow
def test_n2_ccpvtz_rhf_literature():
    """tests/test_basis_universal.py:138-142 (slow there too)."""
    p = TC.MoleculeDriver(atom="N 0 0 0; N 0 0 1.0977",
                          basis="cc-pvtz").run()
    np.testing.assert_allclose(
        p.scf.energy_electronic + p.nuclear_repulsion_energy, -108.9835,
        atol=5e-4)
    a = p.active_space()
    assert a.num_particles == (5, 5) and a.num_spatial_orbitals == 58


@pytest.mark.slow
def test_h2_ccpvqz_driver_matches_jax():
    """cc-pVQZ (f shells, 120 spin orbitals; tests/test_chem.py:90 is slow
    there too): the two drivers agree bit for bit."""
    atom = "H 0 0 0; H 0 0 0.735"
    tp = TC.MoleculeDriver(atom=atom, basis="cc-pvqz").run()
    jp = JC.MoleculeDriver(atom=atom, basis="cc-pvqz").run()
    assert tp.num_spin_orbitals == 120
    _assert_problems_equal(tp, jp)
