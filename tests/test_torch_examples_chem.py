"""The chemistry workflows' example twins (examples/torch_*.py: a .gbs
basis, the method ladder, the dissociation curve, spectroscopy and
thermochemistry, the LiH spectrum, geometry optimizations, frequencies
and a transition state) on the CPU (`--device cpu`), gated by
chip_smoke.py's example_gates as tests/test_torch_examples.py gates the
others: tests/test_examples.py's anchors of the JAX examples, and the
twin's numbers against its JAX example's run here (jax_example, whose
recorder prints them: `python tests/test_torch_examples.py NAME`)."""

import pytest

from test_torch_examples import SMOKE, gate_twin, jax_example

# expressions over each JAX example's names: the numbers it prints
RECORD = {
    "Custom_Basis_GBS": {"file": "p_file.scf.energy_total",
                         "table": "p_table.scf.energy_total"},
    "H2O_Method_Ladder": {"rows": "dict(rows)",
                          "e_corr_exact": "e_corr_exact"},
    "H2_Dissociation_Curve": {"e_h": "e_h",
                              "rows": "[list(row) for row in rows]"},
    "H2_Spectroscopy_Thermo": {
        "energy": "res['energy']", "nu": "nu", "ir": "ir[k]",
        "raman": "acts[k]", "depol": "depol[k]", "zpe": "t['zpe']",
        "entropy": "t['entropy_J_mol_K']", "enthalpy": "t['enthalpy']",
        "gibbs": "t['gibbs_free_energy']"},
    "LiH_Spectrum_Properties": {
        "hf_dipole": "dipole_moment(problem, unit='debye')[2]",
        "eigenvalues": "list(res.eigenvalues)",
        "spin_squared": "list(res.spin_squared)",
        "mu_z": "[mu[i, i, 2] for i in range(4)]",
        "f": "[f[0, i] for i in range(4)]", "triplets": "triplets",
        "singlets": "singlets", "f_allowed": "f[0, singlets[0]]"},
    "LiH_Geometry_Optimization": {
        "r_bohr": "r_bohr", "energy": "res['energy']",
        "n_iterations": "res['n_iterations']", "mu_z": "mu[2]",
        "charges": "[q[0], q[1]]"},
    "H2O_Geometry_Frequencies": {
        "energy": "res['energy']",
        "r_oh": "[r1 * 0.52917721092, r2 * 0.52917721092]",
        "angle": "angle", "modes": "sorted(f[-3:])"},
    "H3_Reaction_Barrier": {
        "r_ts": "r", "ts_energy": "ts['energy']", "barrier": "barrier",
        "zpe_corrected": "zpe_corr", "modes": "sorted(vib)", "dg": "dg"},
}

FAST = ["Custom_Basis_GBS", "H2O_Method_Ladder", "H2_Dissociation_Curve",
        "H2_Spectroscopy_Thermo", "LiH_Spectrum_Properties"]


def test_custom_basis_gbs_twin():
    gate_twin("Custom_Basis_GBS")


def test_h2o_method_ladder_twin():
    gate_twin("H2O_Method_Ladder")


def test_h2_dissociation_curve_twin():
    gate_twin("H2_Dissociation_Curve")


def test_h2_spectroscopy_thermo_twin():
    gate_twin("H2_Spectroscopy_Thermo")


def test_lih_spectrum_properties_twin():
    gate_twin("LiH_Spectrum_Properties")


@pytest.mark.slow
def test_lih_geometry_optimization_twin():
    gate_twin("LiH_Geometry_Optimization")


@pytest.mark.slow
def test_h2o_geometry_frequencies_twin():
    gate_twin("H2O_Geometry_Frequencies")


@pytest.mark.slow
def test_h3_reaction_barrier_twin():
    gate_twin("H3_Reaction_Barrier")


@pytest.mark.parametrize("name", [
    pytest.param(name, marks=() if name in FAST else pytest.mark.slow)
    for name in RECORD])
def test_jax_example_as_recorded(name):
    """chip_smoke.py's JAX_EXAMPLES[name] are what the JAX example gives
    here, at the tolerances its twin is held to."""
    assert SMOKE.example_parity(name, jax_example(name),
                                SMOKE.JAX_EXAMPLES[name]) == []
