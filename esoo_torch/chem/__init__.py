"""Host-side chemistry (NumPy): basis sets, integrals, SCF, MO tensors,
active spaces, FCIDUMP, and the post-processing a chemist runs after a
solve (properties, MP2/CISD/CCSD, localization, geometry drivers,
thermochemistry, cube files).  Copy of esoo_tpu/chem; the geometry
drivers build this package's solvers."""

from .basis import BASIS_SETS, Shell, build_shells
from .driver import ElectronicStructureProblem, MoleculeDriver
from .cube import (cube_density, density_values, esp_charges,
                   esp_values, evaluate_aos, grid_points,
                   orbital_values, read_cube, write_cube)
from .fcidump import read_fcidump, write_fcidump
from .cc import ccsd
from .cisd import cisd
from .mp2 import mp2
from .geometry import (casscf_dipole_fn, casscf_energy_fn,
                       counterpoise_interaction,
                       ccsd_energy_fn,
                       casscf_polarizability_fn, casscf_state_energy_fn,
                       dipole_derivatives, geometry_string,
                       harmonic_frequencies, hessian, ir_intensities,
                       nuclear_gradient, optimize_geometry,
                       optimize_transition_state, raman_activities,
                       reaction_path)
from .integrals import IntegralEngine
from .localize import localize_orbitals
from .properties import (AU_TO_BUCKINGHAM, AU_TO_DEBYE, apply_field,
                         bond_orders, density_ao, dipole_moment,
                         hf_density_spatial, natural_orbitals,
                         oscillator_strengths, polarizability,
                         populations, quadrupole_moment,
                         transition_dipoles)
from .scf import rhf, rohf
from .thermo import eyring_rate, thermochemistry

__all__ = [
    "BASIS_SETS",
    "Shell",
    "build_shells",
    "ElectronicStructureProblem",
    "MoleculeDriver",
    "cube_density",
    "density_values",
    "esp_charges",
    "esp_values",
    "evaluate_aos",
    "grid_points",
    "orbital_values",
    "read_cube",
    "write_cube",
    "ccsd",
    "cisd",
    "mp2",
    "read_fcidump",
    "write_fcidump",
    "IntegralEngine",
    "AU_TO_BUCKINGHAM",
    "AU_TO_DEBYE",
    "apply_field",
    "bond_orders",
    "density_ao",
    "polarizability",
    "quadrupole_moment",
    "dipole_moment",
    "hf_density_spatial",
    "natural_orbitals",
    "oscillator_strengths",
    "populations",
    "transition_dipoles",
    "casscf_dipole_fn",
    "casscf_energy_fn",
    "casscf_polarizability_fn",
    "casscf_state_energy_fn",
    "ccsd_energy_fn",
    "counterpoise_interaction",
    "dipole_derivatives",
    "ir_intensities",
    "geometry_string",
    "harmonic_frequencies",
    "hessian",
    "nuclear_gradient",
    "optimize_geometry",
    "optimize_transition_state",
    "raman_activities",
    "reaction_path",
    "rhf",
    "rohf",
    "thermochemistry",
    "localize_orbitals",
    "eyring_rate",
]
