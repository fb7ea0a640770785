"""Host-side chemistry ingestion: basis sets, integrals, SCF, MO tensors."""

from .basis import BASIS_SETS, Shell, build_shells
from .driver import ElectronicStructureProblem, MoleculeDriver
from .integrals import IntegralEngine
from .scf import rhf, rohf

__all__ = ["BASIS_SETS", "ElectronicStructureProblem", "IntegralEngine",
           "MoleculeDriver", "Shell", "build_shells", "rhf", "rohf"]
