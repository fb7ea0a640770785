"""The PyTorch port's twin of N2_ccpVDZ_CASSCF_UCC.py: N2 cc-pVDZ with
two frozen N 1s cores, its 52-spin-orbital valence space reduced to 16
(10 electrons in 8 optimized spatial orbitals, a 3,136-determinant
sector), solved by both eigensolver families.

    python examples/torch_N2_ccpVDZ_CASSCF_UCC.py                # the card
    python examples/torch_N2_ccpVDZ_CASSCF_UCC.py --device cpu   # the host

FusedOptOrbCASSCF (exact string-CI Davidson, the variational upper
baseline) and FusedOptOrbVQE with the string-factorized sector UCC
simulator (UCCSD, 315 parameters) at the same shape.  Anchors (float64,
tests/test_n2_showcase.py): RHF/cc-pVDZ total -108.954128 Ha,
OptOrb-CASSCF -109.102359 Ha, OptOrb-UCCSD -109.100871 Ha.
"""

import argparse
import time

import numpy as np

from esoo_torch import FusedOptOrbCASSCF, FusedOptOrbVQE, HartreeFock, UCCSD
from esoo_torch.chem import MoleculeDriver
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    problem = MoleculeDriver(atom="N 0 0 0; N 0 0 1.0977",
                             basis="cc-pvdz").run()
    rhf_total = (problem.scf.energy_electronic
                 + problem.nuclear_repulsion_energy)
    print(f"N2 RHF/cc-pVDZ total: {rhf_total:.6f} Ha")

    active = problem.active_space()        # auto: 2 frozen N 1s cores
    offset = active.core_energy + problem.nuclear_repulsion_energy
    print(f"active space: {active.num_particles} electrons in "
          f"{active.num_spatial_orbitals} spatial orbitals")

    t0 = time.perf_counter()
    cas = FusedOptOrbCASSCF(num_spin_orbitals=16, problem=active,
                            maxiter=12, stopping_tolerance=1e-6,
                            device=device).compute_minimum_energy()
    cas_s = time.perf_counter() - t0
    print(f"OptOrb-CASSCF (52 -> 16 so): {cas.eigenvalue + offset:.6f} Ha "
          f"({cas.outer_iterations} outers, {cas_s:.1f} s)")

    ansatz = UCCSD(8, active.num_particles,
                   initial_state=HartreeFock(8, active.num_particles))
    t0 = time.perf_counter()
    ucc = FusedOptOrbVQE(num_spin_orbitals=16, ansatz=ansatz, problem=active,
                         maxiter=10, stopping_tolerance=1e-5,
                         simulation="sector",
                         device=device).compute_minimum_energy()
    ucc_s = time.perf_counter() - t0
    print(f"OptOrb-UCCSD  (52 -> 16 so): {ucc.eigenvalue + offset:.6f} Ha "
          f"({ucc.outer_iterations} outers, {ucc_s:.1f} s)")
    print(f"UCCSD vs exact active space: "
          f"{(ucc.eigenvalue - cas.eigenvalue) * 1e3:+.3f} mHa")

    occ = cas.natural_occupations
    if occ is not None:
        print("CASSCF natural occupations:",
              np.round(np.asarray(occ).ravel()[:8], 4))
    return {"rhf_total": float(rhf_total),
            "casscf_total": float(cas.eigenvalue + offset),
            "casscf_outer_iterations": cas.outer_iterations,
            "casscf_s": cas_s,
            "uccsd_total": float(ucc.eigenvalue + offset),
            "uccsd_outer_iterations": ucc.outer_iterations,
            "uccsd_s": ucc_s, "parameters": ansatz.num_parameters,
            "natural_occupations": [float(o) for o in
                                    np.asarray(occ).ravel()[:8]]}


if __name__ == "__main__":
    main()
