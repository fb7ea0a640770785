"""The PyTorch port's twin of H3_OpenShell_OptOrbVQE.py: open-shell
OptOrbVQE on the linear H3 doublet (spin = 1), 6-31G reduced to 6 spin
orbitals, through the reference's class-based API.

    python examples/torch_H3_OpenShell_OptOrbVQE.py                # the card
    python examples/torch_H3_OpenShell_OptOrbVQE.py --device cpu   # the host

ROHF gives one common set of spatial orbitals, and the OptOrb partial
unitary U is spatial and spin-expanded by block_diag: the structure ROHF
preserves.
"""

import argparse

import numpy as np

from esoo_torch import (Estimator, HartreeFock, L_BFGS_B, OptOrbVQE,
                        PartialUnitaryProjectionOptimizer, UCCSD, VQE)
from esoo_torch.chem import MoleculeDriver
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    problem = MoleculeDriver(atom="H 0 0 0; H 0 0 0.9; H 0 0 1.8",
                             basis="6-31g", spin=1).run()
    print(f"ROHF total energy: {problem.scf.energy_total:.6f} Ha, "
          f"(n_alpha, n_beta) = {problem.num_particles}")

    num_reduced_spin_orbitals = 6
    n_act = num_reduced_spin_orbitals // 2
    parts = problem.num_particles   # (2, 1)

    ansatz = UCCSD(n_act, parts, initial_state=HartreeFock(n_act, parts))
    vqe = VQE(Estimator(device=device), ansatz, L_BFGS_B(maxiter=300),
              initial_point=np.zeros(ansatz.num_parameters), device=device)
    pupo = PartialUnitaryProjectionOptimizer(
        initial_BBstepsize=1e-3, stopping_tolerance=1e-5, maxiter=10000,
        device=device)

    solver = OptOrbVQE(num_spin_orbitals=num_reduced_spin_orbitals,
                       ground_state_solver=vqe,
                       partial_unitary_optimizer=pupo,
                       problem=problem, maxiter=15, device=device)
    result = solver.compute_minimum_energy()

    print(f"OptOrbVQE electronic energy (6-31G -> 6 so): "
          f"{float(result.eigenvalue):.8f} Ha")
    print("(full STO-3G FCI in the same sector is -3.0399 Ha electronic; "
          "the larger starting basis wins)")
    return {"rohf_total": float(problem.scf.energy_total),
            "eigenvalue": float(result.eigenvalue)}


if __name__ == "__main__":
    main()
