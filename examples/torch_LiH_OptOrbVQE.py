"""The PyTorch port's twin of LiH_OptOrbVQE.py: OptOrbVQE on LiH,
cc-pVDZ starting basis (19 spatial / 38 spin orbitals) reduced to 6
spin orbitals, through the reference's class-based API.

    python examples/torch_LiH_OptOrbVQE.py                # the card
    python examples/torch_LiH_OptOrbVQE.py --device cpu   # the host

Literature anchor: RHF/cc-pVDZ at r = 1.5949 A is -7.98368 Ha total;
full-space FCI is about -8.0087 Ha, so the reduced-space OptOrb energy
lands between them.
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

    problem = MoleculeDriver(atom="Li 0 0 0; H 0 0 1.5949",
                             basis="cc-pvdz").run()
    print(f"RHF total energy: {problem.scf.energy_total:.6f} Ha "
          f"(literature -7.98368), {problem.num_spatial_orbitals} spatial "
          f"orbitals")

    num_reduced_spin_orbitals = 6
    n_act = num_reduced_spin_orbitals // 2
    parts = problem.num_particles

    ansatz = UCCSD(n_act, parts, initial_state=HartreeFock(n_act, parts))
    vqe = VQE(Estimator(device=device), ansatz, L_BFGS_B(maxiter=300),
              initial_point=np.zeros(ansatz.num_parameters), device=device)
    pupo = PartialUnitaryProjectionOptimizer(
        initial_BBstepsize=1e-3, stopping_tolerance=1e-5, maxiter=10000,
        device=device)

    solver = OptOrbVQE(num_spin_orbitals=num_reduced_spin_orbitals,
                       ground_state_solver=vqe,
                       partial_unitary_optimizer=pupo,
                       problem=problem, maxiter=20, device=device)
    result = solver.compute_minimum_energy()

    e_total = float(result.eigenvalue) + problem.nuclear_repulsion_energy
    print(f"OptOrbVQE electronic energy: {float(result.eigenvalue):.8f} Ha")
    print(f"OptOrbVQE total energy:      {e_total:.8f} Ha")
    print(f"RHF total:                   {problem.scf.energy_total:.8f} Ha")
    print(f"correlation captured in 6 spin orbitals: "
          f"{e_total - problem.scf.energy_total:.6f} Ha")
    return {"rhf_total": float(problem.scf.energy_total),
            "eigenvalue": float(result.eigenvalue), "e_total": e_total}


if __name__ == "__main__":
    main()
