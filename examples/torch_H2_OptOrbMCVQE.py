"""The PyTorch port's twin of H2_OptOrbMCVQE.py: OptOrbMCVQE on H2, two
CIS-initialized states, 6-31G -> 4 spin orbitals, through the
reference's class-based API.

    python examples/torch_H2_OptOrbMCVQE.py                # the card
    python examples/torch_H2_OptOrbMCVQE.py --device cpu   # the host
"""

import argparse

import numpy as np

from esoo_torch import (Estimator, L_BFGS_B, MCVQE, OptOrbMCVQE,
                        PartialUnitaryProjectionOptimizer, UCCSD)
from esoo_torch.chem import MoleculeDriver
from esoo_torch.ops import JordanWignerMapper
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    estimator = Estimator(approximation=True, device=device)
    mapper = JordanWignerMapper()

    q_molecule = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735",
                                basis="6-31G").run()
    num_particles = q_molecule.num_particles
    num_reduced_spin_orbitals = 4
    k = 2

    ansatz = UCCSD(num_spatial_orbitals=num_reduced_spin_orbitals // 2,
                   num_particles=num_particles, reps=2)

    partial_unitary_optimizer = PartialUnitaryProjectionOptimizer(
        initial_BBstepsize=10**-3, stopping_tolerance=10**-5, maxiter=10000,
        device=device)

    mcvqe_instance = MCVQE(k=k,
                           ansatz=ansatz,
                           excitations="s",
                           num_particles=num_particles,
                           initial_point=np.zeros(ansatz.num_parameters),
                           optimizer=L_BFGS_B(),
                           estimator=estimator,
                           device=device)

    optorbmcvqe_instance = OptOrbMCVQE(
        num_spin_orbitals=num_reduced_spin_orbitals,
        excited_states_solver=mcvqe_instance,
        mapper=mapper,
        estimator=estimator,
        partial_unitary_optimizer=partial_unitary_optimizer,
        problem=q_molecule,
        maxiter=20,
        wavefuntion_real=True,
        spin_conserving=True,
        device=device)

    result = optorbmcvqe_instance.compute_energies()
    print(f"Orbital-optimized energies: {result.eigenvalues} Ha "
          f"(4 spin-orbitals)")
    return {"eigenvalues": [float(e) for e in result.eigenvalues]}


if __name__ == "__main__":
    main()
