"""The PyTorch port's twin of H4_OptOrbVQE.py: OptOrbVQE on an H4 chain,
cc-pVTZ (112 spin orbitals) -> 8 spin orbitals, through the reference's
class-based API: the larger-M configuration, the two-electron transform
at scale.

    python examples/torch_H4_OptOrbVQE.py                # the card
    python examples/torch_H4_OptOrbVQE.py --device cpu   # the host
"""

import argparse

import numpy as np

from esoo_torch import (Estimator, HartreeFock, L_BFGS_B, OptOrbVQE,
                        PartialUnitaryProjectionOptimizer, UCCSD, VQE)
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

    bond = 1.23
    q_molecule = MoleculeDriver(
        atom="; ".join(f"H 0 0 {n * bond}" for n in range(4)),
        basis="cc-pVTZ").run()
    num_particles = q_molecule.num_particles
    num_reduced_spin_orbitals = 8

    HF_state = HartreeFock(
        num_spatial_orbitals=num_reduced_spin_orbitals // 2,
        num_particles=num_particles)
    ansatz = UCCSD(num_spatial_orbitals=num_reduced_spin_orbitals // 2,
                   num_particles=num_particles,
                   initial_state=HF_state)

    partial_unitary_optimizer = PartialUnitaryProjectionOptimizer(
        initial_BBstepsize=10**-3, stopping_tolerance=10**-5, maxiter=10000,
        device=device)

    vqe_instance = VQE(ansatz=ansatz,
                       initial_point=np.zeros(ansatz.num_parameters),
                       optimizer=L_BFGS_B(),
                       estimator=estimator,
                       device=device)

    optorbvqe_instance = OptOrbVQE(
        num_spin_orbitals=num_reduced_spin_orbitals,
        ground_state_solver=vqe_instance,
        mapper=mapper,
        estimator=estimator,
        partial_unitary_optimizer=partial_unitary_optimizer,
        problem=q_molecule,
        maxiter=20,
        wavefuntion_real=True,
        spin_conserving=True,
        device=device)

    result = optorbvqe_instance.compute_minimum_energy()
    print(f"Orbital-optimized ground state energy: {result.eigenvalue} Ha "
          f"({num_reduced_spin_orbitals} spin-orbitals)")
    return {"eigenvalue": float(result.eigenvalue)}


if __name__ == "__main__":
    main()
