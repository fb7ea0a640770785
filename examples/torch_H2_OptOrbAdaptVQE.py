"""The PyTorch port's twin of H2_OptOrbAdaptVQE.py: OptOrbAdaptVQE on H2,
the ansatz grown from a pool, 6-31G -> 4 spin orbitals, through the
reference's class-based API.

    python examples/torch_H2_OptOrbAdaptVQE.py                # the card
    python examples/torch_H2_OptOrbAdaptVQE.py --device cpu   # the host
"""

import argparse

import numpy as np

from esoo_torch import (AdaptVQE, Estimator, HartreeFock, L_BFGS_B,
                        OptOrbAdaptVQE, PartialUnitaryProjectionOptimizer,
                        UCCSD, VQE)
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

    adapt_vqe_instance = AdaptVQE(vqe_instance)

    optorbadaptvqe_instance = OptOrbAdaptVQE(
        num_spin_orbitals=num_reduced_spin_orbitals,
        ground_state_solver=adapt_vqe_instance,
        mapper=mapper,
        estimator=estimator,
        partial_unitary_optimizer=partial_unitary_optimizer,
        problem=q_molecule,
        maxiter=20,
        wavefuntion_real=True,
        spin_conserving=True,
        device=device)

    result = optorbadaptvqe_instance.compute_minimum_energy()
    print(f"Orbital-optimized ground state energy: {result.eigenvalue} Ha "
          f"(4 spin-orbitals)")
    return {"eigenvalue": float(result.eigenvalue)}


if __name__ == "__main__":
    main()
