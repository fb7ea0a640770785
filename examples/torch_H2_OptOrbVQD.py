"""The PyTorch port's twin of H2_OptOrbVQD.py: OptOrbVQD on H2, two
states by deflation, 6-31G -> 4 spin orbitals, through the reference's
class-based API (one ansatz a state).

    python examples/torch_H2_OptOrbVQD.py                # the card
    python examples/torch_H2_OptOrbVQD.py --device cpu   # the host
"""

import argparse

import numpy as np

from esoo_torch import (ComputeUncompute, Estimator, HartreeFock, L_BFGS_B,
                        OptOrbVQD, PartialUnitaryProjectionOptimizer,
                        QuantumCircuit, Sampler, UCCSD, VQD)
from esoo_torch.chem import MoleculeDriver
from esoo_torch.ops import JordanWignerMapper
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    estimator = Estimator(approximation=True, device=device)
    fidelity = ComputeUncompute(Sampler(shots=None, device=device))
    mapper = JordanWignerMapper()

    q_molecule = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735",
                                basis="6-31G").run()
    num_particles = q_molecule.num_particles
    num_reduced_spin_orbitals = 4
    k = 2

    HF_state = HartreeFock(
        num_spatial_orbitals=num_reduced_spin_orbitals // 2,
        num_particles=num_particles)
    excited_HF = QuantumCircuit(num_reduced_spin_orbitals)
    excited_HF.x(1)
    excited_HF.x(2)

    ansatz_list = [
        UCCSD(num_spatial_orbitals=num_reduced_spin_orbitals // 2,
              num_particles=num_particles, reps=2, initial_state=state)
        for state in (HF_state, excited_HF)
    ]

    partial_unitary_optimizer = PartialUnitaryProjectionOptimizer(
        initial_BBstepsize=10**-3, stopping_tolerance=10**-5, maxiter=10000,
        device=device)

    vqd_instance = VQD(estimator=estimator,
                       fidelity=fidelity,
                       ansatz=ansatz_list,
                       optimizer=L_BFGS_B(),
                       k=k,
                       betas=[2, 2],
                       initial_point=[np.zeros(a.num_parameters)
                                      for a in ansatz_list],
                       device=device)

    optorbvqd_instance = OptOrbVQD(
        num_spin_orbitals=num_reduced_spin_orbitals,
        excited_states_solver=vqd_instance,
        mapper=mapper,
        estimator=estimator,
        partial_unitary_optimizer=partial_unitary_optimizer,
        problem=q_molecule,
        maxiter=20,
        wavefuntion_real=True,
        spin_conserving=True,
        device=device)

    result = optorbvqd_instance.compute_energies()
    print(f"Orbital-optimized energies: {result.eigenvalues} Ha "
          f"(4 spin-orbitals)")
    return {"eigenvalues": [float(e) for e in result.eigenvalues]}


if __name__ == "__main__":
    main()
