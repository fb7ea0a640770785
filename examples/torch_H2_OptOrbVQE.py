"""The PyTorch port's twin of H2_OptOrbVQE.py: OptOrbVQE on H2, 6-31G
starting basis reduced to 4 spin orbitals, through the reference's
class-based API with its callbacks.

    python examples/torch_H2_OptOrbVQE.py                # the card
    python examples/torch_H2_OptOrbVQE.py --device cpu   # the host
"""

import argparse
from time import perf_counter

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

    state = {"outer": 0, "vqe_t": perf_counter(), "orb_t": perf_counter()}

    def vqe_callback(eval_count, parameters, mean, std):
        print(f"Outer loop iteration: {state['outer']}, function "
              f"evaluation: {eval_count}, energy: {mean}, "
              f"time = {perf_counter() - state['vqe_t']}")
        state["vqe_t"] = perf_counter()

    def orbital_rotation_callback(orbital_rotation_iteration, energy):
        print(f"Outer loop iteration: {state['outer']}, Iteration: "
              f"{orbital_rotation_iteration}, energy: {energy}, "
              f"time: {perf_counter() - state['orb_t']}")
        state["orb_t"] = perf_counter()

    def outer_loop_callback(optorb_iteration, vqe_result, optorb_result):
        state["outer"] += 1

    partial_unitary_optimizer = PartialUnitaryProjectionOptimizer(
        initial_BBstepsize=10**-3,
        stopping_tolerance=10**-5,
        maxiter=10000,
        gradient_method="autograd",
        callback=orbital_rotation_callback,
        device=device)

    vqe_instance = VQE(ansatz=ansatz,
                       initial_point=np.zeros(ansatz.num_parameters),
                       optimizer=L_BFGS_B(),
                       estimator=estimator,
                       callback=vqe_callback,
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
        outer_loop_callback=outer_loop_callback,
        device=device)

    ground_state_energy_result = optorbvqe_instance.compute_minimum_energy()
    print(f"Orbital-optimized ground state energy: "
          f"{ground_state_energy_result.eigenvalue} Ha (4 spin-orbitals)")
    print(f"Ground state energy in STO-3G basis: {-1.85727503} Ha "
          f"(4 spin-orbitals)")
    return {"eigenvalue": float(ground_state_energy_result.eigenvalue),
            "outer_iterations": state["outer"]}


if __name__ == "__main__":
    main()
