"""The PyTorch port's twin of H2_Fused_and_Sharded.py: the fused solvers
and the mesh-sharded inner loop, on H2 cc-pVTZ -> 4 spin orbitals.

    python examples/torch_H2_Fused_and_Sharded.py                # the card
    python examples/torch_H2_Fused_and_Sharded.py --device cpu   # the host

Each fused solver runs its OptOrb outer loop as one eager loop on the
device.  The class-based solver's inner loop shards the two-electron
tensor over a 2-shard orbital mesh, as the JAX example's does: two cards
where the machine has them, else two logical shards of one device.
"""

import argparse

import numpy as np
import torch

from esoo_torch import (DeviceLBFGS, Estimator, FusedOptOrbSSVQE,
                        FusedOptOrbVQE, HartreeFock, OptOrbVQE,
                        PartialUnitaryProjectionOptimizer, QuantumCircuit,
                        UCCSD, VQE)
from esoo_torch.chem import MoleculeDriver
from esoo_torch.parallel import make_orbital_mesh
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    problem = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735",
                             basis="cc-pVTZ").run()
    num_particles = problem.num_particles
    n_red = 4

    ansatz = UCCSD(n_red // 2, num_particles,
                   initial_state=HartreeFock(n_red // 2, num_particles))

    # --- 1. the fused OptOrbVQE -------------------------------------------
    fused = FusedOptOrbVQE(num_spin_orbitals=n_red, ansatz=ansatz,
                           problem=problem, maxiter=20, device=device)
    result = fused.compute_minimum_energy()
    print(f"FusedOptOrbVQE:  {result.eigenvalue:.10f} Ha "
          f"in {result.outer_iterations} outer iterations")

    # --- 2. excited states ------------------------------------------------
    ssvqe_ansatz = UCCSD(n_red // 2, num_particles, reps=2)
    excited_HF = QuantumCircuit(n_red)
    excited_HF.x(1)
    excited_HF.x(2)
    fused_ss = FusedOptOrbSSVQE(
        num_spin_orbitals=n_red, ansatz=ssvqe_ansatz,
        initial_states=[HartreeFock(n_red // 2, num_particles), excited_HF],
        weight_vector=[2, 1], problem=problem, maxiter=20, device=device)
    excited = fused_ss.compute_energies().eigenvalues
    print("FusedOptOrbSSVQE:", excited, "Ha")

    # --- 3. class-based solver with a sharded inner loop ------------------
    # the m^4 tensor splits over the mesh on its last axis, with one sum
    # of n^4 partials on the lead device per energy evaluation
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        mesh = make_orbital_mesh(2)
    else:
        mesh = make_orbital_mesh(devices=[device] * 2)
    vqe = VQE(Estimator(device=device), ansatz, DeviceLBFGS(device=device),
              initial_point=np.zeros(ansatz.num_parameters), device=device)
    sharded = OptOrbVQE(
        num_spin_orbitals=n_red, ground_state_solver=vqe,
        partial_unitary_optimizer=PartialUnitaryProjectionOptimizer(
            1e-3, 1e-5, 10000, device=device),
        problem=problem, maxiter=20, mesh=mesh, device=device)
    e_sharded = sharded.compute_minimum_energy().eigenvalue
    print(f"OptOrbVQE (mesh={mesh.shape}):", e_sharded, "Ha")
    return {"fused": float(result.eigenvalue),
            "outer_iterations": result.outer_iterations,
            "ssvqe": [float(e) for e in excited],
            "sharded": float(e_sharded)}


if __name__ == "__main__":
    main()
