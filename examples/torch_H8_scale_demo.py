"""The PyTorch port's twin of H8_scale_demo.py: an H8 chain, cc-pVTZ
(224 spin orbitals) reduced to 16 spin orbitals, float32.

    python examples/torch_H8_scale_demo.py                # the card
    python examples/torch_H8_scale_demo.py --maxiter 1    # one outer iteration
    python examples/torch_H8_scale_demo.py --device cpu   # the host

The configuration exercises what exists for scale: spatial-direct
ingestion (the spin-orbital tensor would be 20 GB; the spatial one,
float64, is 1.26 GB), the string-factorized determinant-sector simulator
(the default, simulation='auto'; 4,900 determinants, UCCSD with 360
parameters) and the fused outer loop.  Pass a mesh via
FusedOptOrbVQE(mesh=...) to shard g.
"""

import argparse
import time

import torch

from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
from esoo_torch.chem import MoleculeDriver
from esoo_torch.utils import resolve_device


def main(argv=None, problem=None):
    """`problem`: the H8 cc-pVTZ problem, built here when not given."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--maxiter", type=int, default=6,
                        help="outer iterations (default 6)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    bond = 1.23
    t0 = time.perf_counter()
    if problem is None:
        problem = MoleculeDriver(
            atom="; ".join(f"H 0 0 {n * bond}" for n in range(8)),
            basis="cc-pVTZ").run()
    print(f"integrals + RHF: {time.perf_counter() - t0:.0f}s  "
          f"M={problem.num_spin_orbitals}  "
          f"RHF={problem.scf.energy_total:.6f}")

    num_reduced_spin_orbitals = 16
    ansatz = UCCSD(num_reduced_spin_orbitals // 2, problem.num_particles,
                   initial_state=HartreeFock(num_reduced_spin_orbitals // 2,
                                             problem.num_particles))
    print(f"UCCSD: {ansatz.num_parameters} parameters, "
          f"{len(ansatz.gates)} gates")

    solver = FusedOptOrbVQE(num_spin_orbitals=num_reduced_spin_orbitals,
                            ansatz=ansatz, problem=problem,
                            maxiter=args.maxiter, stopping_tolerance=1e-4,
                            dtype=torch.float32, vqe_maxiter=120,
                            device=device)
    t0 = time.perf_counter()
    result = solver.compute_minimum_energy()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t0
    print(f"fused OptOrbVQE: {solve_s:.0f}s, "
          f"{result.outer_iterations} outer iterations")
    print("energy trajectory:",
          [f"{e:.5f}" for e in result.energy_convergence_list])
    print(f"orbital-optimized electronic energy: {result.eigenvalue:.6f} Ha "
          f"({num_reduced_spin_orbitals} spin orbitals)")
    print(f"RHF electronic reference: "
          f"{problem.scf.energy_electronic:.6f} Ha")
    return {"eigenvalue": float(result.eigenvalue),
            "energy_convergence_list": [float(e) for e in
                                        result.energy_convergence_list],
            "outer_iterations": result.outer_iterations,
            "rhf_electronic": float(problem.scf.energy_electronic),
            "parameters": ansatz.num_parameters, "solve_s": solve_s,
            "result": result, "solver": solver}


if __name__ == "__main__":
    main()
