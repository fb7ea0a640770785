"""The PyTorch port's twin of H2O_OptOrbVQE.py: OptOrbVQE on water, the
6-31G* starting basis (19 spatial / 38 spin orbitals, cartesian d)
reduced to 12 spin orbitals with the fused solver.

    python examples/torch_H2O_OptOrbVQE.py                # the card
    python examples/torch_H2O_OptOrbVQE.py --device cpu   # the host

The RHF value -76.0105 Ha reproduces the published 6-31G* result
(-76.0107, Szabo & Ostlund Table 3.13); OptOrbVQE then captures
correlation inside the optimized 12-spin-orbital active space.
"""

import argparse
import math

from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
from esoo_torch.chem import MoleculeDriver
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    r, ang = 0.9572, math.radians(104.52)
    x, z = r * math.sin(ang / 2), r * math.cos(ang / 2)
    problem = MoleculeDriver(
        atom=f"O 0 0 0; H {x:.6f} 0 {z:.6f}; H {-x:.6f} 0 {z:.6f}",
        basis="6-31g*").run()
    print(f"RHF total energy: {problem.scf.energy_total:.6f} Ha "
          f"(published 6-31G*: -76.0107), "
          f"{problem.num_spatial_orbitals} spatial orbitals")

    num_reduced_spin_orbitals = 12
    n_act = num_reduced_spin_orbitals // 2
    parts = problem.num_particles   # (5, 5)

    ansatz = UCCSD(n_act, parts, initial_state=HartreeFock(n_act, parts))
    result = FusedOptOrbVQE(num_spin_orbitals=num_reduced_spin_orbitals,
                            ansatz=ansatz, problem=problem, maxiter=15,
                            device=device).compute_minimum_energy()

    e_total = float(result.eigenvalue) + problem.nuclear_repulsion_energy
    print(f"OptOrbVQE total energy: {e_total:.8f} Ha "
          f"in {result.outer_iterations} outer iterations")
    print(f"correlation captured in 12 spin orbitals: "
          f"{e_total - problem.scf.energy_total:.6f} Ha")
    return {"rhf_total": float(problem.scf.energy_total),
            "e_total": e_total,
            "outer_iterations": result.outer_iterations}


if __name__ == "__main__":
    main()
