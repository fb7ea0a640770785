"""The PyTorch port's twin of H2_Sector_Callbacks_Checkpoint.py: the
fused solver on the determinant sector, a live outer-loop callback, and
checkpoint/resume, on H2 6-31G -> 4 spin orbitals.

    python examples/torch_H2_Sector_Callbacks_Checkpoint.py       # card
    python examples/torch_H2_Sector_Callbacks_Checkpoint.py \
        --device cpu                                               # host

`simulation='sector'` runs the UCC eigensolver in the C(n,na)*C(n,nb)
determinant sector; `outer_loop_callback=` fires once an outer
iteration; `checkpoint_dir=` writes a resumable .npz an outer iteration
and `resume_from=` warm-starts (U, theta) from one.
"""

import argparse
import glob
import os
import tempfile

from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
from esoo_torch.chem import MoleculeDriver
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    problem = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735",
                             basis="6-31g").run()
    ansatz = UCCSD(2, problem.num_particles,
                   initial_state=HartreeFock(2, problem.num_particles))

    checkpoint_dir = tempfile.mkdtemp(prefix="esoo_ck_")

    def monitor(iteration, energy):
        print(f"  outer iteration {iteration}: E = {energy:.8f} Ha")

    result = FusedOptOrbVQE(
        num_spin_orbitals=4,
        ansatz=ansatz,
        problem=problem,
        maxiter=20,
        simulation="sector",
        outer_loop_callback=monitor,
        checkpoint_dir=checkpoint_dir,
        device=device,
    ).compute_minimum_energy()

    print("converged:", result.eigenvalue, "Ha in", result.outer_iterations,
          "outer iterations")

    checkpoints = sorted(glob.glob(os.path.join(checkpoint_dir, "*.npz")))
    print("checkpoints written:", len(checkpoints))

    # resume from the last checkpoint: warm-started (U, theta) converge
    # immediately at (or below) the original optimum
    resumed = FusedOptOrbVQE(
        num_spin_orbitals=4,
        ansatz=ansatz,
        problem=problem,
        maxiter=20,
        simulation="sector",
        resume_from=checkpoints[-1],
        device=device,
    ).compute_minimum_energy()
    print("resumed:", resumed.eigenvalue, "Ha in", resumed.outer_iterations,
          "outer iterations")
    return {"eigenvalue": float(result.eigenvalue),
            "outer_iterations": result.outer_iterations,
            "checkpoints": len(checkpoints),
            "resumed": float(resumed.eigenvalue),
            "resumed_outer_iterations": resumed.outer_iterations}


if __name__ == "__main__":
    main()
