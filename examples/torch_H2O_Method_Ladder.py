"""The PyTorch port's twin of H2O_Method_Ladder.py: the classical method
ladder on one molecule.

    python examples/torch_H2O_Method_Ladder.py                # the card
    python examples/torch_H2O_Method_Ladder.py --device cpu   # the host

HF -> MP2 -> CISD -> CCSD -> CCSD(T) -> FCI on water/STO-3G: the
correlated methods run on the host, the FCI rung is the exact sector
diagonalization (FusedOptOrbCASSCF over the full space) on the device.
The correlation-energy recovery climbs monotonically toward it.
"""

import argparse

from esoo_torch import FusedOptOrbCASSCF
from esoo_torch.chem import MoleculeDriver, ccsd, cisd, mp2
from esoo_torch.utils import resolve_device

ATOM = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    problem = MoleculeDriver(ATOM, basis="sto-3g").run()
    nre = problem.nuclear_repulsion_energy

    e_hf = problem.scf.energy_electronic + nre
    m = mp2(problem)
    ci = cisd(problem)
    cc = ccsd(problem, triples=True)
    fci = FusedOptOrbCASSCF(
        num_spin_orbitals=2 * problem.num_spatial_orbitals,
        problem=problem, maxiter=1, device=device).compute_minimum_energy()
    e_fci = fci.eigenvalue + nre
    e_corr_exact = e_fci - e_hf

    rows = [
        ("HF", e_hf),
        ("MP2", m["e_total"]),
        ("CISD", ci["e_total"]),
        ("CCSD", cc["e_total"]),
        ("CCSD(T)", cc["e_total_ccsd_t"]),
        ("FCI (sector Davidson)", e_fci),
    ]
    print(f"H2O / STO-3G  (exact correlation {e_corr_exact:.6f} Ha)\n")
    print(f"{'method':>22} {'E_total (Ha)':>14} {'% corr':>8}")
    prev = None
    for name, e in rows:
        pct = 100.0 * (e - e_hf) / e_corr_exact
        print(f"{name:>22} {e:14.6f} {pct:8.2f}")
        if prev is not None:
            assert e <= prev + 1e-10       # monotone descent
        prev = e

    assert abs(rows[4][1] - e_fci) < 1e-3  # CCSD(T) within 1 mHa of FCI
    return {"rows": {name: float(e) for name, e in rows},
            "e_corr_exact": float(e_corr_exact)}


if __name__ == "__main__":
    main()
