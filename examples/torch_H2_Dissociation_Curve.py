"""The PyTorch port's twin of H2_Dissociation_Curve.py: where mean-field
and perturbation theory fail.

    python examples/torch_H2_Dissociation_Curve.py                # the card
    python examples/torch_H2_Dissociation_Curve.py --device cpu   # the host

Along the H2/STO-3G dissociation curve restricted HF overshoots the
atomic limit by ~0.25 Ha, MP2 dives below the exact curve, and the
exact sector diagonalization (casscf_energy_fn = FCI, on the device)
dissociates cleanly to two free hydrogen atoms.  For two electrons CCSD
is exact, so it reproduces FCI at every point.
"""

import argparse

from esoo_torch.chem import MoleculeDriver, casscf_energy_fn, ccsd, mp2
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    e_fci = casscf_energy_fn(basis="sto-3g", device=device)
    e_h = casscf_energy_fn(basis="sto-3g", spin=1, device=device)("H 0 0 0")
    print(f"2 x E(H atom) = {2 * e_h:.6f} Ha (the exact limit)\n")
    print(f"{'r (A)':>6} {'HF':>11} {'MP2':>11} {'CCSD':>11} "
          f"{'FCI':>11}")

    rows = []
    for r in (0.735, 1.2, 2.0, 3.0, 5.0, 8.0):
        atom = f"H 0 0 0; H 0 0 {r}"
        p = MoleculeDriver(atom, basis="sto-3g").run()
        nre = p.nuclear_repulsion_energy
        hf = p.scf.energy_electronic + nre
        m = mp2(p)["e_total"]
        cc = ccsd(p)["e_total"]
        fci = e_fci(atom)
        rows.append((r, hf, m, cc, fci))
        print(f"{r:6.2f} {hf:11.6f} {m:11.6f} {cc:11.6f} {fci:11.6f}")

    r8 = rows[-1]
    print("\nat r = 8 A:")
    print(f"  FCI reaches the atomic limit to "
          f"{abs(r8[4] - 2 * e_h) * 1000:.3f} mHa")
    print(f"  RHF overshoots it by {(r8[1] - 2 * e_h):.4f} Ha "
          f"(the ionic-term catastrophe)")
    print(f"  MP2 lands {(r8[2] - r8[4]):.4f} Ha BELOW the exact "
          f"energy (non-variational collapse)")

    assert abs(r8[4] - 2 * e_h) < 1e-4          # FCI limit exact
    assert r8[1] - 2 * e_h > 0.1                # RHF catastrophe
    assert r8[2] < r8[4] - 0.05                 # MP2 collapse
    for r, hf, m, cc, fci in rows:              # CCSD == FCI (2e)
        assert abs(cc - fci) < 1e-7
    return {"e_h": float(e_h),
            "rows": [[float(v) for v in row] for row in rows]}


if __name__ == "__main__":
    main()
