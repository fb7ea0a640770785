"""The PyTorch port's twin of H2O_Geometry_Frequencies.py: FCI-quality
geometry optimization and harmonic frequencies of water.

    python examples/torch_H2O_Geometry_Frequencies.py                # the card
    python examples/torch_H2O_Geometry_Frequencies.py --device cpu   # the host

Exact full-space CASSCF (= FCI, 441 determinants for H2O/STO-3G) totals,
each solved on the device, drive BFGS over the nuclear coordinates; a
finite-difference Hessian with mass-weighting and translation/rotation
projection then gives the three normal modes (bend, symmetric stretch,
asymmetric stretch).
"""

import argparse

import numpy as np

from esoo_torch.chem import (casscf_energy_fn, harmonic_frequencies,
                             optimize_geometry)
from esoo_torch.chem.basis import parse_geometry
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    energy = casscf_energy_fn(basis="sto-3g", device=device)  # FCI

    print("optimizing H2O (FCI/STO-3G):")
    res = optimize_geometry(
        "O 0 0 0.12; H 0 0.76 -0.47; H 0 -0.76 -0.47", energy,
        callback=lambda atom, e, g: print(
            f"  E = {e:+.8f} Ha   max|dE/dR| = {np.abs(g).max():.2e}"))
    assert res["converged"]

    _, c = parse_geometry(res["atom"])
    r1 = np.linalg.norm(c[1] - c[0])
    r2 = np.linalg.norm(c[2] - c[0])
    cosang = (c[1] - c[0]) @ (c[2] - c[0]) / (r1 * r2)
    angle = np.degrees(np.arccos(cosang))
    print(f"\nE = {res['energy']:.8f} Ha")
    print(f"r(OH) = {r1 * 0.52917721092:.4f} / "
          f"{r2 * 0.52917721092:.4f} A,  angle = {angle:.2f} deg")

    print("\nharmonic analysis:")
    vib = harmonic_frequencies(res["atom"], energy)
    f = vib["frequencies_cm1"]
    print(f"  projected trans/rot residuals: "
          f"max {np.abs(f[:-3]).max():.1f} cm^-1")
    labels = ["bend", "symmetric stretch", "asymmetric stretch"]
    for lab, nu in zip(labels, sorted(f[-3:])):
        print(f"  {lab:>20}: {nu:8.1f} cm^-1")

    assert vib["n_vibrations"] == 3
    assert (f[-3:] > 500).all()
    return {"energy": float(res["energy"]),
            "r_oh": [float(r1 * 0.52917721092), float(r2 * 0.52917721092)],
            "angle": float(angle),
            "modes": [float(nu) for nu in sorted(f[-3:])]}


if __name__ == "__main__":
    main()
