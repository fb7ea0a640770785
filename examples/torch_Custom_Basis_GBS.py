"""The PyTorch port's twin of Custom_Basis_GBS.py: any molecule from a
Gaussian94 .gbs basis file.

    python examples/torch_Custom_Basis_GBS.py                # the card
    python examples/torch_Custom_Basis_GBS.py --device cpu   # the host

Any basis the Basis Set Exchange exports drives the integral engine: pass
the file path as `basis=`.  The example writes a .gbs file (the H 6-31G
data in Gaussian94 text form) and checks it reproduces the bundled-table
energy.  The chemistry runs on the host; `--device` is resolved as in
every twin, so a missing card raises here too.
"""

import argparse
import os
import tempfile

from esoo_torch.chem import MoleculeDriver
from esoo_torch.utils import resolve_device

GBS_TEXT = """
! 6-31G for hydrogen, Gaussian94 format (as exported by the BSE)
****
H     0
S   3   1.00
     18.7311370              0.03349460
      2.8253937              0.23472695
      0.6401217              0.81375733
S   1   1.00
      0.1612778              1.0000000
****
"""


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    resolve_device(parser.parse_args(argv).device)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "h_631g.gbs")
        with open(path, "w") as f:
            f.write(GBS_TEXT)

        p_file = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735",
                                basis=path).run()
        p_table = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735",
                                 basis="6-31g").run()

    print(f"RHF from .gbs file : {p_file.scf.energy_total:.10f} Ha")
    print(f"RHF from table     : {p_table.scf.energy_total:.10f} Ha")
    assert abs(p_file.scf.energy_total - p_table.scf.energy_total) < 1e-10
    print("identical: the .gbs path is a drop-in for any published basis")
    return {"file": float(p_file.scf.energy_total),
            "table": float(p_table.scf.energy_total)}


if __name__ == "__main__":
    main()
