"""The PyTorch port's example twins run verbatim on the CPU (`--device
cpu`), held to the energies tests/test_examples.py holds the JAX
package's examples to."""

import contextlib
import io
import runpy
import sys

import numpy as np
import pytest


def _run(path, *args):
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = [path, *args]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv
    return buf.getvalue()


@pytest.mark.slow
def test_torch_h2_fused_and_sharded_example():
    out = _run("examples/torch_H2_Fused_and_Sharded.py", "--device", "cpu")
    assert "FusedOptOrbVQE" in out and "FusedOptOrbSSVQE" in out
    line = [ln for ln in out.splitlines() if ln.startswith("FusedOptOrbVQE")][0]
    energy = float(line.split(":")[1].split("Ha")[0])
    np.testing.assert_allclose(energy, -1.87115, atol=5e-4)
    sharded = [ln for ln in out.splitlines()
               if ln.startswith("OptOrbVQE (mesh={'orb': 2})")][0]
    np.testing.assert_allclose(float(sharded.split(":", 2)[2].split("Ha")[0]),
                               energy, atol=1e-6)
