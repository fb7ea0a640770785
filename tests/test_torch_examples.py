"""The PyTorch port's example twins (examples/torch_*.py) run verbatim on
the CPU (`--device cpu`), each gated by chip_smoke.py's example_gates as
the card's run is: the anchors tests/test_examples.py holds the JAX
package's examples to, and the twin's numbers against its JAX example's,
run here on the same inputs (jax_example), at 1e-8 where both packages
run the same algorithm at float64 (looser only where EXAMPLE_PARITY
writes a reason beside the tolerance).  The chemistry workflows' twins
are in tests/test_torch_examples_chem.py.

The card cannot run JAX, so chip_smoke.py holds the JAX examples'
numbers as constants (JAX_EXAMPLES); test_jax_example_as_recorded
recomputes each.  Each is recorded, from the JAX package on the CPU, by

    python tests/test_torch_examples.py NAME

which runs examples/NAME.py and prints the values of RECORD[NAME]'s
expressions, evaluated over the names the run leaves behind: the
module's globals and, for an example that works inside main(), main's
locals at its return.  Those are the full-precision values of the
numbers the example prints; each twin's main returns the same numbers
under the same keys."""

import ast
import contextlib
import functools
import glob
import io
import os
import runpy
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def run_twin(name, *argv):
    """(returned numbers, printed text) of examples/torch_<name>.py's
    main(["--device", "cpu", *argv]), loaded through runpy."""
    main = runpy.run_path(os.path.join(EXAMPLES, f"torch_{name}.py"),
                          run_name=f"torch_{name}")["main"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = main(["--device", "cpu", *argv])
    return got, buf.getvalue()


def _smoke():
    """chip_smoke.py as a module (its example gates and JAX constants)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def gate_twin(name, *argv):
    """Run examples/torch_<name>.py on the CPU and gate it as the card's
    run is gated, against its JAX example run here (jax_example)."""
    got, out = run_twin(name, *argv)
    jax = jax_example(name) if name in SMOKE.JAX_EXAMPLES else None
    assert SMOKE.example_gates(name, got, out, jax=jax) == []
    return got, out


# expressions over each JAX example's names: the numbers it prints
RECORD = {
    "H2_OptOrbVQE": {"eigenvalue": "ground_state_energy_result.eigenvalue",
                     "outer_iterations": "outer_iteration"},
    "H2_OptOrbSSVQE": {"eigenvalues": "list(result.eigenvalues)"},
    "H2_OptOrbMCVQE": {"eigenvalues": "list(result.eigenvalues)"},
    "H2_OptOrbVQD": {"eigenvalues": "list(result.eigenvalues)"},
    "H2_OptOrbAdaptVQE": {"eigenvalue": "result.eigenvalue"},
    "H2_Sector_Callbacks_Checkpoint": {
        "eigenvalue": "result.eigenvalue",
        "outer_iterations": "result.outer_iterations",
        "checkpoints": "len(checkpoints)", "resumed": "resumed.eigenvalue",
        "resumed_outer_iterations": "resumed.outer_iterations"},
    "H4_CASSCF": {
        "eigenvalue": "result.eigenvalue",
        "outer_iterations": "result.outer_iterations",
        "natural_occupations": "list(result.natural_occupations)",
        "spin_squared": "result.spin_squared", "sa_eigenvalues": "list(es)",
        "sa_outer_iterations": "sa.outer_iterations",
        "total": "result.eigenvalue + problem.nuclear_repulsion_energy"},
    "H2O_OptOrbVQE": {"rhf_total": "problem.scf.energy_total",
                      "e_total": "e_total",
                      "outer_iterations": "result.outer_iterations"},
    "H2S_FrozenCore_OptOrbVQE": {
        "rhf_total": "problem.scf.energy_electronic"
                     " + problem.nuclear_repulsion_energy",
        "core_energy": "active.core_energy",
        "eigenvalue": "result.eigenvalue", "total": "total"},
    "MP2_ActiveSpace_OptOrbVQE": {
        "occ": "list(occ[:8])", "populations": "loc['populations'].tolist()",
        "n_keep": "n_keep", "e_hf": "e_hf", "e_mp2": "e_hf + r['e_corr']",
        "e_opt": "e_opt"},
    "H3_OpenShell_OptOrbVQE": {"rohf_total": "problem.scf.energy_total",
                               "eigenvalue": "result.eigenvalue"},
    "LiH_OptOrbVQE": {"rhf_total": "problem.scf.energy_total",
                      "eigenvalue": "result.eigenvalue",
                      "e_total": "e_total"},
    "H4_OptOrbVQE": {"eigenvalue": "result.eigenvalue"},
    "H4_OptOrbAdaptVQE": {"eigenvalue": "result.eigenvalue"},
    "N2_ccpVDZ_CASSCF_UCC": {
        "rhf_total": "problem.scf.energy_electronic"
                     " + problem.nuclear_repulsion_energy",
        "casscf_total": "cas.eigenvalue + offset",
        "casscf_outer_iterations": "cas.outer_iterations",
        "uccsd_total": "ucc.eigenvalue + offset",
        "uccsd_outer_iterations": "ucc.outer_iterations",
        "parameters": "ansatz.num_parameters",
        "natural_occupations": "list(np.asarray(occ).ravel()[:8])"},
}

H2_TWINS = ["H2_OptOrbVQE", "H2_OptOrbSSVQE", "H2_OptOrbMCVQE",
            "H2_OptOrbVQD", "H2_OptOrbAdaptVQE",
            "H2_Sector_Callbacks_Checkpoint"]


@pytest.mark.parametrize("name", H2_TWINS)
def test_h2_twin(name):
    """The H2 6-31G -> 4 twins.  Anchors: tests/test_examples.py's
    -1.8661 (5e-4) for OptOrbVQE and the sector callbacks; BASELINE.md's
    (the verify notes') for the class-based excited family and ADAPT
    (1.5e-3); the JAX example's numbers at 1e-8."""
    gate_twin(name)


@pytest.mark.slow
def test_h4_casscf_twin():
    gate_twin("H4_CASSCF")


@pytest.mark.slow
def test_h2o_optorbvqe_twin():
    gate_twin("H2O_OptOrbVQE")


@pytest.mark.slow
def test_h2s_frozen_core_twin():
    gate_twin("H2S_FrozenCore_OptOrbVQE")


@pytest.mark.slow
def test_mp2_activespace_twin():
    gate_twin("MP2_ActiveSpace_OptOrbVQE")


@pytest.mark.slow
def test_h3_open_shell_twin():
    gate_twin("H3_OpenShell_OptOrbVQE")


@pytest.mark.slow
def test_lih_optorbvqe_twin():
    gate_twin("LiH_OptOrbVQE")


@pytest.mark.slow
def test_h4_optorbvqe_twin():
    """Held to chip_smoke.py's JAX_H4_OPTORB_F64 (the JAX class path at
    these settings) at 1e-5, the smoke's gate, and to the JAX example's
    energy at 1e-8."""
    gate_twin("H4_OptOrbVQE")


@pytest.mark.slow
def test_h4_optorbadaptvqe_twin():
    gate_twin("H4_OptOrbAdaptVQE")


@pytest.mark.slow
def test_n2_ccpvdz_casscf_ucc_twin():
    gate_twin("N2_ccpVDZ_CASSCF_UCC")


@pytest.mark.parametrize("name", [
    pytest.param(name, marks=() if name in H2_TWINS else pytest.mark.slow)
    for name in RECORD])
def test_jax_example_as_recorded(name):
    """chip_smoke.py's JAX_EXAMPLES[name], the constants the card's twin
    is held to, are what the JAX example gives here, at the tolerances
    the twin is held to."""
    assert SMOKE.example_parity(name, jax_example(name),
                                SMOKE.JAX_EXAMPLES[name]) == []


@pytest.mark.slow
def test_h8_scale_demo_twin_first_outer_iteration():
    """The H8 demo at full width, one outer iteration, float32 on the
    CPU: its first outer energy within 5e-4 (the smoke's gate: an f32
    run against float64) of JAX_H8_16_FIRST_F64, E at or below it and
    below the RHF electronic energy."""
    gate_twin("H8_scale_demo", "--maxiter", "1")


@pytest.mark.slow
def test_jax_h8_16_first_outer_energy_recomputed():
    """chip_smoke.py's JAX_H8_16_FIRST_F64: the first entry of
    energy_convergence_list of the JAX package's FusedOptOrbVQE at the H8
    demo's settings (H8 cc-pVTZ -> 16, UCCSD(8, (4, 4)) from HF,
    stopping_tolerance 1e-4, vqe_maxiter 120) at float64, maxiter 1, on
    the CPU (~100 s on 8 cores with the integrals)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from esoo_tpu.chem import MoleculeDriver
    from esoo_tpu.orbital_optimization import FusedOptOrbVQE
    from esoo_tpu.sim import HartreeFock, UCCSD
    p = MoleculeDriver(atom="; ".join(f"H 0 0 {n * 1.23}" for n in range(8)),
                       basis="cc-pVTZ").run()
    ansatz = UCCSD(8, p.num_particles,
                   initial_state=HartreeFock(8, p.num_particles))
    r = FusedOptOrbVQE(num_spin_orbitals=16, ansatz=ansatz, problem=p,
                       maxiter=1, stopping_tolerance=1e-4, dtype=np.float64,
                       vqe_maxiter=120).compute_minimum_energy()
    np.testing.assert_allclose(r.energy_convergence_list[0],
                               SMOKE.JAX_H8_16_FIRST_F64, rtol=0,
                               atol=1e-9)


@pytest.mark.slow
def test_torch_h2_fused_and_sharded_example():
    gate_twin("H2_Fused_and_Sharded")


def _twins():
    return sorted(glob.glob(os.path.join(EXAMPLES, "torch_*.py")))


def test_every_jax_example_has_a_twin_that_stands_alone():
    """Each examples/*.py has examples/torch_*.py beside it; no twin
    imports jax or esoo_tpu, and each has a --device argument whose
    default is 'cuda' (read from its source)."""
    jax_examples = {os.path.basename(p) for p in
                    glob.glob(os.path.join(EXAMPLES, "*.py"))
                    if not os.path.basename(p).startswith("torch_")}
    twins = {os.path.basename(p)[len("torch_"):] for p in _twins()}
    assert twins == jax_examples
    for path in _twins():
        tree = ast.parse(open(path).read())
        imported = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                imported |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                imported.add((node.module or "").split(".")[0])
        assert not imported & {"jax", "jaxlib", "esoo_tpu"}, path
        defaults = [kw.value.value for node in ast.walk(tree)
                    if isinstance(node, ast.Call)
                    and getattr(node.func, "attr", "") == "add_argument"
                    and node.args and getattr(node.args[0], "value", "")
                    == "--device"
                    for kw in node.keywords if kw.arg == "default"]
        assert defaults == ["cuda"], path


def test_a_twin_raises_without_a_card(monkeypatch):
    """No silent CPU path: a twin's main([]) asks for the card, and
    resolve_device raises where there is none."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = runpy.run_path(os.path.join(EXAMPLES, "torch_H4_CASSCF.py"),
                          run_name="torch_H4_CASSCF")["main"]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main([])


def jax_example_names(name):
    """The names examples/<name>.py leaves behind when run on the CPU:
    its module globals, updated with main()'s locals at its return where
    the example works inside main()."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    path = os.path.join(EXAMPLES, f"{name}.py")
    names = {}

    def hook(frame, event, arg):
        if (event == "return" and frame.f_code.co_name == "main"
                and frame.f_code.co_filename == path):
            names.update(frame.f_locals)

    sys.setprofile(hook)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            module = runpy.run_path(path, run_name="__main__")
    finally:
        sys.setprofile(None)
    return {**module, **names}


def _plain(value):
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, (int, np.integer)):
        return int(value)
    return float(value)


@functools.cache
def jax_example(name):
    """RECORD[name]'s values from examples/<name>.py's run on the CPU
    (once a process)."""
    import test_torch_examples_chem as chem
    spec = {**RECORD, **chem.RECORD}[name]
    names = jax_example_names(name)
    return {key: _plain(eval(expr, names)) for key, expr in spec.items()}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    print(repr(jax_example(sys.argv[1])))
