"""The import guard: no module of the benchmark loads JAX or the JAX
package, and the reference and the input maker load nothing of the port.
Top-level names (before the first dot) are compared whole: the port's
name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.harness import manifest, session

FORBIDDEN = {"jax", "jaxlib", "flax", "esoo_tpu"}


def _py_files(*parts):
    top = os.path.join(manifest.PORTBENCH, *parts)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name.split(".")[0] for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            yield n.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _py_files():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(_imported(path)) & FORBIDDEN, path


@pytest.mark.parametrize("part", ["reference", "inputs"])
def test_reference_and_inputs_import_nothing_of_the_port(part):
    for path in _py_files(part):
        assert "esoo_torch" not in set(_imported(path)), path


def test_loading_the_reference_and_inputs_loads_no_port_and_no_jax():
    code = ("import sys; import portbench.reference.vqe, "
            "portbench.reference.casscf, portbench.inputs.molecule; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {"esoo_torch"})


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "esoo_tpu_not_really", object())
    monkeypatch.setitem(sys.modules, "jaxlike.sub", object())
    assert session.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert session.forbidden_modules() == ["jaxlib"]
