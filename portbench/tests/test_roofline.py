"""The copied yardstick (harness/roofline.py) against chip_smoke.py's own
expressions, evaluated from its source at the cells' shapes (so this runs
without the card and without importing the script)."""

import ast
import os

import pytest

from portbench.harness import manifest, roofline

SMOKE = os.path.join(manifest.ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    with open(SMOKE) as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _assigned(tree, name):
    """The expression assigned to `name` (first assignment in the tree)."""
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in n.targets):
            return n.value
    raise KeyError(name)


def _eval(expr, **env):
    return eval(compile(ast.Expression(expr), SMOKE, "eval"), {}, env)


def test_peaks(smoke):
    peaks = _eval(_assigned(smoke, "_PEAKS"))
    sxm = [p for p in peaks if p[0] == ""][0]
    assert sxm[1] == roofline.PEAK_BYTES_PER_S
    assert sxm[2] == roofline.PEAK_F32_FLOP_PER_S
    assert _eval(_assigned(smoke, "GATE_SCAN_OPS")) == roofline.GATE_SCAN_OPS


@pytest.mark.parametrize("m,n", [(56, 4), (112, 14), (112, 8), (58, 10)])
def test_transform(smoke, m, n):
    assert _eval(_assigned(smoke, "k2_bytes"), m=m, n=n) == \
        roofline.transform_bytes(m, n)
    assert _eval(_assigned(smoke, "k2_flops"), m=m, n=n) == \
        roofline.transform_flops(m, n)


@pytest.mark.parametrize("nB,nA,K,item,B", [(6, 6, 26, 4, 1),
                                            (70, 70, 360, 4, 1),
                                            (70, 70, 360, 4, 2),
                                            (126, 126, 560, 8, 1)])
def test_gate_scan(smoke, nB, nA, K, item, B):
    fn = _function(smoke, "_gate_scan_kernels")
    tables = _eval(_assigned(fn, "tables"), K=K, nA=nA, nB=nB, item=item)
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "_hold_scan")
    kw = {k.arg: k.value for k in call.keywords}
    env = dict(tables=tables, B=B, nd=nB * nA, item=item, K=K,
               GATE_SCAN_OPS=roofline.GATE_SCAN_OPS)
    assert _eval(kw["nbytes"], **env) == roofline.gate_scan_bytes(
        nB, nA, K, item, B)
    assert _eval(kw["ops"], **env) == roofline.gate_scan_flops(nB, nA, K, B)


def test_bounds_are_the_longer_of_bytes_and_operations():
    b, f = roofline.transform_bytes(112, 14), roofline.transform_flops(112, 14)
    assert roofline.bound_s(b, f) == pytest.approx(b / 3.35e12)
    # the (112, 14) transform is bound by bytes: 0.1879 ms (chip_smoke)
    assert roofline.bound_s(b, f) * 1e3 == pytest.approx(0.1879, abs=1e-4)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12, itemsize=8) == pytest.approx(2.0)
