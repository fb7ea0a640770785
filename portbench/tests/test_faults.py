"""Whole runs on the CPU (the harness's look for a card skipped; set-up,
window, check and result line as run.py makes them), on H4 6-31G at
float64 with the real cells' traffic and limits: a sound run is correct,
and each fault these cells can have, planted in the port underneath the
timed path (tests/faults.py), makes `correct` false."""

import sys
import time

import pytest

from portbench.harness import manifest
from portbench.tests import faults, minibench


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    root, base = minibench.build(str(tmp))
    return root, base, str(tmp / "cache")


def _run(tree, cell, seconds=1.5):
    sys.path.insert(0, manifest.PORTBENCH)
    import run
    root, base, cache = tree
    line, _ = run.execute(cell, 2 ** 31 + 12345, seconds, False,
                          device="cpu", root=root, base=base,
                          cache_root=cache, t0=time.perf_counter())
    return line


@pytest.mark.parametrize("cell", list(minibench.CELLS))
def test_a_sound_run_is_correct(tree, cell):
    line = _run(tree, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) >= {"setup_s", "peak_device_gib"}


@pytest.mark.parametrize("cell", list(minibench.CELLS))
def test_a_state_returned_unchanged_is_caught(tree, cell, monkeypatch):
    faults.state_unchanged(monkeypatch)
    line = _run(tree, cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", list(minibench.CELLS))
def test_orbitals_left_at_their_start_are_caught(tree, cell, monkeypatch):
    faults.orbitals_unchanged(monkeypatch)
    line = _run(tree, cell)
    assert not line["correct"], line["checks"]
    row = line["checks"]["orbital_grad_ratio"]
    assert row["value"] == pytest.approx(1.0, abs=1e-6)
    assert row["value"] > row["limit"]


@pytest.mark.parametrize("cell", list(minibench.CELLS))
def test_an_answer_altered_where_produced_is_caught(tree, cell, monkeypatch):
    real = minibench.CELLS[cell][1]
    faults.energy_altered(
        monkeypatch, 10 * manifest.limits(real)["limits"]["energy_gap_ha"])
    line = _run(tree, cell)
    assert not line["correct"], line["checks"]
