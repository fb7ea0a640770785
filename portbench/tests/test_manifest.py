"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name (a file added beside them is found with no edit)."""

import json
import math
import os
import shutil

import pytest

from portbench.harness import manifest

BENCH = manifest.benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
LINE_RE = r"^[^\n\t]{1,200}$"


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert os.path.getsize(os.path.join(manifest.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str)
                         else x.get("name"))
def test_names_and_units(group, entry):
    import re
    assert manifest.NAME_RE.match(entry["name"])
    if "unit" in entry:
        assert manifest.UNIT_RE.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry and group != "end_to_end":
            assert re.match(LINE_RE, entry[key]), (key, entry[key])
    for key in ("config", "traffic"):
        if key in entry:
            assert manifest.NAME_RE.match(entry[key])


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        for k in c["reduced"]:
            assert manifest.NAME_RE.match(k)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    names = [e["name"] for _, e in _names()]
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(BENCH, w["name"],
                                                      False)}
        layer = manifest.metrics_of(BENCH, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in moves
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_run_seconds_fit_the_full_check_at_24_cells():
    rs = BENCH["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_named_file_is_found():
    for c in BENCH["configs"]:
        cfg = manifest.config(c["name"])
        assert os.path.samefile(os.path.join(manifest.ROOT, c["file"]),
                                os.path.join(manifest.PORTBENCH, "configs",
                                             c["name"] + ".json"))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"]
    for w in BENCH["workloads"]:
        manifest.traffic(w["traffic"])
        lim = manifest.limits(w["name"])["limits"]
        assert lim and all(v > 0 and math.isfinite(v) for v in lim.values())
    for _, m in _names():
        if "unit" in m:
            assert callable(manifest.metric_reader(m["name"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_a_file_added_beside_them_is_found_with_no_edit(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(manifest.PORTBENCH, base,
                    ignore=shutil.ignore_patterns("cache", "build",
                                                  "__pycache__"))
    (base / "metrics" / "queue_depth.mean.py").write_text(
        "def read(run):\n    return 2.5 * len(run['requests'])\n")
    (base / "traffic" / "burst4.json").write_text(json.dumps(
        dict(manifest.traffic("vqe8"), start_scale=0.04)))
    (base / "configs" / "h6_ccpvtz.json").write_text(json.dumps(
        dict(manifest.config("h4_ccpvtz"), name="h6_ccpvtz")))
    (base / "limits" / "h6_ccpvtz.burst4.json").write_text(
        json.dumps({"limits": {"energy_gap_ha": 1.0}}))
    read = manifest.metric_reader("queue_depth.mean", str(base))
    assert read({"requests": [1, 2]}) == 5.0
    assert manifest.traffic("burst4", str(base))["start_scale"] == 0.04
    assert manifest.config("h6_ccpvtz", str(base))["name"] == "h6_ccpvtz"
    assert manifest.limits("h6_ccpvtz.burst4", str(base))["limits"]
    with pytest.raises(FileNotFoundError):
        manifest.traffic("burst4")          # not in the real tree


def test_bad_names_are_refused():
    for bad in ("a b", "a/b", "", "-x", "x" * 65, "µs"):
        with pytest.raises((ValueError, FileNotFoundError)):
            manifest.traffic(bad)


def test_a_configuration_cap_on_the_outer_loop_binds_its_traffic():
    """h8_ccpvtz_f64 states the outer loop's cap it is run at (listed in
    `reduced`); a traffic mix that runs another is refused at set-up."""
    from portbench.harness import session
    cfg = manifest.config("h8_ccpvtz_f64")
    tr = manifest.traffic("casscf28")
    assert cfg["outer_maxiter"] == tr["options"]["maxiter"]
    assert "outer_maxiter" in cfg["reduced"]
    bad = dict(tr, options=dict(tr["options"], maxiter=10))
    with pytest.raises(ValueError, match="caps the outer loop"):
        session.Session(cfg, bad, device="cpu")
