"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import importlib
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["fhebench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    names += [r for c in SPEC["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_metric_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"matrices_per_s", "latency_ms_p50", "latency_ms_p90",
                        "peak_device_gib", "setup_s"}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in e2e.values():
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}
        assert m["moves"] in e2e


def test_every_per_layer_cell_reports_its_moves_metric():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in cells
            assert w in moved.get("workloads", [w])


def test_every_cell_reports_setup_and_a_layer_metric():
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])
        assert all(w["name"] in m.get("workloads", [w["name"]])
                   for m in SPEC["end_to_end"] if m["name"] == "setup_s")


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    base = os.path.join(ROOT, "fhebench")
    cfg = json.load(open(os.path.join(base, "configs", w["config"] + ".json")))
    traffic = json.load(open(os.path.join(base, "traffic",
                                          w["traffic"] + ".json")))
    assert cfg["name"] == w["config"]
    kind = importlib.import_module(f"fhebench.kinds.{traffic['kind']}")
    for fn in ("setup", "request", "release", "check"):
        assert callable(getattr(kind, fn))
    for m in SPEC["per_layer"]:
        if w["name"] in m["workloads"]:
            reader = importlib.import_module(f"fhebench.layers.{m['name']}")
            assert callable(reader.read)


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.load(open(os.path.join(ROOT, c["file"])))
    assert c["file"].startswith("fhebench/configs/")
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for key in ("n", "p", "moduli", "delta_bits", "sigma", "p_moduli",
                "precision", "assumed"):
        assert key in cfg
    assert all(k in cfg["assumed"] for k in c["reduced"])
    assert len({f["file"] for f in SPEC["configs"]}) == len(SPEC["configs"])


def test_command_stays_in_paths():
    cmd = SPEC["command"]
    assert len(cmd) <= 32 and cmd[:3] == ["python3", "-m", "fhebench"]
    assert not any(a.startswith("/") or ".." in a for a in cmd)
