"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(section):
    for entry in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]


def test_names_and_units_use_allowed_characters():
    names = []
    for section in KEYS:
        for entry in SPEC[section]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("config", "traffic"):
                if key in entry:
                    assert NAME.match(entry[key]), entry[key]
            for key in entry.get("reduced", []):
                assert NAME.match(key), key
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def reported(cell):
    return {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])}


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    for w in SPEC["workloads"]:
        e2e = reported(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in m.get("workloads", [w["name"]] if m["moves"] in e2e else [])
                   for m in SPEC["per_layer"]), w["name"]


def test_moves_names_an_end_to_end_metric_of_every_cell_that_reports_the_layer_metric():
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in reported(cell), (m["name"], cell)


def test_cells_chips_and_pairs():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in SPEC["configs"]}
    assert {c for c, _ in pairs} == configs
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def test_files_exist_for_every_name():
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.parts[len(ROOT.parts)] == "portbench"
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert (HERE / "drivers" / f"{cfg['driver']}.py").is_file()
        assert (HERE / "reference" / f"{cfg['reference']}.py").is_file()
    for w in SPEC["workloads"]:
        wl = json.loads((HERE / "workloads" / f"{w['name']}.json").read_text())
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (w["config"], w["traffic"], w["chips"], w["why"])
        assert (HERE / "traffic" / f"{wl['generator']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_file_names_use_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_.-]+$", path.name), path
