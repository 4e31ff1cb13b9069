"""BENCHMARK.json against the benchmark's contract, and every name it
holds against the files that implement it; the cells that pending.json
keeps out of it are held to the same rules."""

import json
import re

import pytest

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
PENDING = json.loads((harness.BENCH / "pending.json").read_text())
FULL = harness.read_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_command_and_paths():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["benchmark", "with_pending"])
def test_names_and_units(spec):
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["config"] for w in spec["workloads"]] + [w["traffic"] for w in spec["workloads"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in spec[group]]
        assert len(got) == len(set(got))
    assert len({m["name"] for m in metrics}) == len(metrics)


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["benchmark", "with_pending"])
def test_entries_hold_just_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["benchmark", "with_pending"])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(spec):
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:  # each reports the metric it moves
            assert m["moves"] in names


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["benchmark", "with_pending"])
def test_every_name_has_its_file(spec):
    bench = harness.BENCH
    for c in spec["configs"]:
        path = harness.ROOT / c["file"]
        assert c["file"].startswith("benchmark/") and path.is_file()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["peak"] in json.loads((bench / "counts" / "peaks.json").read_text())
    for w in spec["workloads"]:
        traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench / "stages" / f"{traffic['stage']}.py").is_file()
        limits = json.loads((bench / "workloads" / f"{w['name']}.json").read_text())
        assert limits["limits"] and limits["control"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in spec["workloads"]}


def test_pending_cells_stay_out_of_the_benchmark():
    """No name of pending.json is in BENCHMARK.json, and no metric of
    BENCHMARK.json is reported in a pending cell alone."""
    assert set(PENDING) == {"why", "workloads", "end_to_end", "per_layer"}
    for group in ("workloads", "end_to_end", "per_layer"):
        assert not {e["name"] for e in PENDING[group]} & {e["name"] for e in SPEC[group]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in PENDING["end_to_end"] + PENDING["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in PENDING["workloads"]}


@pytest.mark.parametrize("path", sorted(p.relative_to(harness.BENCH).as_posix()
                                         for p in harness.BENCH.rglob("*")
                                         if p.is_file() and "__pycache__" not in p.parts))
def test_file_names_use_name_characters(path):
    assert re.match(r"^[A-Za-z0-9_./-]+$", path)
