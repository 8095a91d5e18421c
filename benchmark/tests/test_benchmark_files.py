"""BENCHMARK.json against the benchmark's contract: names and units of the
allowed characters, every file found by its name, the metrics' keys."""

import json
import re

import pytest
from tiny_cell import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry["name"]


@pytest.mark.parametrize("group,name", list(_names()))
def test_name_characters(group, name):
    assert NAME.match(name), f"{group} name {name!r}"


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert LINE.match(metric["layer"])
        assert (REPO / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    assert LINE.match(cell["why"]) and cell["chips"] in (1, 4)
    assert (REPO / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (REPO / "benchmark" / "limits" / f"{cell['name']}.json").is_file()
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((REPO / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"] == []
    assert data["source"] == config["source"]
    assert config["file"].startswith("benchmark/")


def test_command_and_paths():
    assert BENCH["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
