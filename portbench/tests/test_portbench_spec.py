"""Every cell of BENCHMARK.json resolves from its files by name, and the
file keeps to the shapes the benchmark's contract fixes."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.cell(name, BENCH)
    assert cell.chips == 1
    assert hasattr(spec.pattern(cell.traffic["pattern"]), "Pattern")
    for entry in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(entry["name"]))
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    body = json.loads((spec.REPO / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert sorted(body["reduced"]) == sorted(config["reduced"])
    for key in config["reduced"]:
        assert key in body and NAME.match(key)
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


def test_per_layer_names_match_files():
    files = {p.stem for p in (spec.HERE / "metrics").glob("*.py")}
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert listed <= files
