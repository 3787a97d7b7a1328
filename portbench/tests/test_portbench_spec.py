"""BENCHMARK.json keeps to the shape its readers expect, and every name it gives
resolves to a file of the benchmark."""

import json
import re

import pytest

from portbench import bench

B = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def _names():
    yield from (c["name"] for c in B["configs"])
    for w in B["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in B["end_to_end"] + B["per_layer"])
    for c in B["configs"]:
        yield from c["reduced"]


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_keep_to_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", B["end_to_end"] + B["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in B["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in B["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_names_are_unique_and_every_config_is_used():
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"]) for w in B["workloads"]}) == len(CELLS)
    assert {c["name"] for c in B["configs"]} == {w["config"] for w in B["workloads"]}
    assert len({c["file"] for c in B["configs"]}) == len(B["configs"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = bench.load_cell(cell)
    assert c.chips in (1, 4)
    assert c.config["reference"] and c.traffic["mode"] in ("probe", "multiprobe", "exact")
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]).read)
        if m["name"].startswith("roofline."):
            assert m["name"].split(".", 1)[1] in bench.counts()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for kernel in c.traffic["work"]:
        assert kernel in bench.counts()
    assert c.module("datagen", c.config["data"]["generator"]).make
    assert c.module("references", c.config["reference"]).Reference
    assert set(c.limits) >= {"dist_gap", "top10_miss"}


def test_kernel_counts_name_kernels_of_the_program():
    symbols = bench.hand_symbols()
    assert {"alsh_project_kernel", "wl1_scan_partial", "gather_rerank_split_kernel"} <= symbols
    for name, count in bench.counts().items():
        assert set(count.SYMBOLS) <= symbols, name


def test_configuration_files_under_paths():
    for c in B["configs"]:
        assert c["file"].startswith("portbench/") and (bench.ROOT / c["file"]).is_file()
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
