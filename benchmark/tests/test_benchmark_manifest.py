"""``BENCHMARK.json`` against the benchmark's contract: names, units and
keys, and every file a cell, a configuration or a metric is found by."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
M = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert 1 <= len(M["command"]) <= 32 and all(map(line, M["command"]))
    assert all(PATH.match(p) and ".." not in p for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60,
    # 2 x 90 s of compiling a cell, 1200 s spare, inside 43200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for group in (M["configs"], M["workloads"],
                  M["end_to_end"] + M["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_file_is_found_by_name():
    for c in M["configs"]:
        f = ROOT / c["file"]
        assert c["file"].startswith("benchmark/") and f.is_file()
        cfg = json.loads(f.read_text())
        # the file's own list of cuts names the manifest's, with the
        # published value of each
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert cfg["source"] == c["source"]
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])
    used = set()
    for w in M["workloads"]:
        used.add(w["config"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
    assert used == {c["name"] for c in M["configs"]}
    for m in M["end_to_end"]:
        assert (HERE / "e2e_metrics" / f"{m['name']}.py").is_file()
    for m in M["per_layer"]:
        assert (HERE / "layer_metrics" / f"{m['name']}.py").is_file()


def reports(m, cell):
    return "workloads" not in m or cell in m["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_enough(cell):
    e2e = [m["name"] for m in M["end_to_end"] if reports(m, cell)]
    layer = [m for m in M["per_layer"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    # each per-layer metric's end-to-end metric is reported beside it
    assert all(m["moves"] in e2e for m in layer)


def test_layer_names_are_consistent():
    e2e = {m["name"] for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", cells)) <= cells
    for m in M["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    # a share of a roofline or of the peak is named so
    for m in M["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_no_width_is_reduced():
    width = re.compile(r"(hidden_size|intermediate_size|latent|state_size"
                       r"|proj|head_dim|_dim$|_rank$|experts_per_tok"
                       r"|expansion)")
    for c in M["configs"]:
        assert not any(width.search(k) for k in c["reduced"])
