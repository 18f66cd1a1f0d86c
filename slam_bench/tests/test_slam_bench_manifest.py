"""BENCHMARK.json against the contract, and every name it holds found as a
file of the benchmark."""

import importlib
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16 and all(os.path.isdir(os.path.join(ROOT, p)) for p in b["paths"])
    assert len(b["command"]) <= 32
    n = len(b["workloads"])
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200 or n < 24
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(x) for x in names)
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    b = manifest()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b[kind]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            reader = importlib.import_module(f"slam_bench.metrics.{m['name']}")
            assert callable(reader.read)
    assert "setup_s" in e2e


def test_cells_find_their_files():
    b = manifest()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and NAME.match(w["traffic"])
        c = configs[w["config"]]
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, "slam_bench", "traffic", f"{w['traffic']}.json"))
        for module in (f"entries.{cfg['entry']}", f"reference.{cfg['reference']}"):
            importlib.import_module(f"slam_bench.{module}")
        assert cfg["limits"] and set(cfg["floors"]).isdisjoint(cfg["limits"])
    assert {w["config"] for w in b["workloads"]} == set(configs)
