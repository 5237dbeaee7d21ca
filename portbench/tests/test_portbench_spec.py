"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert len(spec["command"]) <= 32
    for word in spec["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word


def test_names_and_units(spec):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    metric_names = [m["name"] for g in ("end_to_end", "per_layer")
                    for m in spec[g]]
    assert len(metric_names) == len(set(metric_names))


def test_metric_keys_and_bounds(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e


def test_every_cell_resolves(spec):
    from portbench import check, model_config, scenes
    from portbench.run import kind as kind_module, metrics_for, \
        metrics_for_e2e, reader
    configs = {c["name"]: c for c in spec["configs"]}
    used = set()
    pairs = set()
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        c = configs[w["config"]]
        used.add(c["name"])
        cfg = model_config.load(c["name"])
        assert os.path.join(ROOT, c["file"]) == os.path.join(
            ROOT, "portbench", "configs", f"{c['name']}.json")
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        kind = scenes.load(w["traffic"])["kind"]
        numbers = kind_module(kind).NUMBERS
        assert set(check.limits(w["name"])) == set(numbers)
        e2e = {m["name"] for m in metrics_for_e2e(spec, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = metrics_for(spec, w["name"])
        assert layer
        for m in layer:
            assert callable(reader(m["name"]))
            assert m["moves"] in e2e
    assert used == set(configs)
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))


def test_no_width_is_reduced(spec):
    for c in spec["configs"]:
        for key in c["reduced"]:
            assert not re.search(r"(_dim|_rank|hidden|intermediate|heads)$",
                                 key)
