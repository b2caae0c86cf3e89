"""BENCHMARK.json against the format's limits on names, units and files."""
import json
import os
import re

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def manifest():
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def test_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in m["paths"])
    assert len(m["command"]) <= 32 and 1 <= m["run_seconds"] <= 51
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(m["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    metric_names = []
    for x in m["end_to_end"] + m["per_layer"]:
        assert x["better"] in ("lower", "higher")
        assert UNIT.match(x["unit"]), x["unit"]
        metric_names.append(x["name"])
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in {e["name"] for e in m["end_to_end"]}
    names += metric_names
    assert all(NAME.match(n) for n in names), names
    assert len(set(metric_names)) == len(metric_names)
    assert "setup_s" in metric_names
    for x in m["end_to_end"] + m["per_layer"] + m["configs"] \
            + m["workloads"]:
        for key in ("why", "layer", "source"):
            if key in x:
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key]


def test_every_cell_finds_its_files():
    m = manifest()
    for w in m["workloads"]:
        spec = harness.cell_spec(w["name"], m)
        assert spec["config"]["name"] == w["config"]
        assert {x["name"] for x in spec["end_to_end"]} >= {"setup_s"}
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        for x in spec["per_layer"]:
            assert hasattr(harness.reader(x["name"]), "read")
        cfg = spec["config"]
        assert hasattr(harness.module("programs", cfg["program"]), "build")
        assert hasattr(harness.module("checks", cfg["checks"]), "compare")
        gen = harness.module("generators", spec["traffic"]["kind"])
        assert all(hasattr(gen, f) for f in ("start", "window", "profile"))
        assert set(cfg["limits"]) == {"relres_max", "cycle_rel_diff",
                                      "interp_rel_diff",
                                      "galerkin_rel_diff"}
        assert cfg["reduced"] == []


def test_config_files_are_the_manifests():
    m = manifest()
    for c in m["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
