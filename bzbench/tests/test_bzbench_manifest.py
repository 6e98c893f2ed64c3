"""BENCHMARK.json against the benchmark's contract, and the harness's lookup
by name: every name, unit and line within its allowed characters, every
file the manifest names present, every cell reporting what it must."""
import json
import os
import re

from bzbench import run

REPO = run.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(REPO, word)):  # a file it names lies under paths
            assert any(word.startswith(p + "/") for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    b = bench()
    assert 1 <= len(b["configs"]) <= 24
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert c["file"] == f"bzbench/configs/{c['name']}.json" and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])


def test_workloads():
    b = bench()
    assert 1 <= len(b["workloads"]) <= 24
    pairs = set()
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(REPO, "bzbench", "traffic", w["traffic"] + ".json"))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)


def test_metrics():
    b = bench()
    names = set()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m["workloads"]) <= cells if "workloads" in m else True
        assert os.path.exists(os.path.join(REPO, "bzbench", "metrics", m["name"] + ".py"))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"]) and m["moves"] in e2e and m["moves"] != "setup_s"
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    # each cell reports setup_s, another end-to-end metric and a per-layer
    # one, and every per-layer metric's cells report the metric it moves
    for cell in cells:
        ends = {m["name"] for m in run.metric_specs(b, cell, False)}
        layers = run.metric_specs(b, cell, True)
        assert "setup_s" in ends and len(ends) >= 2 and layers
        assert all(m["moves"] in ends for m in layers)


def test_layers_named_alike():
    """Metrics of one module give its layer letter for letter."""
    b = bench()
    by_prefix = {}
    for m in b["per_layer"]:
        by_prefix.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())
