"""BENCHMARK.json against its contract, and every cell's files found by
name."""

import json
import os
import re
import shutil

import pytest

from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_names_and_units(root):
    b = _bench(root)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]] + [k for c in b["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES, m
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    moves = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in moves and m["layer"] and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])


def test_every_cell_finds_its_files(root):
    b = _bench(root)
    for w in b["workloads"]:
        cell = bench.load_cell(root, w["name"])
        driver, reference = bench.load_parts(cell)
        assert hasattr(driver, "Session") and hasattr(reference, "build")
        limits = bench.check.load_limits(root, w["name"])
        assert set(limits) == set(bench.check.NUMBERS) and any(v is not None for v in limits.values())
        for m in cell.metrics:
            assert hasattr(bench.metric_reader(root, m["name"]), "read")
        assert cell.config["name"] == w["config"]
    for c in b["configs"]:
        assert c["file"].startswith("portbench/")
        with open(os.path.join(root, c["file"])) as fh:
            conf = json.load(fh)
        assert conf["reduced"] == c["reduced"]


def test_new_traffic_is_data_alone(root, tmp_path):
    """A cell added by files alone: a copy of the benchmark gains a traffic
    mix and a workload, and the harness resolves it without an edit."""
    shutil.copytree(os.path.join(root, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench(root)
    b["workloads"].append({"name": "lap15-dummy", "config": "lap15", "traffic": "dummy", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench" / "traffic" / "dummy.json").write_text(json.dumps(
        {"trainer": "train_normal", "train_meshes": 2, "test_meshes": 1, "vertices": 64, "test_path": True,
         "flags": ["--batch-size", "2"]}))
    (tmp_path / "portbench" / "limits" / "lap15-dummy.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1.0}}))
    cell = bench.load_cell(str(tmp_path), "lap15-dummy")
    assert cell.traffic["vertices"] == 64 and cell.config["preset"] == "normal-lap"
    assert {m["name"] for m in cell.metrics} == {m["name"] for m in b["per_layer"] if "workloads" not in m}
    with pytest.raises(SystemExit):
        bench.load_cell(str(tmp_path), "no-such-cell")
