"""A whole run of a tiny cell on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: a sound run reads
``correct`` true, and each fault that a training cell can have reads it
false.  The tiny cell is added to a copy of the benchmark as files alone."""

import json
import os
import shutil
import time

import pytest

from portbench import bench, faults


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(os.path.join(here, "portbench"), root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(here, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    with open(os.path.join(here, "portbench", "configs", "lap15.json")) as fh:
        conf = json.load(fh)
    (root / "portbench" / "configs" / "lap3.json").write_text(json.dumps({**conf, "layers": 3}))
    b["configs"].append({"name": "lap3", "source": "https://arxiv.org/abs/1705.10819",
                         "file": "portbench/configs/lap3.json", "reduced": ["dataset"], "why": "a test"})
    b["workloads"].append({"name": "lap3-tiny", "config": "lap3", "traffic": "tiny", "chips": 1, "why": "a test"})
    b["workloads"].append({"name": "lap3-mixed", "config": "lap3", "traffic": "tiny-mixed", "chips": 1,
                           "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    # the mixed mix's batches of 2 are padded to sizes of their own
    for traffic, vertices, batch in (("tiny", 120, 4), ("tiny-mixed", [100, 300, 120], 2)):
        (root / "portbench" / "traffic" / f"{traffic}.json").write_text(json.dumps(
            {"trainer": "train_normal", "train_meshes": 4, "test_meshes": 1, "vertices": vertices, "test_path": True,
             "flags": ["--batch-size", str(batch)]}))
    # limits for this size on the CPU: sound runs read at most 2e-3 (loss), 1e-3 (gradient), 2e-2 (change)
    for workload in ("lap3-tiny", "lap3-mixed"):
        (root / "portbench" / "limits" / f"{workload}.json").write_text(json.dumps(
            {"limits": {"loss_gap": 0.02, "loss1_gap": None, "grad_gap": 0.05, "grad_median_gap": None,
                        "change_gap": 0.5}}))
    (root / "portbench" / "reference" / "lap3.py").write_text(
        (root / "portbench" / "reference" / "lap15.py").read_text())
    return str(root)


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"])
def test_a_fault_reads_not_correct(tiny_root, fault):
    import torch

    torch.set_num_threads(2)
    cell = bench.load_cell(tiny_root, "lap3-tiny")
    result = bench.run_cell(cell, 2**40 + 3, 0.3, False, "cpu", time.perf_counter(), log=lambda m: None,
                            fault=faults.FAULTS[fault] if fault else None)
    assert result.correct is (fault is None), result.compared
    assert result.attempted >= 1 and result.failed == 0
    assert set(result.metrics) == {"train_meshes_per_s", "peak_mem_gib", "setup_s"}
    line = json.loads(json.dumps(result.line()))
    assert list(line)[-1] == "compared"


def test_meshes_of_several_sizes_traced(tiny_root):
    """A traffic of several mesh sizes, added as a file alone, runs and
    reads correct; its traced run reads the per-layer metrics that a run
    without a card can read (the host's work, the whole step's share)."""
    import torch

    torch.set_num_threads(2)
    cell = bench.load_cell(tiny_root, "lap3-mixed")
    result = bench.run_cell(cell, 2**40 + 4, 0.3, True, "cpu", time.perf_counter(), log=lambda m: None)
    assert result.correct, result.compared
    assert {"host_ms_per_step.train", "step_mfu.train"} <= set(result.metrics)
    assert "lap_apply_roofline.train" not in result.metrics  # no kernel of the card ran
    assert 0 < result.metrics["host_ms_per_step.train"]["value"] and result.device["window_s"] > 0
