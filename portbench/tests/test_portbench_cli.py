"""The command's refusals, on a machine without a card: it exits non-zero
and prints no result, in the checkout and in a directory that holds only
``BENCHMARK.json`` and the benchmark's files (no program)."""

import os
import shutil
import subprocess
import sys

import pytest


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "lap15-normal-b32", "--seed",
                           str(2**33 + 1), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def _no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")


def test_no_card_no_result(root):
    _no_card()
    r = _run(root)
    assert r.returncode != 0 and r.stdout.strip() == "", r.stdout
    assert "CUDA card" in r.stderr


def test_benchmark_files_alone_no_result(root, tmp_path):
    _no_card()
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "portbench"), tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(str(tmp_path), env)
    assert r.returncode != 0 and r.stdout.strip() == ""
