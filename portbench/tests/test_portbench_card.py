"""On the card (marked ``cuda``; skips elsewhere): for each cell at its own
size, the program's first steps read within the cell's limits and the
control (the reference with TF32 in its matrix products, put in the
program's place) reads outside them.  Run on the chip with
``python -m pytest -q -m cuda portbench/tests``."""

import json
import os

import pytest

from portbench import bench, calibrate, check

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    WORKLOADS = [w["name"] for w in json.load(fh)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_and_control_fails(cuda_device, workload):
    cell = bench.load_cell(ROOT, workload)
    driver, reference = bench.load_parts(cell)
    limits = check.load_limits(ROOT, workload)
    seed = 2**31 + 11
    prog, batches, meshes, lr = calibrate.program_steps(cell, driver, seed, cuda_device)
    ref = bench.reference_steps(reference, cell, meshes, batches, lr, cuda_device)
    ok, compared = check.judge(check.gaps(prog, ref), limits)
    assert ok, compared
    low = bench.reference_steps(reference, cell, meshes, batches, lr, cuda_device, tf32=True)
    ok, compared = check.judge(check.gaps(low, ref), limits)
    assert not ok, compared
