"""Readings that the limits of ``correct`` are set from, for one cell at
its own size, all in one process: for each seed the program's first steps
against the reference (the sound runs), the control (the reference with
TF32 on in its matrix products, put in the program's place) and the faults
of ``faults.py`` planted in the program::

    python3 portbench/calibrate.py --workload lap15-normal-b32 --seeds 1,2,3 \\
        --control-seeds 1,2,3 --faults half_batch --out calib.jsonl

Each reading is one JSON line (to ``--out`` and standard output): the
workload, the seed, which run, and the numbers ``check.gaps`` compares;
with ``--fp64`` also the fp32 reference against an fp64 one (the look at
what fp32 itself reads) and the meshes' largest Laplacian entry and
smallest triangle.  A card is required, as for ``run.py``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def program_steps(cell, driver, seed, device, fault=None):
    """The program's first steps (and what the reference needs to follow
    them), its state freed afterwards."""
    from portbench import bench

    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        session, feed, capture = bench.start_session(cell, driver, seed, device, workdir, fault)
        out = capture.steps(), capture.batches, session.meshes, session.lr
        bench.end_session(session, feed, device)
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="", help="comma-separated names of faults.FAULTS")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fp64", action="store_true", help="also read the reference in float64 (the look)")
    args = parser.parse_args(argv)

    import torch

    from portbench import bench, check, faults
    from portbench.reference import plain

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell = bench.load_cell(ROOT, args.workload)
    driver, reference = bench.load_parts(cell)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    planted = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None

    def emit(seed, run, got=None, against=None, extra=None):
        row = {"workload": cell.name, "seed": seed, "run": run}
        if got is not None:
            numbers = check.gaps(got, against)
            leaf = numbers["leaves"]["grad_gap"]
            row.update({k: numbers[k] for k in check.NUMBERS}, loss_steps=numbers["loss_steps"],
                       leaves=numbers["leaves"],
                       grad_leaf_share=against.grad_norms[leaf] / plain.median(against.grad_norms.values()))
        row.update(extra or {})
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds:
        t = time.perf_counter()
        prog, batches, meshes, lr = program_steps(cell, driver, seed, args.device)
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        ref = bench.reference_steps(reference, cell, meshes, batches, lr, args.device)
        t_ref = time.perf_counter() - t
        emit(seed, "program", prog, ref, {"program_losses": prog.losses, "reference_losses": ref.losses,
                                          "program_s": t_prog, "reference_s": t_ref})
        if args.fp64:
            area = [plain.face_area(V, F) for V, F in meshes]
            emit(seed, "meshes", extra={"max_abs_laplacian": max(float(abs(plain.cot_laplacian(V, F).data).max())
                                                                       for V, F in meshes),
                                              "min_area_share": min(float(a.min() / a.mean()) for a in area)})
            ref64 = bench.reference_steps(reference, cell, meshes, batches, lr, args.device,
                                          dtype=torch.float64)
            emit(seed, "program_vs_ref64", prog, ref64)
            emit(seed, "ref32_vs_ref64", ref, ref64)
        if seed in control:
            low = bench.reference_steps(reference, cell, meshes, batches, lr, args.device, tf32=True)
            emit(seed, "control_tf32", low, ref, {"control_losses": low.losses})
            if args.fp64:
                emit(seed, "control_tf32_vs_ref64", low, ref64)
        for name in planted:
            bad, *_ = program_steps(cell, driver, seed, args.device, faults.FAULTS[name])
            emit(seed, name, bad, ref)
    if out:
        out.close()
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
