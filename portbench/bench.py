"""One run of one cell: set-up, the timed window, the traced window's
per-layer metrics, and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<mix>.json``, ``drivers/<trainer>.py`` (the traffic's
``trainer``), ``reference/<config>.py``, ``limits/<workload>.json`` and
``metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Callable


from portbench import check, work

WARMUP_UPDATES = 2  # after the check's updates, before the window
BATCHES_AHEAD = 1 << 40  # the feed's length: the window ends by the clock


@dataclasses.dataclass
class Cell:
    root: str
    workload: dict
    config: dict
    traffic: dict
    metrics: list  # the per-layer metrics of BENCHMARK.json that this cell reports

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_cell(root: str, workload: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json")) as fh:
        traffic = json.load(fh)
    metrics = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return Cell(root, w, {**config, "name": conf["name"]}, traffic, metrics)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up while the file runs
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: str, metric: str):
    return load_file_module(os.path.join(root, "portbench", "metrics", f"{metric}.py"), f"portbench_metric_{metric}")


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    cell: Cell
    window_s: float
    updates: list  # the benchmark's meshes (their indices) in each update of the window
    mesh_sizes: list  # (vertices, faces, edges) of every mesh of the run
    trace: Any = None  # trace.Trace of the window

    @property
    def steps(self) -> int:
        """Updates in the window."""
        return len(self.updates)

    def update_sums(self, per_mesh: Callable) -> list:
        """For each update of the window, ``per_mesh(vertices, faces,
        edges)`` (a tuple of numbers) summed over the update's meshes."""
        return [tuple(map(sum, zip(*(per_mesh(*self.mesh_sizes[i]) for i in idx)))) for idx in self.updates]

    def window_flops(self) -> int:
        """Model operations of every update in the window
        (``work.deep_model_flops`` of each mesh)."""
        c = self.cell.config
        return sum(f for f, in self.update_sums(
            lambda v, f, e: (work.deep_model_flops(c["operator"], c["layers"], c["width"], v, f, e),)))

    def patterns(self, metric: str) -> list[str]:
        """The union of the name patterns (one regular expression a line)
        in every file of the metric's own folder."""
        folder = os.path.join(self.cell.root, "portbench", "metrics", metric)
        out = []
        for name in sorted(os.listdir(folder)):
            with open(os.path.join(folder, name)) as fh:
                out += [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]
        return out


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    compared: dict
    breakdown: dict | None = None

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["compared"] = self.compared
        return out


UNITS = {"train_meshes_per_s": "meshes/s", "peak_mem_gib": "GiB", "setup_s": "s"}


def load_parts(cell: Cell):
    """The cell's driver (the system under test) and reference modules."""
    trainer = cell.traffic["trainer"]
    driver = load_file_module(os.path.join(cell.root, "portbench", "drivers", f"{trainer}.py"),
                              f"portbench_driver_{trainer}")
    reference = load_file_module(os.path.join(cell.root, "portbench", "reference", f"{cell.config['name']}.py"),
                                 f"portbench_reference_{cell.config['name']}")
    return driver, reference


def start_session(cell: Cell, driver, seed: int, device: str, workdir: str, fault: Callable | None = None,
                  log=lambda msg: None):
    """Set-up up to the window: the program's trainer over the run's
    meshes, driven through its first ``check.CHECK_STEPS`` updates by the
    window's own feed and call, with the check's snapshots taken.  Returns
    the session, the feed (which the window goes on with), the capture and
    the padded (rows, faces) of a batch."""
    t = time.perf_counter()
    session = driver.Session(cell.config, cell.traffic, seed, device, workdir, lambda m: None)
    log(f"set-up: meshes and trainer {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    if fault is not None:
        fault(session)
    feed = session.batches(BATCHES_AHEAD)
    capture = check.ProgramCapture(session.model, session.opt)
    for _ in range(check.CHECK_STEPS):
        batch = next(feed)
        capture.after_update(session.update(batch), (session.mesh_indices(batch), *session.padded_sizes(batch)))
    log(f"set-up: the check's {check.CHECK_STEPS} updates {time.perf_counter() - t:.1f} s")
    return session, feed, capture


def end_session(session, feed, device: str) -> None:
    """Frees the program's state on the device (the reference runs after)."""
    import torch

    feed.close()
    session.close()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()


def reference_steps(reference, cell: Cell, meshes: list, batches: list, lr: float, device: str, tf32: bool = False,
                    dtype=None):
    """The reference's first steps on the program's batches (each its
    meshes and the rows and faces the program padded them to); ``tf32``
    computes its matrix products in TF32 (the control)."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        dtype = dtype or torch.float32
        return reference.build(cell.config, meshes, device, dtype).steps(batches, lr)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float, log=None,
             fault: Callable | None = None, workdir: str | None = None) -> Result:
    """One run.  ``t0`` is the process's start on ``time.perf_counter``.
    ``fault`` (tests only) gets the session once set-up has built it and
    may break the timed path underneath."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    driver, reference = load_parts(cell)
    limits = check.load_limits(cell.root, cell.name)
    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="portbench-")
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    try:
        session, feed, capture = start_session(cell, driver, seed, device, workdir, fault, log)
        for _ in range(WARMUP_UPDATES):
            session.update(next(feed))
        sync()
        from surfacenetworks_tpu_torch.sparse import kernels as port_kernels

        readers = {m["name"]: metric_reader(cell.root, m["name"]) for m in cell.metrics} if trace else {}
        instruments = [r.instrument() for r in readers.values() if hasattr(r, "instrument")]
        for inst in instruments:
            inst.__enter__()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        launched = dict(port_kernels.launches)
        losses, updates = [], []
        record = torch.profiler.record_function
        t_start = time.perf_counter()
        setup_s = t_start - t0
        while True:
            with record("portbench:host:batch"):
                batch = next(feed)
            with record("portbench:host:update"):
                losses.append(session.update(batch))
            updates.append(session.mesh_indices(batch))
            if time.perf_counter() - t_start >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t_start
        if prof is not None:
            prof.__exit__(None, None, None)
        for inst in reversed(instruments):
            inst.__exit__(None, None, None)
        launched = {k: port_kernels.launches[k] - v for k, v in launched.items() if port_kernels.launches[k] != v}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        attempted = len(losses)
        del losses, batch
        program = capture.steps()
        batches = capture.batches
        meshes = session.meshes
        lr = session.lr
        end_session(session, feed, device)
        del session, feed, capture
        mesh_sizes = [(V.shape[0], F.shape[0], work.mesh_edges(F)) for V, F in meshes]
        metrics = {}
        breakdown = None
        ctx = Context(cell, window_s, updates, mesh_sizes)
        if trace:
            from portbench.trace import Trace

            t_read = time.perf_counter()
            ctx.trace = Trace(prof)
            del prof
            for m in cell.metrics:
                value = readers[m["name"]].read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = {"device_ops": ctx.trace.top_ops(), "idle_gaps": ctx.trace.idle_gaps()}
            log(f"trace read in {time.perf_counter() - t_read:.1f} s: {len(ctx.trace.ops)} device operations, "
                f"{ctx.trace.unlinked} not linked to a launch")
            log(f"port launches in the window: {launched} by the counters, {ctx.trace.port_launches()} in the trace "
                f"({attempted} updates)")
            host_work, host_wall = ctx.trace.host_work_s()
            log(f"host spans: {host_wall / attempted * 1e3:.2f} ms an update, of which waits on the device "
                f"{(host_wall - host_work) / attempted * 1e3:.2f} ms")
        else:
            values = {"train_meshes_per_s": sum(map(len, updates)) / window_s, "peak_mem_gib": peak / 2**30,
                      "setup_s": setup_s}
            metrics = {k: {"value": v, "unit": UNITS[k]} for k, v in values.items()}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
        if trace:
            dev["busy_s"] = ctx.trace.busy_s()
            dev["window_s"] = window_s
        # the reference, after the window, with the program's state freed
        t_ref = time.perf_counter()
        ref_steps = reference_steps(reference, cell, meshes, batches, lr, device)
        numbers = check.gaps(program, ref_steps)
        correct, compared = check.judge(numbers, limits)
        correct = correct and failed == 0
        log(f"reference: {time.perf_counter() - t_ref:.1f} s; program losses {program.losses}, reference "
            f"{ref_steps.losses}; worst leaves {numbers['leaves']}")
        return Result(correct, attempted, failed, metrics, dev, compared, breakdown)
    finally:
        if own_tmp:
            shutil.rmtree(workdir, ignore_errors=True)


def banned_modules() -> list[str]:
    """JAX, its libraries and the JAX package among the loaded modules, by
    whole top-level name."""
    banned = {"jax", "jaxlib", "flax", "optax", "surfacenetworks_tpu"}
    return sorted({name.split(".")[0] for name in sys.modules} & banned)

