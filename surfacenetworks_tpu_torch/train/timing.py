"""Device-synchronised timing, profiler traces and throughput meters
(counterpart of ``surfacenetworks_tpu/train/timing.py``).

The reference's ``utils/timer_utils.py:4-22`` (``timer`` / ``cutimer``:
wall-clock prints around ``torch.cuda.synchronize``): CUDA launches are
asynchronous, so ``device_timer`` synchronises the device of the values
made in the region before it reads the clock.  ``trace`` records a
``torch.profiler`` trace of a region (CPU and CUDA activities) as a
Chrome-trace JSON file; ``train_normal --jax-profile DIR`` traces its first
trained epoch through it.  The interesting rates are steps/s and edges/s
(``ThroughputMeter``).  ``span`` (from ``spans.py``, re-exported here)
names the port's layers inside such a trace: it opens a profiler range only
while the profiler records, and counts every span in ``span_counts``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from dataclasses import dataclass, field

from surfacenetworks_tpu_torch.spans import reset_span_counts, span, span_counts  # noqa: F401


def time_string() -> str:
    """Timestamp for log and checkpoint names (the reference's
    ``time_string``, utils/timer_utils.py:20-22)."""
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def _tensors(tree) -> list:
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def synchronize(target) -> None:
    """Wait for the CUDA devices that hold the tensors of ``target`` (a
    tensor or a list, tuple or dict of them); CPU tensors need no wait."""
    import torch

    for dev in {t.device for t in _tensors(target) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_timer(name: str = "", sync=None, log=print):
    """Wall-clock a region, synchronising at its exit on ``sync`` (or on
    ``box["sync"]`` set inside the region) so asynchronous CUDA work is
    included: the ``cutimer`` counterpart.  ``sync`` is a tensor (or a
    list, tuple or dict of them), whose devices are waited for, or a
    zero-argument callable returning them, which is called at the exit and
    then the current CUDA device waited for (the values may be made inside
    the region).  On the CPU nothing is waited for.  The seconds are kept
    as ``box["seconds"]``, and logged as ``[name] ... ms`` when ``name``
    is given."""
    import torch

    box: dict = {}
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        target = box.get("sync", sync)
        if callable(target):
            target = target()
            synchronize(target)
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        elif target is not None:
            synchronize(target)
        box["seconds"] = dt = time.perf_counter() - t0
        if name and log is not None:
            log(f"[{name}] {dt * 1e3:.3f} ms")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the enclosed region (CPU activities, and
    CUDA ones where a card is present), written at its exit as a
    Chrome-trace JSON file ``trace_<time>_<pid>.json`` in ``log_dir``
    (open it in Perfetto or ``chrome://tracing``; no tensorboard needed).
    Yields a dict whose ``"path"`` is set to the file once written.  With
    CUDA up the device is synchronised before the trace stops, so the
    region's last kernels are in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    box: dict = {}
    with profile(activities=activities) as prof:
        yield box
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    box["path"] = os.path.join(log_dir, f"trace_{time_string()}_{os.getpid()}.json")
    prof.export_chrome_trace(box["path"])


@dataclass
class ThroughputMeter:
    """Steps/s and edges/s meter for training loops.

    ``edges_per_step``: nnz of the batched operator x applications per step
    (forward + backward); callers pass whatever accounting they want: the
    meter only divides by elapsed time.  Rates use a window since
    ``reset()``, so warm-up can be excluded by resetting after step 0.
    """

    edges_per_step: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)
    _steps: int = 0

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1) -> None:
        self._steps += n

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_s(self) -> float:
        return self._steps / max(self.seconds, 1e-12)

    @property
    def edges_per_s(self) -> float:
        return self.steps_per_s * self.edges_per_step

    def summary(self) -> dict:
        return {
            "steps": self._steps,
            "seconds": round(self.seconds, 4),
            "steps_per_s": round(self.steps_per_s, 3),
            "edges_per_s": round(self.edges_per_s, 1),
        }
