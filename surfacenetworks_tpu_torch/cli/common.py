"""Shared trainer utilities (counterpart of ``surfacenetworks_tpu/cli/common.py``):
the run's log file, the per-epoch metrics file, the run's config file
(``config.dump_config``), the environment line and the parameter count
every trainer logs at its start, the curves drawn from the metrics file
after each test epoch (``MetricsLogger.plot``), the one-step-delayed metric
fetch, the epoch and the size-tiered samplers, the throughput meter, and the
start of a run's ranks, ``--multihost`` included (``run_grid``,
``log_multihost``).  Each writes the same files and lines as the JAX
package's.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time

import numpy as np

from surfacenetworks_tpu_torch.config import dump_config  # noqa: F401  (the trainers' one config writer)


def make_logger(result_prefix: str, log_dir: str | None, debug: bool = False):
    """``log(msg)`` prints ``<prefix>::msg`` and appends ``msg`` to
    ``<log_dir>/<prefix>.log``; with ``debug`` (or no ``log_dir``) it prints
    to stderr and writes no file."""

    def log(stuff) -> None:
        msg = f"{result_prefix}::{stuff}"
        if debug or log_dir is None:
            print(msg, file=sys.stderr)
        else:
            print(msg, flush=True)
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, f"{result_prefix}.log"), "a") as fp:
                print(stuff, file=fp)

    return log


def log_environment(log, device) -> None:
    """The host and device report every trainer logs at its start (the
    JAX package's hostname and ``jax.devices()`` lines): the hostname, then
    torch, CUDA, the run's device and the count of CUDA devices."""
    import torch

    log(f"hostname {platform.node()}")
    name = f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    log(f"devices torch {torch.__version__}, CUDA {torch.version.cuda}, device {device}{name}, "
        f"{count} CUDA device{'' if count == 1 else 's'}")


def count_params(model) -> int:
    """The number of parameter values of ``model``."""
    return sum(p.numel() for p in model.parameters())


class MetricsLogger:
    """``write(epoch, split, **metrics)`` appends one JSON line to
    ``<log_dir>/<prefix>.metrics.jsonl`` (nothing with ``debug``).  NaNs are
    written as they are, so a diverged run shows in the record.  ``plot()``
    redraws ``<prefix>_curves.png`` from the whole file (``viz.plot_curves``,
    matplotlib); any error, matplotlib missing included, returns None, so
    drawing never stops a run."""

    def __init__(self, result_prefix: str, log_dir: str | None, debug: bool = False):
        self.path = None
        if not debug and log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{result_prefix}.metrics.jsonl")

    def write(self, epoch: int, split: str, **metrics) -> None:
        if self.path is None:
            return
        record = {"epoch": int(epoch), "split": split, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as fp:
            fp.write(json.dumps(record) + "\n")

    def plot(self) -> str | None:
        if self.path is None:
            return None
        try:
            from surfacenetworks_tpu_torch import viz

            return viz.plot_curves(self.path)
        except Exception:  # drawing must never end a training run
            return None


class MetricFetcher:
    """One-step-delayed fetch of device scalars: ``push`` returns the
    previous step's floats (None on the first call), so the host converts
    step t's metrics while the device runs step t+1; ``flush`` drains the
    last step."""

    def __init__(self):
        self._pending = None

    def push(self, *device_scalars):
        prev = self._pending
        self._pending = device_scalars
        return tuple(float(x) for x in prev) if prev is not None else None

    def flush(self):
        prev, self._pending = self._pending, None
        return tuple(float(x) for x in prev) if prev is not None else None


class EpochSampler:
    """Batches in a fixed order per epoch, reshuffled (numpy
    ``default_rng(seed)``) each time the items run out; a batch may span the
    end of one epoch and the start of the next."""

    def __init__(self, items, batch_size: int, shuffle: bool = True, seed: int = 17):
        self.items = list(items)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.pos = 0
        if shuffle:
            self.rng.shuffle(self.items)

    def next_batch(self) -> list:
        out = []
        while len(out) < self.batch_size:
            if self.pos >= len(self.items):
                self.pos = 0
                if self.shuffle:
                    self.rng.shuffle(self.items)
            out.append(self.items[self.pos])
            self.pos += 1
        return out


class TieredSampler:
    """Size-tiered batch sampler for ``--buckets N``: the samples are grouped
    by their ``BucketSet`` tier, so a batch never mixes tiers and pads to its
    own tier's bucket.  Each draw picks a group with probability
    proportional to its size (numpy ``default_rng(seed)``), then that
    group's ``EpochSampler`` (seeded ``seed + tier``) gives the batch: the
    JAX package's draws."""

    def __init__(self, items, bucketset, batch_size: int, shuffle: bool = True, seed: int = 17):
        groups: dict = {}
        for s in items:
            groups.setdefault(bucketset.tier_index([s]), []).append(s)
        self.samplers = {k: EpochSampler(v, batch_size, shuffle=shuffle, seed=seed + k) for k, v in groups.items()}
        self.keys = sorted(groups)
        sizes = np.asarray([len(groups[k]) for k in self.keys], np.float64)
        self.weights = sizes / sizes.sum()
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> list:
        k = self.keys[int(self.rng.choice(len(self.keys), p=self.weights))]
        return self.samplers[k].next_batch()


class Throughput:
    """Steps per second and vertices per second since construction."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.items = 0

    def tick(self, items: int = 0) -> None:
        self.steps += 1
        self.items += items

    @property
    def steps_per_s(self) -> float:
        return self.steps / max(time.perf_counter() - self.t0, 1e-9)

    def report(self) -> str:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return f"{self.steps / dt:.2f} steps/s, {self.items / dt:.0f} vertices/s"


def process_index(args) -> int:
    """This process's index among a ``--multihost`` run's launches (0
    without ``--multihost``; torchrun's ``RANK`` without coordinator
    flags)."""
    if not getattr(args, "multihost", False):
        return 0
    if args.process_id is not None:
        return args.process_id
    return int(os.environ.get("RANK", 0))


def run_grid(run, n_data: int, n_graph: int, args):
    """A trainer's ``run(mesh, args)`` on its ``(n_data, n_graph)`` grid of
    ranks: started here (``mesh_setup.run_ranks``), or with ``--multihost``
    this process's share of it, met with the other launches at the
    coordinator (``mesh_setup.launch_multihost``; the counterpart of the JAX
    trainers' ``maybe_initialize_multihost``).  The coordinator flags are
    read only with ``--multihost``, as in the JAX package."""
    from surfacenetworks_tpu_torch.dist import mesh_setup

    if getattr(args, "multihost", False):
        return mesh_setup.launch_multihost(run, n_data, n_graph, args.coordinator_address, args.num_processes,
                                           args.process_id, device=args.device, args=(args,))
    return mesh_setup.run_ranks(run, n_data, n_graph, args.device, args)


def log_multihost(log, mesh) -> None:
    """The JAX trainers' line of a ``--multihost`` run: ``multihost: process
    i/P, N global devices (n local)`` (a device is a rank's card)."""
    if mesh is not None and mesh.processes is not None:
        pid, processes, local = mesh.processes
        import torch.distributed as dist

        log(f"multihost: process {pid}/{processes}, {dist.get_world_size()} global devices ({local} local)")
