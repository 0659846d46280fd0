"""Shared trainer utilities (counterpart of ``surfacenetworks_tpu/cli/common.py``
and ``config.py::dump_config``): the run's log file, the per-epoch metrics
file, the run's config file, the epoch and the size-tiered samplers and the
throughput meter.
Each writes the same files and lines as the JAX package's.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


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


def dump_config(args, path: str) -> None:
    """The run's parsed flags as JSON at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fp:
        json.dump({k: v for k, v in vars(args).items() if not k.startswith("_")}, fp, indent=2, default=str)


class MetricsLogger:
    """``write(epoch, split, **metrics)`` appends one JSON line to
    ``<log_dir>/<prefix>.metrics.jsonl`` (nothing with ``debug``).  NaNs are
    written as they are, so a diverged run shows in the record."""

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
