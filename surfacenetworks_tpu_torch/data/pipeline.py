"""Pack-once batches and the device-resident dataset (counterpart of
``surfacenetworks_tpu/data/pipeline.py``: ``OperatorCache``'s pack-once
role, ``DeviceDataset`` and ``IndexedBatch``).

``PackedSamples`` packs each sample's single-sample ``MeshBatch`` once on
the host; a host batch stacks the packed samples.  ``DeviceDataset`` stacks
every sample into ``[S, ...]`` tensors (operators included) and uploads them
once; a batch is then an ``index_select`` of its rows on the device, so a
step sends only its ``[B]`` indices.  Over the budget (the JAX package's 6
GiB) ``DeviceDataset.build`` returns None and the trainer assembles each
batch on the host and uploads it.  Both paths run the step on the device.
Samples are keyed by the object (sample dicts) or, with ``value_keys``, by
their value (the ARAP trainer's (sequence, offset) picks: the JAX package's
``value_keys=True``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from surfacenetworks_tpu_torch.data.batching import MeshBatch

DEVICE_BUDGET_BYTES = 6 << 30
_FIELDS = ("inputs", "targets", "mask", "operator")  # what a step reads


def _concat(objs: list) -> Any:
    """Concatenate along the leading axis, field by field through operator
    dataclasses and tuples.  An int field (a column count, a banded-window
    bound) takes the members' largest."""
    first = objs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(objs, dim=0)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{f.name: _concat([getattr(o, f.name) for o in objs])
                                            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        return tuple(_concat(list(parts)) for parts in zip(*objs))
    if isinstance(first, int):
        return max(objs)
    if first is None:
        return None
    raise TypeError(f"cannot concatenate {type(first).__name__}")


def _take(obj: Any, idx: torch.Tensor) -> Any:
    """Rows ``idx`` of every tensor's leading axis, through operator
    dataclasses and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.index_select(0, idx)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _take(getattr(obj, f.name), idx) for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_take(o, idx) for o in obj)
    return obj


def _nbytes(obj: Any) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, tuple):
        return sum(_nbytes(o) for o in obj)
    return 0


def _to(obj: Any, device) -> Any:
    if isinstance(obj, tuple):
        return tuple(_to(o, device) for o in obj)
    return obj.to(device)


def to_device(batch: MeshBatch, device) -> MeshBatch:
    """A host batch's tensors and operator (a tensor, an operator dataclass
    or a dense Dirac pair) on ``device`` (an operator's own ``to`` checks its
    indices on the host first)."""
    return MeshBatch(inputs=batch.inputs.to(device), targets=batch.targets.to(device), mask=batch.mask.to(device),
                     operator=_to(batch.operator, device), names=batch.names)


class PackedSamples:
    """Each sample's single-sample batch, built by ``build_one(sample)`` on
    first use and kept.  A sample is keyed by the object, which is held
    (sample dicts), or with ``value_keys`` by its value (hashable items such
    as the ARAP trainer's (sequence, offset) picks)."""

    def __init__(self, build_one: Callable[[Any], MeshBatch], value_keys: bool = False):
        self._build = build_one
        self.value_keys = value_keys
        self._store: dict[Any, tuple[Any, MeshBatch]] = {}

    def key(self, sample: Any) -> Any:
        return sample if self.value_keys else id(sample)

    def one(self, sample: Any) -> MeshBatch:
        k = self.key(sample)
        hit = self._store.get(k)
        if hit is None or not (self.value_keys or hit[0] is sample):
            hit = (sample, self._build(sample))
            self._store[k] = hit
        return hit[1]

    def batch(self, samples: list[dict]) -> MeshBatch:
        """The host batch of ``samples``, stacked from their packed singles."""
        singles = [self.one(s) for s in samples]
        return MeshBatch(**{k: _concat([getattr(b, k) for b in singles]) for k in _FIELDS},
                         names=[n for b in singles for n in b.names])


@dataclasses.dataclass
class IndexedBatch:
    """A device dataset and the rows of one batch; ``gather`` assembles the
    batch on the device."""

    tree: MeshBatch
    idx: torch.Tensor  # int64 [B] on the dataset's device
    names: list

    def gather(self) -> MeshBatch:
        return MeshBatch(**{k: _take(getattr(self.tree, k), self.idx) for k in _FIELDS}, names=self.names)


class DeviceDataset:
    """Every sample's packed batch, stacked ``[S, ...]`` and uploaded once;
    samples are keyed as ``PackedSamples`` keys them."""

    def __init__(self, tree: MeshBatch, items: list, key: Callable[[Any], Any] = id):
        self.tree = tree
        self.items = items  # held, so id() keys stay valid
        self._key = key
        self._index_of = {key(s): i for i, s in enumerate(items)}

    @classmethod
    def build(cls, items: list, packed: PackedSamples, device,
              budget_bytes: int = DEVICE_BUDGET_BYTES) -> "DeviceDataset | None":
        """None when the stacked dataset exceeds ``budget_bytes``."""
        items = list(items)
        host = packed.batch(items)
        if sum(_nbytes(getattr(host, k)) for k in _FIELDS) > budget_bytes:
            return None
        return cls(to_device(host, device), items, packed.key)

    def batch(self, items: list) -> IndexedBatch:
        idx = np.asarray([self._index_of[self._key(s)] for s in items], np.int64)
        return IndexedBatch(self.tree, torch.from_numpy(idx).to(self.tree.inputs.device),
                            [self.tree.names[i] for i in idx])

    def stats(self) -> str:
        nbytes = sum(_nbytes(getattr(self.tree, k)) for k in _FIELDS)
        return f"device dataset: {len(self.items)} samples, {nbytes / 1e6:.1f} MB resident"
