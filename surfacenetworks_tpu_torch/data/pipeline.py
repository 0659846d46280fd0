"""The host input pipeline (counterpart of ``surfacenetworks_tpu/data/pipeline.py``).

``OperatorCache`` packs each sample once and keeps the pack within a host
byte budget (8 GiB, the JAX package's), past which it passes through with
one warning: each further miss repacks.  ``PackedSamples`` holds each
sample's single-sample ``MeshBatch`` through such a cache; a host batch
stacks the packed samples.  ``DeviceDataset`` stacks every sample into
``[S, ...]`` tensors (operators included) and uploads them once; a batch is
then an ``index_select`` of its rows on the device, so a step sends only its
``[B]`` indices.  Over the device budget (the JAX package's 6 GiB)
``DeviceDataset.build`` returns None and the trainer takes the host route:
``prefetch`` (or ``prefetch_over`` a sampler) builds the next batches on a
background thread while the device runs the current step, the worker packs
each host batch into pinned memory (``pinned``) and the consumer uploads it
with non-blocking copies (``Uploads``), which hold each host batch until its
copies have passed.  Both routes run the step on the device.
``MetricAccumulator`` sums a loop's metrics on the device and fetches them
once.  Samples are keyed by the object (sample dicts) or, with
``value_keys``, by their value (the ARAP trainer's (sequence, offset)
picks: the JAX package's ``value_keys=True``).  A batch's assembly runs
inside the span ``snx:batch`` (``spans.py``): on the device route the index
upload (``DeviceDataset.batch``) and the gather (``IndexedBatch.gather``),
each a span; on the host route the wait for the worker and the upload.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import warnings
from typing import Any, Callable, Iterator

import numpy as np
import torch

from surfacenetworks_tpu_torch.data.batching import MeshBatch
from surfacenetworks_tpu_torch.spans import span

DEVICE_BUDGET_BYTES = 6 << 30
HOST_BUDGET_BYTES = 8 << 30  # OperatorCache's, as in the JAX package
_FIELDS = ("inputs", "targets", "mask", "operator", "aux")  # what a step reads


def _concat(objs: list) -> Any:
    """Concatenate along the leading axis, field by field through operator
    dataclasses, tuples and dicts (a batch's ``aux``).  An int field (a
    column count, a banded-window bound) takes the members' largest."""
    first = objs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(objs, dim=0)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{f.name: _concat([getattr(o, f.name) for o in objs])
                                            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        return tuple(_concat(list(parts)) for parts in zip(*objs))
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in objs]) for k in first}
    if isinstance(first, int):
        return max(objs)
    if isinstance(first, str) and all(o == first for o in objs):  # an axis name
        return first
    if first is None:
        return None
    raise TypeError(f"cannot concatenate {type(first).__name__}")


def _take(obj: Any, idx: torch.Tensor) -> Any:
    """Rows ``idx`` of every tensor's leading axis, through operator
    dataclasses, tuples and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.index_select(0, idx)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _take(getattr(obj, f.name), idx) for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_take(o, idx) for o in obj)
    if isinstance(obj, dict):
        return {k: _take(v, idx) for k, v in obj.items()}
    return obj


def _nbytes(obj: Any) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, tuple):
        return sum(_nbytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_nbytes(o) for o in obj.values())
    return 0


def _map_tensors(obj: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``fn`` of every tensor, through operator dataclasses, tuples, lists
    and dicts."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map_tensors(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def _to(obj: Any, device, non_blocking: bool = False) -> Any:
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(o, device, non_blocking) for o in obj)
    if isinstance(obj, dict):
        return {k: _to(v, device, non_blocking) for k, v in obj.items()}
    if obj is None:
        return None
    return obj.to(device, non_blocking=non_blocking)


def to_device(batch: MeshBatch, device, non_blocking: bool = False) -> MeshBatch:
    """A host batch's tensors, operator (a tensor, an operator dataclass or
    a dense Dirac pair) and ``aux`` on ``device`` (an operator's own ``to``
    checks its indices on the host first).  ``non_blocking`` copies from
    pinned memory asynchronously: the host tensors must then live until the
    copies have run (``Uploads``)."""
    return MeshBatch(inputs=batch.inputs.to(device, non_blocking=non_blocking),
                     targets=batch.targets.to(device, non_blocking=non_blocking),
                     mask=batch.mask.to(device, non_blocking=non_blocking),
                     operator=_to(batch.operator, device, non_blocking), names=batch.names,
                     aux=_to(batch.aux, device, non_blocking))


def pinned(obj: Any) -> Any:
    """``obj`` (a host batch or any tree of tensors) with every tensor in
    page-locked memory, the source a non-blocking upload needs.  This is
    the only CUDA call a prefetch worker makes."""
    return _map_tensors(obj, lambda t: t.pin_memory())


class Uploads:
    """Non-blocking uploads of pinned host batches to ``device``.  Each
    host batch stays referenced, with an event recorded after its copies on
    the current stream, until the event has passed, so no pinned buffer is
    freed (and reused) under a copy still in flight.  On the CPU the copy is
    the plain ``to_device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._held: collections.deque = collections.deque()

    def __call__(self, host: Any, upload: Callable[[Any, Any, bool], Any] | None = None) -> Any:
        """``host`` on the device: ``upload(host, device, non_blocking)``
        (default ``to_device``, for a ``MeshBatch``)."""
        upload = upload or to_device
        if self.device.type != "cuda":
            return upload(host, self.device, False)
        out = upload(host, self.device, True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._held.append((done, host))
        while self._held and self._held[0][0].query():
            self._held.popleft()
        return out


class OperatorCache:
    """Pack-once cache for per-sample packed values (the JAX package's).

    ``get(owners, key, build)`` returns the cached value for ``(ids of
    owners, key)`` or calls ``build()`` and stores the result.  ``owners``
    are the host objects the value derives from; the cache holds them, so
    their ``id`` stays valid, and checks identity on every hit: an owner
    replaced by a new object misses and repacks.  ``budget_bytes`` caps the
    host memory held: past it, new values are built but not stored (one
    warning), so the cache passes through instead of growing without bound.
    """

    def __init__(self, budget_bytes: int = HOST_BUDGET_BYTES):
        self._store: dict[tuple, tuple[tuple, Any]] = {}
        self.budget_bytes = budget_bytes
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self._warned = False

    def get(self, owners: tuple, key: tuple, build: Callable[[], Any]) -> Any:
        k = tuple(id(o) for o in owners) + key
        hit = self._store.get(k)
        if hit is not None and all(a is b for a, b in zip(hit[0], owners)):
            self.hits += 1
            return hit[1]
        self.misses += 1
        value = build()
        size = _nbytes(value)
        if hit is not None:
            # stale entry (owner replaced at a reused id): reclaim its budget
            self.bytes -= _nbytes(hit[1])
            del self._store[k]
        if self.bytes + size <= self.budget_bytes:
            self._store[k] = (owners, value)
            self.bytes += size
        elif not self._warned:
            warnings.warn(
                f"OperatorCache budget ({self.budget_bytes / 1e9:.1f} GB) exceeded "
                f"after {len(self._store)} entries; further operators repack "
                "every batch (raise budget_bytes to keep the pack-once behavior)",
                stacklevel=2,
            )
            self._warned = True
        return value

    def stats(self) -> str:
        return (
            f"operator cache: {len(self._store)} entries, "
            f"{self.bytes / 1e6:.1f} MB, {self.hits} hits / {self.misses} misses"
        )


class PackedSamples:
    """Each sample's single-sample batch, built by ``build_one(sample)`` on
    first use and kept in an ``OperatorCache`` (within its host budget;
    past it, each use repacks).  A sample is keyed by the object, which the
    cache holds (sample dicts), or with ``value_keys`` by its value
    (hashable items such as the ARAP trainer's (sequence, offset) picks)."""

    def __init__(self, build_one: Callable[[Any], MeshBatch], value_keys: bool = False,
                 budget_bytes: int = HOST_BUDGET_BYTES):
        self._build = build_one
        self.value_keys = value_keys
        self.cache = OperatorCache(budget_bytes)

    def key(self, sample: Any) -> Any:
        return sample if self.value_keys else id(sample)

    def one(self, sample: Any) -> MeshBatch:
        if self.value_keys:
            return self.cache.get((), (sample,), lambda: self._build(sample))
        return self.cache.get((sample,), (), lambda: self._build(sample))

    def batch(self, samples: list[dict]) -> MeshBatch:
        """The host batch of ``samples``, stacked from their packed singles."""
        singles = [self.one(s) for s in samples]
        return MeshBatch(**{k: _concat([getattr(b, k) for b in singles]) for k in _FIELDS},
                         names=[n for b in singles for n in b.names])


class MetricAccumulator:
    """Sums a loop's metrics on the device and fetches them once.  ``add``
    adds the step's scalars to the running sums (an asynchronous add per
    step, in the order of the steps); ``sums()`` fetches them.  Past
    ``max_inflight`` steps not known to be done, ``add`` waits for the
    oldest, so the host dispatches at most that far ahead of the device."""

    def __init__(self, max_inflight: int = 16):
        self._sums = None
        self._inflight: collections.deque = collections.deque()
        self.max_inflight = max_inflight
        self.n = 0

    def add(self, *scalars) -> None:
        if self._sums is None:
            self._sums = list(scalars)
        else:
            self._sums = [a + b for a, b in zip(self._sums, scalars)]
        self.n += 1
        first = scalars[0] if scalars else None
        if isinstance(first, torch.Tensor) and first.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(first.device))
            self._inflight.append(done)
            if len(self._inflight) > self.max_inflight:
                self._inflight.popleft().synchronize()

    def sums(self) -> tuple:
        if self._sums is None:
            return ()
        return tuple(float(x) for x in self._sums)

    def means(self) -> tuple:
        return tuple(s / max(self.n, 1) for s in self.sums())


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


def prefetch(make_batch: Callable[[int], Any], n_steps: int, depth: int = 2) -> Iterator[Any]:
    """Yield ``make_batch(i)`` for ``i in range(n_steps)``, built ahead of
    the consumer on a background thread.

    ``depth`` bounds the batches built and not yet taken (2: the worker
    builds batch t+1 while the device runs step t).  A worker exception
    re-raises in the consumer at the failing step; if the consumer stops
    early (break, exception), the worker is told and exits instead of
    blocking on the full queue.
    """
    if n_steps <= 0:
        return
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for i in range(n_steps):
                if not _put(make_batch(i)):
                    return
        except BaseException as e:  # noqa: BLE001 - raised again in the consumer
            _put(_Failure(e))
        else:
            _put(_DONE)

    t = threading.Thread(target=worker, daemon=True, name="snx-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        stop.set()


def prefetch_over(sampler, make_batch: Callable[[list], Any], n_steps: int, depth: int = 2) -> Iterator[Any]:
    """``prefetch`` of ``make_batch(sampler.next_batch())``: the sampler
    draws on the worker thread, the only thread that touches it during the
    loop, so its draws are the synchronous loop's."""
    return prefetch(lambda _i: make_batch(sampler.next_batch()), n_steps, depth=depth)


def padded_vertex_count(batch) -> int:
    """B * N_padded of a batch (a ``MeshBatch`` or an ``IndexedBatch``), for
    throughput meters."""
    if isinstance(batch, IndexedBatch):
        return int(batch.idx.shape[0]) * int(batch.tree.inputs.shape[1])
    return int(batch.inputs.shape[0]) * int(batch.inputs.shape[1])


def host_route(draw: Callable[[], Any], packed: PackedSamples, n_steps: int, device,
               depth: int = 2) -> Iterator[MeshBatch]:
    """The trainers' host route: ``n_steps`` batches of ``packed.batch(draw())``
    built on the worker thread (the draws too), pinned there when
    ``device`` is a card, and uploaded with non-blocking copies."""
    pin = torch.device(device).type == "cuda"
    uploads = Uploads(device)

    def make(_i):
        host = packed.batch(draw())
        return pinned(host) if pin else host

    batches = prefetch(make, n_steps, depth=depth)
    try:
        while True:
            with span("snx:batch"):  # the wait for the worker and the upload
                host = next(batches, _DONE)
                if host is _DONE:
                    return
                out = uploads(host)
            yield out
    finally:
        batches.close()


@dataclasses.dataclass
class IndexedBatch:
    """A device dataset and the rows of one batch; ``gather`` assembles the
    batch on the device."""

    tree: MeshBatch
    idx: torch.Tensor  # int64 [B] on the dataset's device
    names: list

    def gather(self) -> MeshBatch:
        with span("snx:batch"):
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
        with span("snx:batch"):
            idx = np.asarray([self._index_of[self._key(s)] for s in items], np.int64)
            return IndexedBatch(self.tree, torch.from_numpy(idx).to(self.tree.inputs.device),
                                [self.tree.names[i] for i in idx])

    def stats(self) -> str:
        nbytes = sum(_nbytes(getattr(self.tree, k)) for k in _FIELDS)
        return f"device dataset: {len(self.items)} samples, {nbytes / 1e6:.1f} MB resident"
