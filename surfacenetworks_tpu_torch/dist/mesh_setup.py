"""The rank grid, rank start-up and placement helpers (counterpart of
``surfacenetworks_tpu/dist/mesh_setup.py``).

The JAX package runs one controller over a ``Mesh(('data', 'graph'))`` of
devices.  The port runs one process per rank, in PyTorch's own idiom:
``torch.distributed`` process groups, collectives and point-to-point sends.
The mesh becomes a grid of ranks, ``rank = d * n_graph + g`` (the order in
which ``make_mesh`` reshapes ``jax.devices()``): the ranks of one data row
``d`` share a graph-axis group (the vertex rows of one batch shard), the
ranks of one graph column ``g`` a data-axis group.

Transport is chosen from the devices, explicitly, never by a silent
fallback (``choose_backend``): ``nccl`` for CUDA ranks that each have a card
of their own, ``gloo`` on the CPU, and ``gloo`` where the device list
repeats a card (NCCL refuses two ranks on one device).  On a gloo group the
collectives and the halo exchange move CUDA tensors through host copies
(``parallel_context.Axis.staged``); the compute stays on the card.

``launch`` starts the ranks with ``torch.multiprocessing`` (spawn), each
with a finite ``init_process_group`` timeout, so a rank that dies cannot
hang the others past it; a rank that raises fails the whole run.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import socket
import tempfile
from typing import Any, Callable, Sequence

import torch

from surfacenetworks_tpu_torch import parallel_context
from surfacenetworks_tpu_torch.parallel_context import Axis

DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class Mesh:
    """This rank's view of the ``(n_data, n_graph)`` grid: its device, the
    backend, the two axes through it and the whole world."""

    n_data: int
    n_graph: int
    rank: int
    device: torch.device
    backend: str
    data: Axis  # the ranks of this rank's graph column (varying d)
    graph: Axis  # the ranks of this rank's data row (varying g)
    world: Axis

    @property
    def size(self) -> int:
        return self.n_data * self.n_graph

    @property
    def data_index(self) -> int:
        return self.data.index

    @property
    def graph_index(self) -> int:
        return self.graph.index

    def context(self, vertex: bool = False, batch: bool = True):
        """The sharded context of a model body on this grid: the batch over
        the data axis (if ``batch``), the vertex rows over the graph axis (if
        ``vertex``)."""
        return parallel_context.sharded_axes(vertex_axis=self.graph if vertex else None,
                                             batch_axis=self.data if batch else None)


def choose_backend(devices: Sequence[torch.device]) -> str:
    """``gloo`` for CPU ranks or a device list that repeats a card,
    ``nccl`` for CUDA ranks on cards of their own."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cpu" for d in devices):
        return "gloo"
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"ranks on mixed device types: {devices}")
    idx = [d.index if d.index is not None else 0 for d in devices]
    return "nccl" if len(set(idx)) == len(idx) else "gloo"


def default_devices(device: str, n: int) -> list[torch.device]:
    """``n`` ranks' devices: ``cuda:0..n-1`` (refused when fewer cards are
    visible, as the JAX mesh refuses more ranks than devices), or ``n`` CPU
    ranks."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise SystemExit(f"{n} ranks need {n} CUDA devices, {have} visible (run on the CPU with --device cpu)")
    return [torch.device("cuda", i) for i in range(n)]


def _axis(ranks: list[int], group, rank: int, staged: bool) -> Axis:
    return Axis(group=group, ranks=tuple(ranks), index=ranks.index(rank), staged=staged)


def make_mesh(n_data: int | None = None, n_graph: int = 1, devices: Sequence | None = None) -> Mesh | None:
    """This rank's grid over ``devices`` (default: every visible card).  Every rank of the process
    group calls it, in the same order (each subgroup is made collectively).
    Refuses a grid larger than the devices given, as the JAX package
    asserts.  A process group larger than the grid lends the grid its first
    ranks; the others get None."""
    import torch.distributed as dist

    if devices is None:
        devices = default_devices("cuda", torch.cuda.device_count())
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_graph
    if n_data * n_graph > len(devices) or n_data < 1 or n_graph < 1:
        raise ValueError(f"a ({n_data}, {n_graph}) grid needs {n_data * n_graph} devices, {len(devices)} given")
    world = n_data * n_graph
    if dist.is_initialized():
        size = dist.get_world_size()
        if size < world:
            raise ValueError(f"a ({n_data}, {n_graph}) grid needs {world} ranks, the process group has {size}")
        rank, backend = dist.get_rank(), dist.get_backend()
    elif world == 1:
        size, rank, backend = 1, 0, choose_backend(devices[:1])
    else:
        raise RuntimeError("make_mesh over more than one rank needs torch.distributed initialised (launch)")
    staged = backend == "gloo" and rank < world and devices[rank].type == "cuda"

    def group(ranks):
        if not dist.is_initialized():
            return None
        return dist.new_group(ranks) if len(ranks) < size else dist.group.WORLD

    data_axis = graph_axis = None
    for g in range(n_graph):  # one group per graph column: the data axis
        ranks = [d * n_graph + g for d in range(n_data)]
        pg = group(ranks)
        if rank in ranks:
            data_axis = _axis(ranks, pg, rank, staged)
    for d in range(n_data):  # one group per data row: the graph axis
        ranks = [d * n_graph + g for g in range(n_graph)]
        pg = group(ranks)
        if rank in ranks:
            graph_axis = _axis(ranks, pg, rank, staged)
    ranks = list(range(world))
    world_group = group(ranks)
    if rank >= world:
        return None
    return Mesh(n_data=n_data, n_graph=n_graph, rank=rank, device=devices[rank], backend=backend,
                data=data_axis, graph=graph_axis, world=_axis(ranks, world_group, rank, staged))


def initialize_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, backend: str = "gloo",
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``torch.distributed`` bootstrap from a coordinator address.

    Only the benign case, a process group already initialised in this
    process, is a no-op; any other failure (a bad address, inconsistent
    process counts, an unreachable peer) raises, so a broken launch fails
    loudly instead of running as one process.  Library only: the trainers
    refuse ``--multihost``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs coordinator_address, num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn: Callable, n_data: int, n_graph: int, devices: list, port: int, timeout_s: float,
                out_path: str, threads: int, args: tuple) -> None:
    import torch.distributed as dist

    world = n_data * n_graph
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(choose_backend(devices), init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(make_mesh(n_data, n_graph, devices), *args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable[..., Any], n_data: int, n_graph: int = 1, devices: Sequence | None = None,
           args: tuple = (), device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
           threads: int = 0) -> Any:
    """Run ``fn(mesh, *args)`` on ``n_data * n_graph`` spawned ranks and
    return rank 0's result.  ``devices`` (one per rank; default
    ``default_devices(device, n)``) may repeat a card: the ranks then talk
    over gloo.  ``fn`` must be importable by name (a module-level
    function).  A rank that raises makes this raise; the process group's
    ``timeout_s`` bounds every collective.  ``threads`` sets each rank's
    intra-op threads (0: PyTorch's default)."""
    import torch.multiprocessing as mp

    world = n_data * n_graph
    devices = [str(torch.device(d)) for d in (devices or default_devices(device, world))]
    if len(devices) != world:
        raise ValueError(f"{world} ranks, {len(devices)} devices")
    if not threads and all(torch.device(d).type == "cpu" for d in devices):
        threads = max(1, (os.cpu_count() or 1) // world)  # the CPU ranks share the cores
    fd, out_path = tempfile.mkstemp(suffix=".pkl")
    os.close(fd)
    try:
        mp.start_processes(_rank_entry, args=(fn, n_data, n_graph, devices, free_port(), timeout_s, out_path,
                                              threads, tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
        with open(out_path, "rb") as f:
            return pickle.load(f)
    finally:
        os.unlink(out_path)


def axis_ranks(flag: int) -> int:
    """The ranks of a grid axis that ``--data-parallel`` or
    ``--graph-parallel`` asks for: the value above 1, else 1 (0 and 1 mean
    off, as in the JAX trainers)."""
    return flag if flag > 1 else 1


def run_ranks(run: Callable[..., Any], n_data: int, n_graph: int, device: str, *args) -> Any:
    """A trainer's ``run(mesh, *args)`` on an ``(n_data, n_graph)`` grid of
    ranks started here (``launch``, one card each, refused when fewer are
    visible; CPU ranks with ``device`` cpu), returning rank 0's result; on
    a grid of one, ``run(None, *args)`` in this process."""
    if n_data * n_graph == 1:
        return run(None, *args)
    return launch(run, n_data, n_graph, devices=default_devices(device, n_data * n_graph), args=args)


def shard_slice(n: int, parts: int, index: int) -> slice:
    """The ``index``-th of ``parts`` equal slices of ``n`` items."""
    if n % parts:
        raise ValueError(f"{n} rows not divisible by {parts} ranks")
    step = n // parts
    return slice(index * step, (index + 1) * step)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's slice of a leading (mesh-batch) axis of ``n`` items."""
    return shard_slice(n, mesh.n_data, mesh.data_index)


def replicated(mesh: Mesh, n: int) -> slice:
    """The whole axis: every rank holds all ``n`` items."""
    del mesh
    return slice(0, n)


def all_gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in the
    axis's order (through the host on a staged axis)."""
    import torch.distributed as dist

    if axis is None or axis.size == 1:
        return t
    src = t.detach().cpu() if axis.staged and t.is_cuda else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim).to(t.device)


def put_global(x: Any, sl: slice, device, dim: int = 0) -> Any:
    """``x``'s slice ``sl`` along ``dim``, contiguous on ``device``: every
    rank holds the same global host value and keeps its own shard."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t.narrow(dim, sl.start, sl.stop - sl.start).contiguous().to(device)
