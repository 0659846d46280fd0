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

``launch_multihost`` is the counterpart of the JAX package's
``initialize_multihost`` in a trainer (``--multihost``): a process stands
for a host, and each of the ``num_processes`` launches, started apart,
starts its share of the grid, ``n_data * n_graph / num_processes`` local
ranks with a card each (global rank ``process_id * local + i``), which meet
at a TCP rendezvous at ``--coordinator-address`` (hosted by process 0's
first rank) or, with no coordinator flag, through torchrun's environment
(``env://``).  Each rank posts its device's identity (a card's UUID) to the
rendezvous store before the process group starts, and every rank takes
the backend the identities ask for (``choose_backend_of``): a rank sees
only its own card, so no rank could choose alone.  A bad address or an
unreachable peer raises within the timeout; nothing falls back to one
process."""

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
    # under --multihost: (this process's index, the processes, the ranks each starts)
    processes: tuple[int, int, int] | None = None

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
    if any(d.type not in ("cpu", "cuda") for d in devices):
        raise ValueError(f"ranks on mixed device types: {devices}")
    return choose_backend_of([d.type if d.type == "cpu" else f"cuda:{d.index or 0}" for d in devices])


def choose_backend_of(identities: Sequence[str]) -> str:
    """The backend of ranks whose devices are ``identities`` (``"cpu"`` or
    a card's identity, e.g. its UUID): ``gloo`` where every rank is on the
    CPU or a card repeats, ``nccl`` where every rank has a card of its own."""
    cpu = [i == "cpu" for i in identities]
    if all(cpu):
        return "gloo"
    if any(cpu):
        raise ValueError(f"ranks on mixed device types: {list(identities)}")
    return "nccl" if len(set(identities)) == len(identities) else "gloo"


def device_identity(device: torch.device) -> str:
    """``"cpu"``, or the card's UUID (the same card seen from two processes
    gives the same string)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return str(torch.cuda.get_device_properties(device).uuid)


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


def make_mesh(n_data: int | None = None, n_graph: int = 1, devices: Sequence | None = None,
              device: torch.device | None = None) -> Mesh | None:
    """This rank's grid over ``devices`` (default: every visible card), or,
    given ``device``, with this rank on that device (a process of a
    ``--multihost`` run sees only its own cards).  Every rank of the process
    group calls it, in the same order (each subgroup is made collectively).
    Refuses a grid larger than the devices given, as the JAX package
    asserts.  A process group larger than the grid lends the grid its first
    ranks; the others get None."""
    import torch.distributed as dist

    if device is None:
        if devices is None:
            devices = default_devices("cuda", torch.cuda.device_count())
        devices = [torch.device(d) for d in devices]
        if n_data is None:
            n_data = len(devices) // n_graph
        if n_data * n_graph > len(devices) or n_data < 1 or n_graph < 1:
            raise ValueError(f"a ({n_data}, {n_graph}) grid needs {n_data * n_graph} devices, {len(devices)} given")
    elif n_data is None or n_data < 1 or n_graph < 1:
        raise ValueError(f"a grid of ({n_data}, {n_graph}) ranks")
    world = n_data * n_graph
    if dist.is_initialized():
        size = dist.get_world_size()
        if size < world:
            raise ValueError(f"a ({n_data}, {n_graph}) grid needs {world} ranks, the process group has {size}")
        rank, backend = dist.get_rank(), dist.get_backend()
    elif world == 1:
        size, rank = 1, 0
        backend = choose_backend([device if device is not None else devices[0]])
    else:
        raise RuntimeError("make_mesh over more than one rank needs torch.distributed initialised (launch)")
    if device is None and rank < world:
        device = devices[rank]
    staged = backend == "gloo" and device is not None and torch.device(device).type == "cuda"

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
    return Mesh(n_data=n_data, n_graph=n_graph, rank=rank, device=torch.device(device), backend=backend,
                data=data_axis, graph=graph_axis, world=_axis(ranks, world_group, rank, staged))


def replica_mesh(device: torch.device) -> Mesh:
    """A one-rank grid for this process of a ``--multihost`` run with no
    grid axis: every process trains a replica on its own card, as the JAX
    package's processes do without a sharded mesh; ``rank`` is the
    process's, so only process 0 writes."""
    import torch.distributed as dist

    rank = dist.get_rank()
    lone = Axis(group=None, ranks=(rank,), index=0)
    return Mesh(n_data=1, n_graph=1, rank=rank, device=torch.device(device), backend=dist.get_backend(), data=lone,
                graph=lone, world=lone)


def multihost_process(coordinator_address: str | None = None, num_processes: int | None = None,
                      process_id: int | None = None) -> tuple[str, int, int, int | None]:
    """``(rendezvous url, processes, this process's index, its local card or
    None)`` of a ``--multihost`` launch: from the three coordinator flags
    (a TCP rendezvous at ``host:port``), or, with none of them, from
    torchrun's environment (``env://``: one rank a process, its card
    ``LOCAL_RANK``), the counterpart of JAX's auto-detection.  Refuses
    anything else."""
    flags = (coordinator_address, num_processes, process_id)
    if all(v is None for v in flags):
        if not all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")):
            raise SystemExit("--multihost needs --coordinator-address, --num-processes and --process-id, or "
                             "torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
        local = os.environ.get("LOCAL_RANK")
        return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), None if local is None else int(local)
    if any(v is None for v in flags):
        raise SystemExit("--multihost needs all of --coordinator-address, --num-processes and --process-id "
                         "(or none of them, under torchrun)")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"--coordinator-address {coordinator_address!r} is not host:port")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise SystemExit(f"--process-id {process_id} is not one of --num-processes {num_processes}")
    return f"tcp://{coordinator_address}", num_processes, process_id, None


def initialize_multihost(url: str, rank: int, world_size: int, device: torch.device,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """``torch.distributed`` bootstrap of one rank at the rendezvous ``url``
    (``tcp://host:port``, hosted by rank 0, or ``env://``).  The rank posts
    ``device``'s identity to the rendezvous store and waits for every
    rank's, then starts the process group on the backend they ask for
    (``choose_backend_of``), which it returns.  Only the benign case, a
    process group already initialised in this process, is a no-op; any other
    failure (a bad address, an unreachable peer, inconsistent counts) raises
    within ``timeout_s``, so a broken launch fails loudly instead of running
    as one process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    timeout = datetime.timedelta(seconds=timeout_s)
    kw = {} if url == "env://" else {"rank": rank, "world_size": world_size}
    store, rank, world_size = next(dist.rendezvous(url, timeout=timeout, **kw))
    store.set_timeout(timeout)
    ids = dist.PrefixStore("snx_device", store)
    ids.set(str(rank), device_identity(device))
    backend = choose_backend_of([ids.get(str(r)).decode() for r in range(world_size)])
    dist.init_process_group(backend, store=dist.PrefixStore("snx_pg", store), rank=rank, world_size=world_size,
                            timeout=timeout)
    return backend


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local_index: int, fn: Callable, n_data: int, n_graph: int, devices: list, url: str,
                first_rank: int, world: int, timeout_s: float, out_path: str | None, threads: int, args: tuple,
                processes: tuple[int, int, int] | None = None) -> Any:
    """One rank: global rank ``first_rank + local_index`` of ``world`` on
    ``devices[local_index]``, met at ``url``; runs ``fn(mesh, *args)`` and
    (the first local rank) pickles its result to ``out_path``.  A world
    larger than the grid is a ``--multihost`` run's replicas
    (``replica_mesh``)."""
    import torch.distributed as dist

    device = torch.device(devices[local_index])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if threads:
        torch.set_num_threads(threads)
    initialize_multihost(url, first_rank + local_index, world, device, timeout_s)
    try:
        grid = n_data * n_graph
        mesh = make_mesh(n_data, n_graph, device=device) if grid > 1 else replica_mesh(device)
        mesh.processes = processes
        result = fn(mesh, *args)
        if local_index == 0 and out_path is not None:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
        dist.barrier()
        return result
    finally:
        dist.destroy_process_group()


def _spawn(n_local: int, fn: Callable, n_data: int, n_graph: int, devices: list, url: str, first_rank: int,
           world: int, timeout_s: float, threads: int, args: tuple, processes: tuple | None) -> Any:
    """``_rank_entry`` on ``n_local`` spawned processes; returns the first
    local rank's result."""
    import torch.multiprocessing as mp

    fd, out_path = tempfile.mkstemp(suffix=".pkl")
    os.close(fd)
    try:
        mp.start_processes(_rank_entry, args=(fn, n_data, n_graph, devices, url, first_rank, world, timeout_s,
                                              out_path, threads, tuple(args), processes),
                           nprocs=n_local, join=True, start_method="spawn")
        with open(out_path, "rb") as f:
            return pickle.load(f)
    finally:
        os.unlink(out_path)


def _cpu_threads(devices: list, world: int) -> int:
    """Each CPU rank's intra-op threads: this machine's cores shared by the
    grid's ``world`` ranks (CPU ranks, the test route, share one machine,
    and the same thread count gives the same sums whether one launch or
    several start them); 0, PyTorch's default, on cards."""
    if all(torch.device(d).type == "cpu" for d in devices):
        return max(1, (os.cpu_count() or 1) // world)
    return 0


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
    world = n_data * n_graph
    devices = [str(torch.device(d)) for d in (devices or default_devices(device, world))]
    if len(devices) != world:
        raise ValueError(f"{world} ranks, {len(devices)} devices")
    threads = threads or _cpu_threads(devices, world)
    return _spawn(world, fn, n_data, n_graph, devices, f"tcp://127.0.0.1:{free_port()}", 0, world, timeout_s, threads,
                  args, None)


def launch_multihost(fn: Callable[..., Any], n_data: int, n_graph: int = 1, coordinator_address: str | None = None,
                     num_processes: int | None = None, process_id: int | None = None, device: str = "cuda",
                     args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """This process's share of a ``--multihost`` run (see the module
    docstring): ``n_data * n_graph / num_processes`` local ranks, one card
    each (``cuda:0..``; torchrun's ``LOCAL_RANK`` under ``env://``; the CPU
    with ``device`` cpu), started here (in this process when there is one)
    and met with the other processes' at the rendezvous; returns the first
    local rank's ``fn(mesh, *args)``.  A grid of one rank runs a replica on
    each process.  Refuses a grid the processes do not divide."""
    url, processes, pid, local_card = multihost_process(coordinator_address, num_processes, process_id)
    grid = n_data * n_graph
    if grid > 1 and grid % processes:
        raise SystemExit(f"--multihost: a ({n_data}, {n_graph}) grid of {grid} ranks does not divide over "
                         f"{processes} processes")
    n_local = grid // processes if grid > 1 else 1
    if url == "env://" and n_local != 1:
        raise SystemExit(f"--multihost under torchrun runs one rank a process: start {grid} processes, not "
                         f"{processes}")
    world = max(grid, processes)
    if local_card is not None and torch.device(device).type == "cuda":
        devices = [f"cuda:{local_card}"]
    else:
        devices = [str(d) for d in default_devices(device, n_local)]
    threads = _cpu_threads(devices, world)
    info = (pid, processes, n_local)
    if n_local == 1:
        return _rank_entry(0, fn, n_data, n_graph, devices, url, pid, world, timeout_s, None, threads, args, info)
    return _spawn(n_local, fn, n_data, n_graph, devices, url, pid * n_local, world, timeout_s, threads, args, info)


def axis_ranks(flag: int) -> int:
    """The ranks of a grid axis that ``--data-parallel`` or
    ``--graph-parallel`` asks for: the value above 1, else 1 (0 and 1 mean
    off, as in the JAX trainers)."""
    return flag if flag > 1 else 1


def run_ranks(run: Callable[..., Any], n_data: int, n_graph: int, device: str, *args) -> Any:
    """A trainer's ``run(mesh, *args)`` on an ``(n_data, n_graph)`` grid of
    ranks started here (``launch``, one card each, refused when fewer are
    visible; CPU ranks with ``device`` cpu), returning rank 0's result; on
    a grid of one, ``run(None, *args)`` in this process.  A ``--multihost``
    run starts its share through ``launch_multihost`` instead
    (``cli.common.run_grid``)."""
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
