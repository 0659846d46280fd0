"""Overlap readiness of the partitioned applies (counterpart of
``surfacenetworks_tpu/dist/analysis.py``).

A partitioned apply hides its halo exchange behind the interior product:
the interior rows need only the rank's own rows, the boundary rows need the
neighbours'.  The JAX package proves the dataflow half of that on the traced
program, since XLA's scheduler overlaps an asynchronous permute with any
work that does not depend on it.  In eager PyTorch the order in which work
is issued is the schedule: a kernel queued on the card before the host waits
on the exchange runs while the halo is in flight, one queued after it does
not.  So the port checks both halves, on one run of the apply on a rank:

* ``n_ppermute``: directions exchanged (one per isend/irecv pair; two on a
  rank with a neighbour on each side),
* ``interior_indep``: work that reads nothing of any received halo (the
  overlappable interior),
* ``boundary_dep``: work that does (the boundary rows),
* ``output_depends_on_halo``: the result reads the halo (the exchange is
  not dead code),
* ``interior_before_wait`` (the port's own): every wait on an exchange is
  preceded by interior work issued since the exchange before it was waited
  on (or since the start).

``check_overlap_structure(fn, *args)`` runs ``fn(*args)`` once under a
``TorchDispatchMode`` recorder.  The taint sources are the tensors
``edge_partition._Exchange.wait`` returns (every exchange of the Laplacian,
Dirac and GAT partitions goes through it); taint follows every operator's
inputs to its outputs, storage by storage (so a view of the received frame
is tainted, and an in-place add of tainted rows taints its target).  Work is
the port's kernel wrappers (``kernels.ell_matmul``, ``bsr_matmul``,
``sddmm``, one unit a call, on the card or through their plain versions)
and ``snx::`` ops, and the aggregation operators ``mm``, ``bmm``,
``addmm``, ``index_select``, ``gather``, ``index_add``, ``scatter_add`` and
``sum``.  Used by ``tests/test_torch_overlap.py``; ``chip_smoke.py`` shows
the order on the card in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from surfacenetworks_tpu_torch.dist import edge_partition
from surfacenetworks_tpu_torch.sparse import kernels

WORK_OPS = frozenset({"mm", "bmm", "addmm", "index_select", "gather", "index_add", "scatter_add", "sum"})
WRAPPERS = ("ell_matmul", "bsr_matmul", "sddmm")


def _ptr(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):  # a tensor without storage
        return 0


class _Recorder(TorchDispatchMode):
    """Taint by storage and the sequence of work, issues and waits."""

    def __init__(self):
        super().__init__()
        self.tainted: dict[int, torch.Tensor] = {}  # storage -> a tensor on it, kept alive so no address is reused
        self.events: list[tuple[str, Any]] = []  # ("work", depends on a halo), ("issue", i), ("wait", i)
        self.n_ppermute = 0
        self.inside = 0  # within a kernel wrapper: its plain version's operators are the wrapper's work

    def is_tainted(self, obj) -> bool:
        return any(isinstance(t, torch.Tensor) and _ptr(t) in self.tainted for t in tree_leaves(obj))

    def taint(self, obj) -> None:
        for t in tree_leaves(obj):
            if isinstance(t, torch.Tensor) and _ptr(t):
                self.tainted[_ptr(t)] = t

    def record_work(self, dep: bool) -> None:
        self.events.append(("work", dep))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dep = self.is_tainted((args, kwargs))
        out = func(*args, **kwargs)
        if dep:
            self.taint(out)  # an in-place or out= operator returns its target
        name = func.overloadpacket.__name__.rstrip("_")
        if not self.inside and (name in WORK_OPS or func.namespace == "snx"):
            self.record_work(dep)
        return out


@contextlib.contextmanager
def _recording(rec: _Recorder):
    """``rec`` active, with the exchanges and the kernel wrappers patched to
    report to it."""
    ex = edge_partition._Exchange
    init0, wait0 = ex.__init__, ex.wait
    wrapped0 = {name: getattr(kernels, name) for name in WRAPPERS}

    def init(self, *a, **k):
        init0(self, *a, **k)
        rec.n_ppermute += len(self.ops) // 2
        self._overlap_id = sum(1 for e in rec.events if e[0] == "issue")
        rec.events.append(("issue", self._overlap_id))

    def wait(self):
        out = wait0(self)
        rec.events.append(("wait", self._overlap_id))
        rec.taint(out)
        return out

    def wrapper(name):
        inner = wrapped0[name]

        def call(*a, **k):
            dep = rec.is_tainted((a, k))
            rec.inside += 1
            try:
                out = inner(*a, **k)
            finally:
                rec.inside -= 1
            rec.record_work(dep)
            if dep:
                rec.taint(out)
            return out

        return call

    ex.__init__, ex.wait = init, wait
    for name in WRAPPERS:
        setattr(kernels, name, wrapper(name))
    try:
        with rec:
            yield
    finally:
        ex.__init__, ex.wait = init0, wait0
        for name, fn in wrapped0.items():
            setattr(kernels, name, fn)


def _interior_before_waits(events: list) -> bool:
    """Every wait preceded by halo-free work issued since the last wait (or
    the start)."""
    fresh, waits = False, 0
    for kind, val in events:
        if kind == "work" and not val:
            fresh = True
        elif kind == "wait":
            if not fresh:
                return False
            fresh, waits = False, waits + 1
    return waits > 0


def check_overlap_structure(fn, *args) -> dict[str, Any]:
    """Run ``fn(*args)`` once on this rank (inside its graph-sharded context,
    which ``fn`` sets or its caller does) and report the interior/boundary
    split around its halo exchanges: JAX's four keys and
    ``interior_before_wait`` (see the module docstring)."""
    rec = _Recorder()
    with _recording(rec):
        out = fn(*args)
        depends = rec.is_tainted(out)
    work = [dep for kind, dep in rec.events if kind == "work"]
    return {"n_ppermute": rec.n_ppermute, "interior_indep": sum(not d for d in work),
            "boundary_dep": sum(bool(d) for d in work), "output_depends_on_halo": bool(depends),
            "interior_before_wait": _interior_before_waits(rec.events)}
