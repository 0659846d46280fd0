"""Reading a ``torch.profiler`` trace of the window (CPU and CUDA
activities): the device's own work (kernels, copies and sets; not the
annotated ranges the profiler mirrors onto the device's timeline), the
ranges the benchmark put around calls (``record_function`` names starting
``portbench:``), and which ranges each device operation was launched from
(the host-side runtime call that launched it lies inside the range, on the
range's thread; the two are joined by their correlation id), and how long
the host waited on the device inside the runtime's calls.

Copied in spirit from the port's ``chip_smoke.py`` (``device_rows``,
``range_device_ms``), read from the profiler's flat event list so that a
window of tens of thousands of launches reads in seconds.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re

RANGE_PREFIX = "portbench:"
# the port's launch counters (``sparse/kernels.py::launches``) and the kernels they count (``sparse/csrc/spmm.cu``)
KERNEL_SYMBOLS = {"bsr_matmul": "bsr_spmm_kernel", "ell_matmul": "ell_spmm_kernel", "sddmm": "sddmm_kernel",
                  "bsr_matmul_bf16": "bsr_spmm_bf16_kernel", "ell_matmul_bf16": "ell_spmm_bf16x_kernel",
                  "sddmm_bf16": "sddmm_bf16_kernel"}
HOST_SPANS = ("portbench:host:batch", "portbench:host:update")
# runtime calls in which the host does nothing but wait for the device
SYNC = re.compile(r"Synchronize|^cudaMemcpy$")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    ranges: frozenset  # the benchmark's ranges it was launched from

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Trace:
    def __init__(self, prof):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = prof.profiler.kineto_results.events()
        ranges = collections.defaultdict(list)  # (name, tid) -> [(start, end)]
        launches = {}  # correlation id -> (tid, start)
        self.runtime = []  # (start, end, name) of every runtime and driver call, on any thread
        device = []
        for e in events:
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    device.append(e)
                continue
            name = e.name()
            if name.startswith(RANGE_PREFIX):
                ranges[name].append((e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith("cu"):  # runtime and driver calls: launches, copies, sets, syncs
                launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
                self.runtime.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        self.host_ranges = {k: sorted((s, t) for _, s, t in v) for k, v in ranges.items()}
        by_thread = collections.defaultdict(list)
        for name, spans in ranges.items():
            for tid, s, t in spans:
                by_thread[tid].append((s, t, name))
        index = {tid: _Intervals(spans) for tid, spans in by_thread.items()}
        self.ops = []
        self.unlinked = 0
        for e in device:
            launch = launches.get(e.linked_correlation_id()) or launches.get(e.correlation_id())
            if launch is None:
                self.unlinked += 1
                inside = frozenset()
            else:
                tid, t = launch
                inside = index[tid].containing(t) if tid in index else frozenset()
            self.ops.append(DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), inside))
        self.ops.sort(key=lambda o: o.start_ns)

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, in order."""
        return _union((o.start_ns, o.end_ns) for o in self.ops)

    def host_work_s(self, spans=HOST_SPANS) -> tuple[float, float]:
        """``(work, wall)``: the host's wall inside ``spans``, and that wall
        less its waits on the device.  A wait is the time a runtime call
        took beyond the least that a call of its name took in the window (a
        launch into a full queue waits there for a slot), or the whole of a
        synchronising call.  The backward's calls, on autograd's thread,
        count while the span's thread waits for them."""
        least: dict = {}
        for s, t, name in self.runtime:
            least[name] = 0 if SYNC.search(name) else min(least.get(name, t - s), t - s)
        waits = _union((s + least[name], t) for s, t, name in self.runtime if t - s > least[name])
        inside = _union(iv for name in spans for iv in self.host_ranges.get(name, ()))
        wall = sum(t - s for s, t in inside)
        waited, i = 0, 0
        for s, t in inside:  # both lists are sorted and disjoint: one sweep
            while i < len(waits) and waits[i][1] <= s:
                i += 1
            j = i
            while j < len(waits) and waits[j][0] < t:
                waited += min(t, waits[j][1]) - max(s, waits[j][0])
                j += 1
        return (wall - waited) / 1e9, wall / 1e9

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def matching(self, patterns: list[str]) -> list[DeviceOp]:
        rx = re.compile("|".join(f"(?:{p})" for p in patterns))
        return [o for o in self.ops if rx.search(o.name)]

    def in_range(self, name: str) -> list[DeviceOp]:
        return [o for o in self.ops if name in o.ranges]

    def port_launches(self) -> dict:
        """The port's kernels in the trace, by launch counter."""
        return {k: n for k, sym in KERNEL_SYMBOLS.items() if (n := len(self.matching([rf"\b{sym}\b"])))}

    def top_ops(self, n: int = 10) -> list[list]:
        total = collections.Counter()
        for o in self.ops:
            total[o.name] += o.end_ns - o.start_ns
        return [[short(k), v / 1e9] for k, v in total.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The longest gaps between device work, each named by the host span
        it falls in (its midpoint): what the host was doing meanwhile."""
        busy = self.busy_intervals()
        gaps = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _) in zip(busy, busy[1:]) if b0 > a1), reverse=True)[:n]
        out = []
        for length, a, b in gaps:
            mid = (a + b) // 2
            where = next((span.split(":")[-1] for span in HOST_SPANS
                          if any(s <= mid <= t for s, t in self.host_ranges.get(span, ()))), "outside the spans")
            out.append([where, length / 1e9])
        return out


def _union(intervals) -> list[tuple[int, int]]:
    """The union of ``(start, end)`` intervals, as disjoint intervals in
    order."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Intervals:
    """Ranges on one thread; which contain a time (ranges may nest)."""

    def __init__(self, spans: list[tuple[int, int, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]
        self.longest = max((t - s for s, t, _ in self.spans), default=0)

    def containing(self, t: int) -> frozenset:
        hi = bisect.bisect_right(self.starts, t)
        lo = bisect.bisect_left(self.starts, t - self.longest)
        return frozenset(name for s, e, name in self.spans[lo:hi] if s <= t <= e)


def short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."
