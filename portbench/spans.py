"""The program's own spans in the traced window, and every device operation
put down to the span that caused it.

The port opens ``snx:`` ranges at its layer boundaries
(``surfacenetworks_tpu_torch/spans.py``: ``snx:batch``, ``snx:update`` and
its phases, ``snx:bn``, ``snx:linear``, ``snx:apply:*``) and counts every
span it opens in ``span_counts``.  From the window's ``torch.profiler``
events this module builds:

* the ``snx:`` ranges, per thread, on the profiler's clock (the clock of the
  device activities);
* each device operation's launch, by correlation id, as ``trace.py`` links
  them;
* each autograd ``evaluate_function`` event's forward operation, by its
  ``sequence_nr`` and ``fwd_thread_id`` (the profiler numbers a backward
  node as the forward operation that made it).

A device operation belongs to the innermost ``snx:`` span its launch lies
in, or, where it was launched by a backward node that opened no span of its
own, to the span that the node's forward operation was launched in: autograd
runs the backward of the ATen operations inside a span outside it, on its
own thread on the card.

``trace.Trace`` keeps only the benchmark's ranges, so ``instrument`` keeps
hold of the profile that the window starts while it is entered (once,
however many readers enter it), with ``span_counts`` at the profile's start
and stop; ``attribution(ctx)`` builds the attribution once from its events.
Before anything is read, every ``snx:`` name must have as many ranges in the
trace as the program counted in the window: a lost event would read as a
fast layer.  Where the program opens no span (a program older than its
spans), or the counts differ, or no device operation was traced (the CPU),
the readers get ``None``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
import sys

from portbench.trace import _union

PREFIX = "snx:"
EVALUATE = "autograd::engine::evaluate_function"
# runtime calls in which the host blocks on the device or the driver
BLOCKING = re.compile(r"Synchronize|^cudaMemcpy$|^cudaMalloc|^cudaFree")
SLACK_NS = 10_000  # a gap that opens this soon after a blocking call returned opened in it (the clocks' skew)

_UNBUILT = object()


class _Kept:
    depth = 0
    saved = None  # the profile class's own start and stop
    prof = None  # the profile started while instrumented
    before = after = None  # span_counts at its start and stop
    built = _UNBUILT


_kept = _Kept()


def _span_counts():
    """A copy of the program's span counts, or None where it has none."""
    try:
        from surfacenetworks_tpu_torch.spans import span_counts
    except ImportError:
        return None
    return collections.Counter(span_counts)


@contextlib.contextmanager
def instrument():
    """Keeps the ``torch.profiler.profile`` started while entered, and the
    program's span counts at its start and its stop.  Nested entries (one a
    reader) share one hold."""
    import torch

    cls = torch.profiler.profile
    if _kept.depth == 0:
        start, stop = cls.start, cls.stop

        def kept_start(self):
            _kept.prof, _kept.before, _kept.after, _kept.built = self, _span_counts(), None, _UNBUILT
            start(self)

        def kept_stop(self):
            stop(self)
            if self is _kept.prof:
                _kept.after = _span_counts()

        _kept.saved = start, stop
        cls.start, cls.stop = kept_start, kept_stop
    _kept.depth += 1
    try:
        yield
    finally:
        _kept.depth -= 1
        if _kept.depth == 0:
            cls.start, cls.stop = _kept.saved


def _log(msg: str) -> None:
    print(f"spans: {msg}", file=sys.stderr, flush=True)


def attribution(ctx) -> "Attribution | None":
    """The window's attribution, built once from the kept profile; None
    where the trace holds no ``snx:`` span, where a span's ranges in the
    trace differ from the program's count, or where no device operation
    was traced."""
    if _kept.built is _UNBUILT:
        _kept.built = None
        if ctx.trace is not None and _kept.prof is not None and _kept.after is not None:
            att = Attribution(_kept.prof.profiler.kineto_results.events())
            counted = None if _kept.before is None else _kept.after - _kept.before
            if check_counts(att.range_counts(), counted, ctx.steps) and att.ops:
                _kept.built = att
            elif not att.ops:
                _log("no device operation in the trace")
        _kept.prof = None  # the raw events are not read again
    return _kept.built


def check_counts(in_trace: collections.Counter, counted: collections.Counter | None, steps: int) -> bool:
    """Whether the trace holds, for every ``snx:`` name, as many ranges as
    the program opened spans in the window; logs the spans an update."""
    if not in_trace:
        _log("the trace holds no snx: span (the program opens none)")
        return False
    if counted is None:
        _log("the trace holds snx: spans but the program counts none")
        return False
    differ = {n: (in_trace[n], counted[n]) for n in set(in_trace) | set(counted) if in_trace[n] != counted[n]}
    if differ:
        _log(f"span check FAILED, (in the trace, counted) by name: {differ}")
        return False
    per = {n: round(c / max(steps, 1), 2) for n, c in sorted(counted.items())}
    _log(f"span check passed: {sum(counted.values())} ranges in the trace, as counted; an update: {per}")
    return True


class Attribution:
    """Device operations put down to the program's spans, from the
    profiler's flat event list (``kineto_results.events()``)."""

    def __init__(self, events):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        spans = collections.defaultdict(list)  # tid -> [(start, end, name)]
        nodes = collections.defaultdict(list)  # tid -> [(start, end, (fwd tid, sequence nr))]
        self.forward_op = {}  # (tid, sequence nr) -> start of the forward operation
        launches = {}  # correlation id -> (tid, start)
        runtime = collections.defaultdict(list)  # tid -> [(start, end, name)] of the runtime and driver calls
        self.blocking = []  # (start, end, name, tid) of the runtime calls that block
        device = []
        for e in events:
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    device.append(e)
                continue
            name, tid, s = e.name(), e.start_thread_id(), e.start_ns()
            t = s + e.duration_ns()
            if name.startswith(PREFIX):
                spans[tid].append((s, t, name))
            elif name.startswith(EVALUATE):
                if e.sequence_nr() >= 0:
                    nodes[tid].append((s, t, (e.fwd_thread_id(), e.sequence_nr())))
            elif name.startswith("cu"):  # runtime and driver calls
                launches[e.correlation_id()] = (tid, s)
                runtime[tid].append((s, t, name))
                if BLOCKING.search(name):
                    self.blocking.append((s, t, name, tid))
            elif e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:  # a forward operation that made a node
                key = (tid, e.sequence_nr())
                self.forward_op[key] = min(s, self.forward_op.get(key, s))
        self.spans = {tid: _Nested(v) for tid, v in spans.items()}
        self.nodes = {tid: _Nested(v) for tid, v in nodes.items()}
        self.runtime = {tid: _Nested(v) for tid, v in runtime.items()}
        self.ops = []  # (start, end, owner span or None, name)
        for e in device:
            launch = launches.get(e.linked_correlation_id()) or launches.get(e.correlation_id())
            owner = self.owner(*launch)[0] if launch is not None else None
            self.ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), owner, e.name()))
        self.ops.sort()

    def range_counts(self) -> collections.Counter:
        return collections.Counter(name for n in self.spans.values() for _, _, name in n.items)

    def owner(self, tid: int, t: int) -> tuple[str | None, bool]:
        """The span that the work a thread did at ``t`` belongs to, and
        whether it is a backward put down to its forward's span: the
        innermost ``snx:`` span there, unless the innermost backward node
        there began inside it (or there is none), in which case the span of
        the node's forward operation."""
        inner = self.spans[tid].innermost(t) if tid in self.spans else None
        node = self.nodes[tid].innermost(t) if tid in self.nodes else None
        if node is not None and (inner is None or inner[0] < node[0]):
            fwd_tid, _ = node[2]
            start = self.forward_op.get(node[2])
            if start is not None and fwd_tid in self.spans:
                caused = self.spans[fwd_tid].innermost(start)
                if caused is not None:
                    return caused[2], True
        return (inner[2] if inner is not None else None), False

    def device_ns(self, name: str) -> int:
        """Device time of every operation that belongs to span ``name``."""
        return sum(t - s for s, t, owner, _ in self.ops if owner == name)

    def busy(self) -> list[tuple[int, int]]:
        return _union((s, t) for s, t, _, _ in self.ops)

    def doing(self, t: int) -> list[str]:
        """What each host thread that opened a span or ran a backward node
        was doing at ``t``: the span its work belongs to and the runtime call
        in flight."""
        out = []
        for tid in sorted(set(self.spans) | set(self.nodes)):
            span, backward = self.owner(tid, t)
            call = self.runtime[tid].innermost(t) if tid in self.runtime else None
            out.append(f"thread {tid} in {span or 'no span'}{' (backward)' if backward else ''}, "
                       f"{call[2] if call is not None else 'no runtime call'}")
        return out

    def longest_gaps(self, n: int) -> list[tuple[int, int]]:
        """``(length, start)`` of the ``n`` longest gaps between device work."""
        busy = self.busy()
        return sorted(((b - a, a) for (_, a), (b, _) in zip(busy, busy[1:]) if b > a), reverse=True)[:n]

    def stalls(self) -> tuple[int, collections.Counter]:
        """Device idle time in the gaps that open while a host thread sits
        in a blocking runtime call, each counted up to the next device
        operation; and that time by cause, ``(call, span)``, the span that
        the call belongs to (``owner``)."""
        causes = collections.Counter()
        for length, call in stall_gaps(self.busy(), self.blocking):
            s, _, name, tid = call
            span, backward = self.owner(tid, s)
            causes[(name, f"{span} (backward)" if backward else span or "no span")] += length
        return sum(causes.values()), causes


def stall_gaps(busy: list[tuple[int, int]], blocking: list[tuple]) -> list[tuple[int, tuple]]:
    """``(length, call)`` of each gap between the ``busy`` intervals (in
    order, disjoint) that opens while a call of ``blocking`` (``(start,
    end, ...)``) runs, or within ``SLACK_NS`` after it returned; the longest
    such call names the gap."""
    calls = sorted(blocking)
    starts = [c[0] for c in calls]
    longest = max((c[1] - c[0] for c in calls), default=0) + SLACK_NS
    out = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if b <= a:
            continue
        hi = bisect.bisect_right(starts, a)
        lo = bisect.bisect_left(starts, a - longest)
        inside = [c for c in calls[lo:hi] if c[0] <= a <= c[1] + SLACK_NS]
        if inside:
            out.append((b - a, max(inside, key=lambda c: c[1] - c[0])))
    return out


class _Nested:
    """Properly nested intervals of one thread (ranges and backward nodes
    open and close in order there); which is innermost at a time."""

    def __init__(self, items: list[tuple]):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.items]
        self.parent = []  # index of the interval that encloses each, or -1
        stack: list[int] = []
        for i, (s, t, *_) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: int):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return self.items[i] if i >= 0 else None


def span_ms_per_step(ctx, name: str) -> float | None:
    """Device ms an update of every operation that belongs to span
    ``name``, forward and backward."""
    att = attribution(ctx)
    if att is None or not ctx.steps:
        return None
    return att.device_ns(name) / ctx.steps / 1e6
