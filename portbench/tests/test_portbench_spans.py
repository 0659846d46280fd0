"""``portbench/spans.py``: the program's ``snx:`` spans read from a profile.

On the CPU, from a recorded profile of one update of a tiny LapDeepModel
(ELL): the ranges against the program's counts, and each backward put down
to its forward's span; the instrument that keeps the window's profile; the
stall gaps and the nesting on made-up intervals.  On the card (marked
``cuda``): every ``snx:`` range lies inside the benchmark's
``portbench:host:*`` spans on the same clock, and the device operations
that the program's ``snx:apply:dirac`` spans own are the very set that the
benchmark's own ranges around ``_gather_apply`` and ``_vertex_side``
(``portbench:apply:dirac``) hold; the port's Laplacian kernels all belong to
``snx:apply:lap``.
"""

import collections
import json
import os
import types

import pytest

from portbench import bench, spans

EVALUATE = "autograd::engine::evaluate_function: "


def _session(root, config, vertices, batch, device, tmp_path, flags=()):
    driver = bench.load_file_module(os.path.join(root, "portbench", "drivers", "train_normal.py"),
                                    "portbench_driver_train_normal")
    with open(os.path.join(root, "portbench", "configs", f"{config}.json")) as fh:
        conf = {**json.load(fh), "name": config}
    traffic = {"trainer": "train_normal", "train_meshes": 4, "test_meshes": 1, "vertices": vertices,
               "test_path": True, "flags": ["--batch-size", str(batch), *flags]}
    return driver.Session({**conf, "layers": conf["layers"] if device == "cuda" else 3}, traffic, 2**33 + 5, device,
                          str(tmp_path), lambda m: None)


def _window(session, updates, sync=lambda: None):
    """``updates`` updates under the profiler, inside the benchmark's host
    spans as the harness's window opens them; the profile and the program's
    span counts over it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from surfacenetworks_tpu_torch.spans import span_counts

    feed = session.batches(updates + 2)
    for _ in range(2):
        session.update(next(feed))
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    before = collections.Counter(span_counts)
    with profile(activities=activities) as prof:
        for _ in range(updates):
            with torch.profiler.record_function("portbench:host:batch"):
                batch = next(feed)
            with torch.profiler.record_function("portbench:host:update"):
                session.update(batch)
        sync()
    feed.close()
    return prof, collections.Counter(span_counts) - before


def test_a_recorded_cpu_update(root, tmp_path):
    import torch

    torch.set_num_threads(2)
    session = _session(root, "lap15", 120, 2, "cpu", tmp_path, ["--operator-format", "ell"])
    prof, counted = _window(session, 1)
    att = spans.Attribution(prof.profiler.kineto_results.events())
    assert spans.check_counts(att.range_counts(), counted, 1)
    assert {"snx:update", "snx:forward", "snx:backward", "snx:optimizer", "snx:bn", "snx:linear",
            "snx:apply:lap", "snx:batch"} <= set(counted)
    assert not att.ops  # no device here: the readers read nothing
    seen = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if not name.startswith(EVALUATE):
            continue
        node = name[len(EVALUATE):]
        owner = att.owner(e.start_thread_id(), e.start_ns())
        if node == "AddmmBackward0":
            assert owner == ("snx:linear", True)
        elif node in ("MeanBackward1", "SqrtBackward0"):
            assert owner == ("snx:bn", True)
        elif node == "_EllApplyBackward":
            assert owner == ("snx:forward", True)  # the Function's own event opens before its span
        seen[node] += 1
    assert seen["AddmmBackward0"] and seen["MeanBackward1"] and seen["_EllApplyBackward"]
    # inside the apply's backward, its own span owns the work
    for e in prof.profiler.kineto_results.events():
        if e.name() == "snx:apply:lap":
            assert att.owner(e.start_thread_id(), e.start_ns() + e.duration_ns() // 2) == ("snx:apply:lap", False)


def test_the_count_check():
    c = collections.Counter
    assert spans.check_counts(c({"snx:bn": 4}), c({"snx:bn": 4}), 2)
    assert not spans.check_counts(c(), None, 2)  # a program without spans
    assert not spans.check_counts(c(), c(), 2)
    assert not spans.check_counts(c({"snx:bn": 3}), c({"snx:bn": 4}), 2)  # the trace lost a range
    assert not spans.check_counts(c({"snx:bn": 4}), c({"snx:bn": 4, "snx:linear": 1}), 2)
    assert not spans.check_counts(c({"snx:bn": 4}), None, 2)


def test_the_instrument_keeps_one_profile_and_restores(capsys):
    import torch
    from torch.profiler import ProfilerActivity

    from surfacenetworks_tpu_torch.spans import span

    cls = torch.profiler.profile
    own = cls.start, cls.stop
    with spans.instrument(), spans.instrument():
        assert cls.start is not own[0]
        with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
            with span("snx:bn"):
                torch.ones(2).sum()
    assert (cls.start, cls.stop) == own
    ctx = types.SimpleNamespace(trace=object(), steps=1)
    assert spans.attribution(ctx) is None  # the CPU traces no device operation
    err = capsys.readouterr().err
    assert "span check passed" in err and "no device operation" in err


def test_stall_gaps():
    us = 1000
    busy = [(0, 100 * us), (150 * us, 200 * us), (300 * us, 400 * us), (1000 * us, 1100 * us),
            (1300 * us, 1400 * us), (1500 * us, 1600 * us)]
    sync = (90 * us, 151 * us, "cudaStreamSynchronize", 1)  # the device drains at 100 while the host waits
    free = (250 * us, 260 * us, "cudaFree", 1)  # the gap at 200 opened before the call
    malloc = (380 * us, 500 * us, "cudaMalloc", 2)
    skewed = (1050 * us, 1100 * us - spans.SLACK_NS, "cudaStreamSynchronize", 1)  # returned as the device drained
    early = (1350 * us, 1400 * us - spans.SLACK_NS - 1, "cudaStreamSynchronize", 1)  # returned before it drained
    gaps = spans.stall_gaps(busy, [sync, free, malloc, skewed, early])
    assert gaps == [(50 * us, sync), (600 * us, malloc), (200 * us, skewed)]
    assert spans.stall_gaps(busy, []) == []


def test_the_innermost_interval():
    nested = spans._Nested([(0, 100, "update"), (10, 20, "bn"), (30, 90, "backward"), (40, 50, "bn"),
                            (200, 300, "update")])
    assert [None if (x := nested.innermost(t)) is None else x[2] for t in (5, 15, 25, 45, 60, 150, 250)] == [
        "update", "bn", "update", "bn", "backward", None, "update"]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["dir15", "lap15"])
def test_program_spans_against_the_benchmarks_ranges(cuda_device, root, config, tmp_path):
    import torch

    from portbench.trace import KERNEL_SYMBOLS, Trace

    # the Laplacian as the cell runs it (``auto`` picks dense at 2,000 vertices)
    session = _session(root, config, 2000, 4, cuda_device, tmp_path,
                       ["--operator-format", "bsr"] if config == "lap15" else [])
    dirac = bench.metric_reader(root, "dirac_apply_roofline.train")
    with dirac.instrument(), spans.instrument():
        prof, counted = _window(session, 2, torch.cuda.synchronize)
    trace = Trace(prof)
    att = spans.Attribution(prof.profiler.kineto_results.events())
    assert spans.check_counts(att.range_counts(), counted, 2)
    host = trace.host_ranges["portbench:host:batch"] + trace.host_ranges["portbench:host:update"]
    for nested in att.spans.values():
        for s, t, name in nested.items:
            assert any(a <= s and t <= b for a, b in host), (name, s, t)
    owned = {name: collections.Counter((s, t, n) for s, t, o, n in att.ops if o == name) for name in counted}
    if config == "dir15":
        theirs = collections.Counter((o.start_ns, o.end_ns, o.name) for o in trace.in_range("portbench:apply:dirac"))
        assert theirs and owned["snx:apply:dirac"] == theirs
    else:
        kernels = trace.matching([rf"\b{sym}\b" for sym in KERNEL_SYMBOLS.values()])
        assert kernels and all(owned["snx:apply:lap"][(o.start_ns, o.end_ns, o.name)] for o in kernels)
    assert att.device_ns("snx:bn") > 0 and att.device_ns("snx:linear") > 0
    print({name: att.device_ns(name) / 2e6 for name in counted}, att.stalls())
