"""The port's spans (``surfacenetworks_tpu_torch/spans.py``) on the CPU.

* With the profiler off ``span`` returns one shared null context, never
  enters ``record_function``, and counts; with it on, a named range that
  nests.
* One profiled update of the normal trainer (``LapDeepModel`` over ELL, and
  ``DirDeepModel``) on the committed fixtures: ``snx:update`` holds the
  update's three phases, one ``snx:bn`` a batch-norm call, one
  ``snx:apply:*`` an apply, forward and backward, and ``span_counts`` equals
  the ranges in the trace.
* Autograd's backward nodes, tied to their forward operations by the
  profiler's sequence numbers, fall in the right span: every node of a
  ``GraphBatchNorm``'s operations (found by walking the autograd graph from
  its output to its input) in ``snx:bn``, none in ``snx:linear``, and every
  ``AddmmBackward0`` in ``snx:linear``.
* The profiler changes nothing: the parameters after one update are bit for
  bit the same with it on and off.  An exported model holds no profiler
  operation, exported with the profiler on or off.
"""

import collections
import copy
import io
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from surfacenetworks_tpu_torch import serve, spans
from surfacenetworks_tpu_torch.cli import train_normal
from surfacenetworks_tpu_torch.data import Buckets, datasets, laplacian_batch
from surfacenetworks_tpu_torch.models import LapDeepModel
from surfacenetworks_tpu_torch.nn.layers import GraphBatchNorm
from surfacenetworks_tpu_torch.train import timing

OBJS = pathlib.Path(__file__).parent / "fixtures" / "objs"
EVALUATE = "autograd::engine::evaluate_function: "
APPLY = {"ell": "snx:apply:lap", "dirac": "snx:apply:dirac"}
FUNCTIONS = {"ell": ("_EllApply",), "dirac": ("_DiracVF", "_DiracFV")}


def _trainer(kind, tmp_path):
    argv = ["--data-path", str(OBJS), "--layer", "2", "--batch-size", "2", "--num-updates", "1", "--num-epoch", "1",
            "--result-dir", str(tmp_path), "--device", "cpu"]
    argv += ["--model", "dirac"] if kind == "dirac" else ["--operator-format", "ell"]
    return train_normal.NormalTrainer(train_normal.parser.parse_args(argv), log=lambda _: None)


def _events(prof):
    """``(name, thread, start, end, sequence nr, forward thread)`` of every
    host event."""
    return [(e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns(), e.sequence_nr(),
             e.fwd_thread_id()) for e in prof.profiler.kineto_results.events()]


def _ranges(events, prefix="snx:"):
    return [e for e in events if e[0].startswith(prefix)]


def _within(inner, outer) -> bool:
    return inner[1] == outer[1] and outer[2] <= inner[2] and inner[3] <= outer[3]


def _innermost(ranges, tid, t):
    inside = [r for r in ranges if r[1] == tid and r[2] <= t <= r[3]]
    return max(inside, key=lambda r: r[2])[0] if inside else None


def test_span_off_is_a_shared_null_context_and_counted(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    assert not torch.autograd._profiler_enabled()
    timing.reset_span_counts()
    a, b = timing.span("snx:bn"), timing.span("snx:bn")
    assert a is b
    with a, timing.span("snx:linear"):
        pass
    assert entered == []
    assert timing.span_counts == {"snx:bn": 2, "snx:linear": 1}
    assert timing.span is spans.span and timing.span_counts is spans.span_counts
    timing.reset_span_counts()
    assert not spans.span_counts


def test_span_on_records_a_named_nested_range():
    spans.reset_span_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("snx:update"):
            with spans.span("snx:bn"):
                torch.ones(3).sum()
    ranges = _ranges(_events(prof))
    assert sorted(r[0] for r in ranges) == ["snx:bn", "snx:update"]
    (bn,), (update,) = ([r for r in ranges if r[0] == n] for n in ("snx:bn", "snx:update"))
    assert _within(bn, update) and bn[3] - bn[2] < update[3] - update[2]
    assert spans.span_counts == {"snx:update": 1, "snx:bn": 1}


def _profiled_update(trainer):
    """One warm update, then one under the profiler; the events, the span
    counts of the profiled update and the batch-norm calls in it."""
    feed = trainer.train_batches(2)
    trainer.update(next(feed))
    batch = next(feed)
    calls = []
    hooks = [m.register_forward_hook(lambda *_: calls.append(1)) for m in trainer.model.modules()
             if isinstance(m, GraphBatchNorm)]
    spans.reset_span_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.update(batch)
    for h in hooks:
        h.remove()
    return _events(prof), collections.Counter(spans.span_counts), len(calls)


@pytest.mark.parametrize("kind", ["ell", "dirac"])
def test_a_profiled_update_opens_every_span(kind, tmp_path):
    events, counted, bn_calls = _profiled_update(_trainer(kind, tmp_path))
    ranges = _ranges(events)
    assert collections.Counter(r[0] for r in ranges) == counted
    (update,) = [r for r in ranges if r[0] == "snx:update"]
    for phase in ("snx:forward", "snx:backward", "snx:optimizer"):
        (r,) = [r for r in ranges if r[0] == phase]
        assert _within(r, update), phase
    assert bn_calls > 0 and counted["snx:bn"] == bn_calls
    # every apply once forward (its Function's event) and once backward (its node)
    forward = [e for e in events if e[0] in FUNCTIONS[kind]]
    backward = [e for e in events if e[0].startswith(EVALUATE) and e[0][len(EVALUATE):].removesuffix("Backward")
                in FUNCTIONS[kind]]
    applies = [r for r in ranges if r[0] == APPLY[kind]]
    assert forward and len(backward) == len(forward) and len(applies) == 2 * len(forward)
    for call in forward + backward:
        assert sum(_within(r, call) for r in applies) == 1, call[0]
    assert not [r for r in ranges if r[0].startswith("snx:apply:") and r[0] != APPLY[kind]]


def _batch_norm_nodes(model) -> set:
    """The sequence numbers of the autograd nodes that each
    ``GraphBatchNorm`` call made: reached from its output's node, not from
    its input's."""
    seqs = set()

    def hook(module, args, out):
        stop = set()
        todo = [args[0].grad_fn]
        while todo:
            node = todo.pop()
            if node is not None and node not in stop:
                stop.add(node)
                todo += [n for n, _ in node.next_functions]
        todo = [out.grad_fn]
        seen = set()
        while todo:
            node = todo.pop()
            if node is None or node in stop or node in seen:
                continue
            seen.add(node)
            if type(node).__name__ != "AccumulateGrad":
                seqs.add(node._sequence_nr())
            todo += [n for n, _ in node.next_functions]

    return seqs, [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, GraphBatchNorm)]


@pytest.mark.parametrize("kind", ["ell", "dirac"])
def test_backward_nodes_fall_in_their_forward_span(kind, tmp_path):
    trainer = _trainer(kind, tmp_path)
    feed = trainer.train_batches(2)
    trainer.update(next(feed))
    batch = next(feed)
    bn_seqs, hooks = _batch_norm_nodes(trainer.model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.update(batch)
    for h in hooks:
        h.remove()
    events = _events(prof)
    ranges = _ranges(events)
    forward = {}
    for name, tid, s, _, seq, fwd_tid in events:
        if seq >= 0 and fwd_tid == 0 and not name.startswith(EVALUATE):
            forward[(tid, seq)] = min(s, forward.get((tid, seq), s))
    owner = collections.defaultdict(set)  # span -> node names
    bn_owners, evaluated = set(), set()
    for name, _, _, _, seq, fwd_tid in events:
        if name.startswith(EVALUATE) and seq >= 0:
            span = _innermost(ranges, fwd_tid, forward[(fwd_tid, seq)])
            owner[span].add(name[len(EVALUATE):])
            evaluated.add(seq)
            if seq in bn_seqs:
                bn_owners.add(span)
    assert bn_seqs and bn_seqs <= evaluated and bn_owners == {"snx:bn"}
    assert {"MeanBackward1", "SubBackward0", "DivBackward0"} <= owner["snx:bn"]
    assert "AddmmBackward0" in owner["snx:linear"]
    assert not [s for s, names in owner.items() if s != "snx:linear" and "AddmmBackward0" in names]


@pytest.mark.parametrize("kind", ["ell", "dirac"])
def test_the_profiler_changes_no_bit(kind, tmp_path):
    trainer = _trainer(kind, tmp_path)
    feed = trainer.train_batches(2)
    trainer.update(next(feed))
    batch = next(feed)
    model0, opt0 = copy.deepcopy(trainer.model.state_dict()), copy.deepcopy(trainer.opt.state_dict())
    trainer.update(batch)
    off = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.model.load_state_dict(model0)
    trainer.opt.load_state_dict(opt0)
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.update(batch)
    on = trainer.model.state_dict()
    assert off.keys() == on.keys()
    assert all(torch.equal(off[k], on[k]) for k in off), [k for k in off if not torch.equal(off[k], on[k])]


@pytest.mark.parametrize("profiled", [False, True])
def test_an_exported_model_holds_no_profiler_op(profiled):
    samples = datasets.synthetic_normal_dataset(1, 120, seed=0, operator="lap")
    batch = laplacian_batch(samples, Buckets.for_samples(samples))
    model = LapDeepModel(3, 3, layers=2)
    spans.reset_span_counts()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            blob = serve.export_forward(model, None, batch.operator, batch.mask, batch.inputs, platforms=("cpu",))
    else:
        blob = serve.export_forward(model, None, batch.operator, batch.mask, batch.inputs, platforms=("cpu",))
    assert spans.span_counts["snx:bn"] > 0  # the spans ran while the model was traced
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    out = serve.load(blob)(batch.inputs)
    assert torch.isfinite(out).all()
