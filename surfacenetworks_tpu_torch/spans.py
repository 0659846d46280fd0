"""Named spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` counts the span in ``span_counts`` and, while the profiler
records, opens a ``torch.profiler.record_function`` range of that name, on
the calling thread (autograd's, in a backward).  With the profiler off it
returns one shared null context: an untraced update pays a counter
increment and a flag read a span, where an unguarded ``record_function``
would cost about fifteen times as much.  A span never synchronises,
allocates on the device or adds a tensor operation, and opens no range
while ``torch.export`` or ``torch.compile`` traces, so no exported program
holds one.

The names, one a layer boundary (the readers of a trace rely on them):

* ``snx:batch``: one batch's assembly on each route of
  ``data/pipeline.py`` (the device store's index upload and its gather, the
  graph store's gather, the host route's wait for its worker and upload);
* ``snx:update``: ``train/loop.py::update``, every trainer's step, and in it
  ``snx:forward`` (the forward and the loss), ``snx:backward`` (the loss's
  backward) and ``snx:optimizer`` (the gradient sum over ranks, the LR and
  the optimizer step);
* ``snx:bn``: ``nn/layers.py::GraphBatchNorm.forward``;
* ``snx:linear``: ``nn/layers.py::GraphConv1x1``'s per-vertex linear map;
* ``snx:apply:lap``, ``snx:apply:dirac``: the forward and the backward of the
  operator applies of ``sparse/ops.py``; ``snx:apply:gat``:
  ``nn/blocks.py::gat_attend``'s forward.

Autograd runs the backward of the ATen operations inside a span outside
it (on its own thread on the card); a reader puts that work down to the
span through the profiler's sequence numbers, which tie each backward
node to the forward operation that made it.

``train/timing.py`` re-exports this module's names; it lives apart so that
``nn`` and ``sparse`` import it without importing ``train``.
"""

from __future__ import annotations

import collections
import contextlib

import torch

__all__ = ["reset_span_counts", "span", "span_counts"]

# spans opened, by name, since the last reset.  One thread counts at a time in
# this program (the main thread, or autograd's while the main thread waits in
# the backward), which the unlocked ``+=`` relies on; a reader that finds the
# trace and the count apart reads nothing
span_counts: collections.Counter = collections.Counter()

_NULL = contextlib.nullcontext()


def reset_span_counts() -> None:
    span_counts.clear()


def span(name: str):
    """A context manager over one span called ``name``: a profiler range
    while the profiler records (and nothing is being traced for export),
    otherwise a shared null context.  Counted in ``span_counts`` either
    way."""
    span_counts[name] += 1
    if torch.autograd._profiler_enabled() and not torch.compiler.is_compiling():
        return torch.profiler.record_function(name)
    return _NULL
