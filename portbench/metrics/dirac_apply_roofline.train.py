"""The Dirac applies' share of their roofline.  Each apply (``Di v``,
``DiA f``, and their backwards; ``sparse/ops.py``) runs inside a profiler
range ``portbench:apply:dirac`` that ``instrument`` puts around the port's
``_gather_apply`` and ``_vertex_side`` (its overflow's gather inside the
same range), as the port's ``chip_smoke.py::annotated_dirac_applies``
does.  Each apply's least time: its live quaternion coefficients (one a face
corner, ``3M``) with their row indices read once, the features read once,
the result written once (``V + M`` rows of ``C`` channels), ``8 C``
operations a coefficient; over every mesh of the update.  The share is the
applies' least times summed over the device time of every kernel launched
inside the ranges."""

import contextlib

from portbench import work

RANGE = "portbench:apply:dirac"


@contextlib.contextmanager
def instrument():
    import torch

    from surfacenetworks_tpu_torch.sparse import ops

    saved = ops._gather_apply, ops._vertex_side
    depth = [0]

    def ranged(fn):
        def call(*args):
            if depth[0]:
                return fn(*args)
            depth[0] += 1
            try:
                with torch.profiler.record_function(RANGE):
                    return fn(*args)
            finally:
                depth[0] -= 1
        return call

    ops._gather_apply, ops._vertex_side = (ranged(fn) for fn in saved)
    try:
        yield
    finally:
        ops._gather_apply, ops._vertex_side = saved


def read(ctx):
    if ctx.trace is None:
        return None
    found = ctx.trace.in_range(RANGE)
    applies = len(ctx.trace.host_ranges.get(RANGE, ()))
    if not found or not applies:
        return None
    c = ctx.cell.config["width"]
    # each apply covers its update's whole batch, and every update makes as many
    per_update = [work.bound_s(b, f) for b, f in ctx.update_sums(
        lambda v, m, e: (work.dirac_apply_bytes(v, m, 3 * m, c), work.dirac_apply_flops(3 * m, c)))]
    least = applies / ctx.steps * sum(per_update)
    return 100.0 * least / sum(o.seconds for o in found)
