"""The Laplacian applies' share of their roofline: for each traced launch
of the port's operator-apply kernels (the name patterns in this metric's
folder), forward or backward, the least time its work takes, summed, over
their summed device time.  The work is the Laplacian's, whatever format
the program picked: every nonzero's index and value read once, x read once,
the result written once, ``2 nnz C`` operations; over the real vertices of
every mesh of the update."""

from portbench import work

NAME = "lap_apply_roofline.train"


def read(ctx):
    if ctx.trace is None:
        return None
    ops = ctx.trace.matching(ctx.patterns(NAME))
    if not ops:
        return None
    c = ctx.cell.config["width"]

    def per_mesh(v, f, e):
        nnz = work.laplacian_nnz(v, e)
        return work.lap_apply_bytes(v, nnz, c), work.apply_flops(nnz, c)

    # each launch covers its update's whole batch, and every update makes as many
    least = len(ops) / ctx.steps * sum(work.bound_s(b, f) for b, f in ctx.update_sums(per_mesh))
    return 100.0 * least / sum(o.seconds for o in ops)
