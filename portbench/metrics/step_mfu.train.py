"""The whole step's share of the chip's fp32 peak: model operations of
every update in the window (``work.deep_model_flops`` of each mesh, over its
real vertices and faces: every per-vertex linear map forward and backward,
``2 nnz C`` an operator apply) over the traced window's length on the host's
clock, over 67 TFLOP/s (fp32 outside the tensor cores; the port turns TF32
off).  The profiler's cost on the host is in that window."""

from portbench import work


def read(ctx):
    if not ctx.steps:
        return None
    peak = work.PEAK_FLOP_PER_S[ctx.cell.config["precision"]]
    return 100.0 * ctx.window_flops() / ctx.window_s / peak
