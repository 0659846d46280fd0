"""Device ms per update of the batch norms (``nn/layers.py::GraphBatchNorm``):
every operation launched inside the program's ``snx:bn`` spans, and every
operation of autograd's backward of the operations launched there, which
runs outside the span (``portbench/spans.py``).  None where the program
opens no span or the trace lost one."""

from portbench import spans

SPAN = "snx:bn"


def instrument():
    return spans.instrument()


def read(ctx):
    return spans.span_ms_per_step(ctx, SPAN)
