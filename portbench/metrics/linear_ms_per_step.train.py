"""Device ms per update of ``GraphConv1x1``'s per-vertex linear map
(``nn/layers.py``): every operation launched inside the program's
``snx:linear`` spans, and every operation of autograd's backward of them
(the GEMMs of the input's and the weights' gradients, the bias's sum;
``portbench/spans.py``).  None where the program opens no span or the trace
lost one."""

from portbench import spans

SPAN = "snx:linear"


def instrument():
    return spans.instrument()


def read(ctx):
    return spans.span_ms_per_step(ctx, SPAN)
