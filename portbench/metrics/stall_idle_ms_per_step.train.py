"""Device idle ms per update in the gaps that open while a host thread sits
in a runtime call that blocks on the device or the driver (a synchronise,
a blocking ``cudaMemcpy``, ``cudaMalloc``, ``cudaFree``), each gap counted
up to the next device operation (``portbench/spans.py::stall_gaps``).
Prints each cause to standard error: the call and the program's span it
belongs to (a backward's, marked so, is put down to its forward's span),
with its ms an update; and, for the longest gaps of the window, stalls or
not, what each host thread was doing as the gap opened (its span and the
runtime call in flight).  None where the program opens no span or the trace
lost one."""

import sys

from portbench import spans


def instrument():
    return spans.instrument()


def read(ctx):
    att = spans.attribution(ctx)
    if att is None or not ctx.steps:
        return None
    total, causes = att.stalls()
    for (call, span), ns in causes.most_common():
        print(f"stall: {call} in {span}: {ns / ctx.steps / 1e6:.4f} ms an update", file=sys.stderr, flush=True)
    for length, start in att.longest_gaps(8):
        print(f"gap: {length / 1e6:.3f} ms: {'; '.join(att.doing(start))}", file=sys.stderr, flush=True)
    return total / ctx.steps / 1e6
