"""The host's own work per update, from the traced window: its wall inside
the benchmark's spans around the trainer's calls (``train_batches``'s next
batch, the store's gather; ``update``: the forward, the loss, the backward
and Adam dispatched), less its waits on the device inside the runtime's
calls (``trace.Trace.host_work_s``): a launch into a full queue, a
synchronise.  What is left is Python, the framework's dispatch and each
runtime call at its least cost, with the profiler's own cost per operation;
a CUDA graph would take most of it away."""


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    work, _ = ctx.trace.host_work_s()
    return work / ctx.steps * 1e3
