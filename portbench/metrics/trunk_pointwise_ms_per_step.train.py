"""Device ms per update in ATen's elementwise, reduction and concatenation
kernels (the name patterns in this metric's folder): the trunk's batch
norms, ELUs, residual adds and concatenations, and the loss; kernels
launched inside an operator apply's range (``portbench:apply:...``) belong
to the apply and are left out."""

NAME = "trunk_pointwise_ms_per_step.train"


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    ops = [o for o in ctx.trace.matching(ctx.patterns(NAME))
           if not any(r.startswith("portbench:apply:") for r in o.ranges)]
    if not ops:
        return None
    return sum(o.seconds for o in ops) / ctx.steps * 1e3
