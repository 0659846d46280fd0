"""What decides ``correct``: the program's first three updates, read from
the training object that the window then drives, against the plain
reference's three steps from the same initialisation on the same meshes.

Five numbers, each against its limit in ``portbench/limits/<workload>.json``
(a null limit: not compared in that cell):

* ``loss_gap``: the widest gap between the program's loss and the
  reference's over the three steps, as a share of the reference's;
  ``loss1_gap`` the same of the first step alone;
* ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over ``1 - beta1``), by the worst leaf: the gap
  between the program's norm and the reference's, as a share of the larger
  of the reference's norm of that leaf and of the median leaf;
  ``grad_median_gap`` the median leaf's gap, measured the same way;
* ``change_gap``: each leaf's change over the three steps, measured the
  same way, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by rounding alone).
"""

from __future__ import annotations

import json
import math
import os

import torch

from portbench.reference import plain

CHECK_STEPS = 3
NULL_GRAD_SHARE = 1e-3
NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap", "change_gap")


class ProgramCapture:
    """Snapshots of the program's model and optimizer around its first
    ``CHECK_STEPS`` updates."""

    def __init__(self, model: torch.nn.Module, opt: torch.optim.Optimizer):
        self.model, self.opt = model, opt
        self.start = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.losses: list = []
        self.batches: list = []
        self.grad_norms: dict = {}
        self.change_norms: dict = {}

    def after_update(self, loss: torch.Tensor, batch: tuple) -> None:
        """``batch``: the update's meshes and the rows and faces the program
        padded each to, as the reference takes them."""
        self.losses.append(loss.detach().clone())
        self.batches.append(batch)
        if len(self.losses) == 1:
            self.grad_norms = self._first_gradient_norms()
        if len(self.losses) == CHECK_STEPS:
            self.change_norms = {n: float(torch.linalg.vector_norm((p.detach() - self.start[n]).double()))
                                 for n, p in self.model.named_parameters()}
            self.start = None

    def _first_gradient_norms(self) -> dict:
        out = {}
        for group in self.opt.param_groups:
            beta1 = group["betas"][0]
            for p in group["params"]:
                m = self.opt.state.get(p, {}).get("exp_avg")  # none where the step left no state
                out[id(p)] = float(torch.linalg.vector_norm(m.double())) / (1.0 - beta1) if m is not None else math.nan
        return {n: out[id(p)] for n, p in self.model.named_parameters()}

    def steps(self) -> plain.Steps:
        return plain.Steps([float(x) for x in self.losses], self.grad_norms, self.change_norms)


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """Each leaf's ``|prog - ref| / max(ref, median ref)`` (a leaf the
    program lacks reads infinite)."""
    leaves = list(ref) if leaves is None else list(leaves)
    floor = plain.median([ref[k] for k in leaves])
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-300) if k in prog else math.inf for k in leaves}


def worst(gaps: dict) -> tuple[float, str]:
    """The largest gap and its leaf; NaN counts as the largest."""
    name = max(gaps, key=lambda k: math.inf if math.isnan(gaps[k]) else gaps[k])
    return (math.inf if math.isnan(gaps[name]) else gaps[name]), name


def gaps(prog: plain.Steps, ref: plain.Steps) -> dict:
    """The numbers compared (and the leaves that set the worst ones)."""
    if len(prog.losses) != len(ref.losses):
        raise ValueError(f"{len(prog.losses)} program steps against {len(ref.losses)} reference steps")
    steps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf for p, r in zip(prog.losses, ref.losses)]
    grads = leaf_gaps(prog.grad_norms, ref.grad_norms)
    floor = plain.median(ref.grad_norms.values())
    moved = [k for k, g in ref.grad_norms.items() if g >= NULL_GRAD_SHARE * floor]
    grad, grad_leaf = worst(grads)
    change, change_leaf = worst(leaf_gaps(prog.change_norms, ref.change_norms, moved))
    median = plain.median([math.inf if math.isnan(g) else g for g in grads.values()])
    return {"loss_gap": max(steps), "loss1_gap": steps[0], "grad_gap": grad, "grad_median_gap": median,
            "change_gap": change, "loss_steps": steps,
            "leaves": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                       "null_grad": sorted(set(ref.grad_norms) - set(moved))}}


def limits_path(root: str, workload: str) -> str:
    return os.path.join(root, "portbench", "limits", f"{workload}.json")


def load_limits(root: str, workload: str) -> dict:
    with open(limits_path(root, workload)) as fh:
        return json.load(fh)["limits"]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit; a number whose limit
    is null is not compared in this cell (``PERF.md`` says why)."""
    held = [k for k in NUMBERS if limits.get(k) is not None]
    if not held:
        raise ValueError("no number has a limit")
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in held)
    # a number that is not finite is printed as its name: strict JSON has no NaN
    return ok, {k: {"value": numbers[k] if math.isfinite(numbers[k]) else str(numbers[k]), "limit": limits[k]}
                for k in held}
