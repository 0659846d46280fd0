"""Training steps (counterpart of ``surfacenetworks_tpu/train/loop.py``).

The JAX package's ``TrainState`` is a pytree of parameters, optimizer state
and step count updated by a jitted step; here it is the module, its
optimizer (``train/optim.py``), the LR schedule and the update count.
``update`` is the one update every trainer takes, on one device or on this
rank's shard of a rank grid; ``make_train_step`` / ``make_eval_step`` wrap
it for ``apply_fn(model, batch) -> outputs`` and ``loss_fn(outputs, batch)
-> (loss, metrics)``, and ``dist.data_parallel.make_dp_train_step`` is
``make_train_step`` over a grid.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Any, Callable

import torch

from surfacenetworks_tpu_torch import parallel_context
from surfacenetworks_tpu_torch.train import optim
from surfacenetworks_tpu_torch.train.checkpoint import check_finite

if TYPE_CHECKING:
    from surfacenetworks_tpu_torch.dist.mesh_setup import Mesh

__all__ = ["TrainState", "check_finite", "make_eval_step", "make_train_step", "update"]


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt: torch.optim.Optimizer
    schedule: Any = None
    step: int = 0


def update(model: torch.nn.Module, opt: torch.optim.Optimizer, body: Callable, schedule=None,
           mesh: Mesh | None = None, vertex: bool = False) -> tuple[torch.Tensor, ...]:
    """One update: ``body() -> (loss, *metrics)`` (the forward and the loss,
    on the device), the loss's backward, the LR read from ``schedule`` at
    the optimizer's own count, and the optimizer step.  Returns the loss and
    the metrics, detached; the gradients stay in ``.grad`` until the next
    update.

    With ``mesh`` the batch is this rank's shard (of the mesh batch over the
    data axis, and of the vertex rows over the graph axis with ``vertex``):
    ``body`` runs in the grid's sharded context, so its loss is this rank's
    share of the global loss; the gradients are summed over every rank of
    the grid before the update, and the values returned are the global
    ones."""
    opt.zero_grad(set_to_none=True)
    with mesh.context(vertex=vertex) if mesh is not None else contextlib.nullcontext():
        loss, *metrics = body()
        loss.backward()
    values = (loss.detach(), *(m.detach() for m in metrics))
    if mesh is not None:
        parallel_context.sum_gradients(model.parameters(), mesh.world)
    optim.apply_schedule(opt, schedule)
    opt.step()
    if mesh is not None:
        values = tuple(parallel_context.total(torch.stack(values), [mesh.world]).unbind(0))
    return values


def make_train_step(apply_fn: Callable, loss_fn: Callable, mesh: Mesh | None = None, vertex: bool = False):
    """``step(state, batch) -> metrics``: ``update`` of ``state`` on
    ``batch`` (over ``mesh`` where given) and the count; the metrics hold the
    loss under ``"loss"`` (detached, on the device)."""

    def step(state: TrainState, batch) -> dict:
        names = ["loss"]

        def body():
            loss, metrics = loss_fn(apply_fn(state.model, batch), batch)
            names.extend(metrics)
            return (loss, *metrics.values())

        values = update(state.model, state.opt, body, state.schedule, mesh, vertex)
        state.step += 1
        return dict(zip(names, values))

    return step


def make_eval_step(apply_fn: Callable, loss_fn: Callable):
    @torch.no_grad()
    def step(model: torch.nn.Module, batch) -> dict:
        loss, metrics = loss_fn(apply_fn(model, batch), batch)
        return {"loss": loss, **metrics}

    return step
