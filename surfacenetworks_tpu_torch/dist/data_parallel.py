"""Data-parallel training over the rank grid (counterpart of
``surfacenetworks_tpu/dist/data_parallel.py``).

Each rank draws the same global batch (the same seeded sampler) and keeps
its shard of the mesh batch (``shard_batch``); parameters are replicated,
broadcast from rank 0 at the start (``replicate``).  The step computes the
global function JAX's GSPMD step computes, not an average of rank-local
models: the model body runs in the batch-sharded context (batch-norm
statistics over the global batch), each loss returns this rank's share of
the global loss, and the gradients are summed over the ranks
(``parallel_context.sum_gradients``: one ``all_reduce(SUM)`` of every
gradient, flattened in the parameters' order), so the same optimizer update
runs on every rank.  The step is ``train/loop.py``'s ``update``, the one
every trainer takes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from surfacenetworks_tpu_torch.dist.mesh_setup import Mesh, batch_sharding
from surfacenetworks_tpu_torch.train import loop


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's shard of the leading (mesh-batch) axis of ``batch``: a
    tensor, a list (a global batch's samples or picks) or a ``MeshBatch``
    (every tensor through its operator and ``aux``, its names alike)."""
    n = len(batch) if isinstance(batch, (list, torch.Tensor)) else batch.inputs.shape[0]
    return _take(batch, batch_sharding(mesh, n))


def _take(obj: Any, sl: slice) -> Any:
    if isinstance(obj, (torch.Tensor, list)):
        return obj[sl]
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _take(getattr(obj, f.name), sl) for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_take(o, sl) for o in obj)
    if isinstance(obj, dict):
        return {k: _take(v, sl) for k, v in obj.items()}
    return obj


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the grid's first
    rank to every rank of the grid (in place)."""
    import torch.distributed as dist

    if mesh.world.group is None:  # a lone rank without a process group
        return module
    src, group = mesh.world.ranks[0], mesh.world.group
    for t in list(module.parameters()) + list(module.buffers()):
        if mesh.world.staged and t.is_cuda:
            host = t.detach().cpu()
            dist.broadcast(host, src=src, group=group)
            t.copy_(host)
        else:
            dist.broadcast(t.data, src=src, group=group)
    return module


def make_dp_train_step(apply_fn: Callable, loss_fn: Callable, mesh: Mesh, vertex: bool = False):
    """The train step over this rank's shard (``loop.make_train_step`` over
    ``mesh``): ``apply_fn(model, batch)`` and ``loss_fn(outputs, batch) ->
    (loss share, metrics shares)`` run in the grid's sharded context (the
    vertex rows too with ``vertex``), the gradients are summed over the
    ranks and the update applied.  Returns the global loss and metrics
    (summed over the ranks, on the device)."""
    return loop.make_train_step(apply_fn, loss_fn, mesh, vertex)
