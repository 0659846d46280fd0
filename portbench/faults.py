"""Faults planted in the program's timed path, for the check's controls:
each takes the session after set-up has built it and breaks what the
window drives, and the comparison has to read ``correct`` false."""

from __future__ import annotations


def state_unchanged(session) -> None:
    """Every update computes its loss and gradients and leaves the
    parameters as they were."""
    session.opt.step = lambda *a, **k: None


def half_batch(session) -> None:
    """Each update takes the first half of its batch's meshes and the mean
    over them alone."""
    from surfacenetworks_tpu_torch.data import pipeline
    from surfacenetworks_tpu_torch.data.batching import MeshBatch

    update = session.update

    def cut(batch):
        import torch

        b = batch.inputs.shape[0]
        keep = torch.arange(b // 2, device=batch.inputs.device)
        half = MeshBatch(**{k: pipeline._take(getattr(batch, k), keep) for k in pipeline._FIELDS},
                         names=list(batch.names)[: b // 2])
        return update(half)

    session.update = cut


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
