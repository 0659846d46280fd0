"""A reference run over the benchmark's meshes: the padded inputs and
targets of a batch, its operators, the model's loss and the first steps of
Adam."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from portbench.reference import plain


@dataclasses.dataclass
class Batch:
    inputs: torch.Tensor  # [B, N, 3]
    targets: torch.Tensor  # [B, N, 3]
    mask: torch.Tensor  # [B, N, 1]


class Problem:
    """``meshes`` (float64 ``(V, F)``); ``structure`` the model's (linears,
    norms); ``operators(idx, n_rows, n_faces)`` the operators of the meshes
    ``idx``, each padded to ``n_rows`` vertices and ``n_faces`` faces;
    ``model(params, ops, batch)`` its outputs.  A batch is ``(idx, n_rows,
    n_faces)``: its meshes and what the program padded each to."""

    def __init__(self, meshes: list, structure: tuple, operators: Callable, model: Callable, device,
                 dtype=torch.float32):
        self.meshes, self.structure = meshes, structure
        self.operators, self.model, self.device, self.dtype = operators, model, device, dtype
        self.targets = [plain.vertex_normals(V, F).astype(np.float32) for V, F in meshes]

    def batch(self, idx: list, n: int) -> Batch:
        b = len(idx)
        x, t, m = (np.zeros((b, n, c), np.float32) for c in (3, 3, 1))
        for k, i in enumerate(idx):
            V = self.meshes[i][0]
            x[k, : len(V)] = V.astype(np.float32)
            t[k, : len(V)] = self.targets[i]
            m[k, : len(V)] = 1.0
        return Batch(*(torch.from_numpy(a).to(self.device, self.dtype) for a in (x, t, m)))

    def params(self) -> dict:
        return {k: v.detach().to(self.dtype).requires_grad_(True)
                for k, v in plain.init_params(*self.structure, self.device).items()}

    def loss(self, params: dict, batch: tuple) -> torch.Tensor:
        idx, n_rows, n_faces = batch
        padded = self.batch(idx, n_rows)
        out = self.model(params, self.operators(idx, n_rows, n_faces), padded)
        return plain.normal_loss(out, padded.mask, padded.targets)

    def steps(self, batches: list, lr: float) -> plain.Steps:
        return plain.train_steps(self.params(), self.loss, batches, lr)
