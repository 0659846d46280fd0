"""Plain reference of ``lap15``: LapDeepModel (Surface Networks, Kostrikov
et al., CVPR 2018; the reference repository's ``normal_predict`` model) in
plain PyTorch.

``conv1`` maps the 3 input coordinates to 128 channels; ``layers`` residual
blocks follow, a Laplacian block on even layers and a global-average block
on odd ones, each two steps of ELU, ``[x || A x]`` (``A`` the cotangent
Laplacian, or the mean over the mesh's vertices) and a batch-normed linear
map back to 128 channels, plus the block's input; the head is ELU, a
batch-normed linear map to 3 channels, plus the input coordinates.
"""

from __future__ import annotations

import torch

from portbench.reference import plain
from portbench.reference.problem import Problem


def forward(p: dict, layers: int, lap: plain.SparsePair, x_in: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x = plain.linear(x_in, p, "conv1.fc")
    for i in range(layers):
        block_in = x
        for j in range(2):
            x = plain.elu(x)
            nb = plain.apply(lap, x) if i % 2 == 0 else plain.masked_mean_rows(x, mask).expand_as(x)
            x = plain.conv(torch.cat([x, nb], -1), p, f"rn{i}.bn_fc{j}", pre_bn=True)
        x = x + block_in
    x = plain.conv(plain.elu(x), p, "conv2", pre_bn=True)
    return x + x_in


def build(config: dict, meshes: list, device, dtype=torch.float32) -> Problem:
    """The reference over ``meshes`` (float64 ``(V, F)``)."""
    layers = config["layers"]
    ops = [plain.cot_laplacian(V, F) for V, F in meshes]

    def operators(idx, n_rows, n_faces):
        return plain.SparsePair.batch([ops[i] for i in idx], n_rows, n_rows, device, dtype)

    def model(p, op, batch):
        return forward(p, layers, op, batch.inputs, batch.mask)

    return Problem(meshes, plain.deep_structure(layers), operators, model, device, dtype)
