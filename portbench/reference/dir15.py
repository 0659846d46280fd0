"""Plain reference of ``dir15``: DirDeepModel (Surface Networks, Kostrikov
et al., CVPR 2018; the reference repository's Dirac ``normal_predict``
model) in plain PyTorch.

``conv1`` maps the 3 input coordinates to 128 vertex channels; a face
stream starts at zero.  Even layers are Dirac blocks: ``f' = BN-linear([elu
f || D elu v])`` and ``v + BN-linear([elu v || DA elu f'])``, ``D`` the
extrinsic Dirac operator and ``DA`` its adjoint on quaternion rows (128
channels as 32 quaternions); odd layers are global-average blocks on the
vertex stream.  The head is a batch-normed linear map to 3 channels and an
ELU, with no input residual.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import plain
from portbench.reference.problem import Problem


@dataclasses.dataclass
class DiracPair:
    d: plain.SparsePair  # faces from vertices
    da: plain.SparsePair  # vertices from faces
    n_faces: int


def forward(p: dict, layers: int, op: DiracPair, x_in: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    v = plain.linear(x_in, p, "conv1.fc")
    f = v.new_zeros(v.shape[0], op.n_faces, v.shape[-1])
    for i in range(layers):
        if i % 2 == 0:
            xv, xf = plain.elu(v), plain.elu(f)
            f = plain.conv(torch.cat([xf, plain.apply_quaternion(op.d, xv)], -1), p, f"rn{i}.bn_fc0", pre_bn=True)
            dv = plain.conv(torch.cat([xv, plain.apply_quaternion(op.da, plain.elu(f))], -1), p, f"rn{i}.bn_fc1",
                            pre_bn=True)
            v = v + dv
        else:
            x = v
            for j in range(2):
                x = plain.elu(x)
                x = plain.conv(torch.cat([x, plain.masked_mean_rows(x, mask).expand_as(x)], -1), p,
                               f"rn{i}.bn_fc{j}", pre_bn=True)
            v = v + x
    return plain.elu(plain.conv(v, p, "conv2", pre_bn=True))


def build(config: dict, meshes: list, device, dtype=torch.float32) -> Problem:
    """The reference over ``meshes`` (float64 ``(V, F)``)."""
    layers = config["layers"]
    pairs = [plain.dirac_pair(V, F) for V, F in meshes]

    def operators(idx, n_rows, n_faces):
        return DiracPair(plain.SparsePair.batch([pairs[i][0] for i in idx], 4 * n_faces, 4 * n_rows, device, dtype),
                         plain.SparsePair.batch([pairs[i][1] for i in idx], 4 * n_rows, 4 * n_faces, device, dtype),
                         n_faces)

    def model(p, op, batch):
        return forward(p, layers, op, batch.inputs, batch.mask)

    return Problem(meshes, plain.deep_structure(layers), operators, model, device, dtype)
