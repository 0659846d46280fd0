"""FAUST dense-correspondence models (counterpart of
``surfacenetworks_tpu/models/correspondence.py``).

A shared trunk embeds each shape to 120-d per-vertex features; the siamese
head forms correspondence logits ``FA @ FB^T [B, NA, NB]``, or hands the two
feature sets to the streaming loss without forming them.  The trunks
(``TRUNKS``):

* ``Model`` (lap): Lap blocks on even layers, Avg blocks on odd ones; with
  ``remat`` each block runs under ``torch.utils.checkpoint`` (its
  activations recomputed in the backward, as ``nn.remat`` does);
* ``AmplifyModel`` (amp): the same on a squared-Laplacian pyramid (a list
  of operators, ``geometry.graph_ops.amp_pyramid``), even layer ``i``
  applying ``ops[min(i // 2, len(ops) - 1)]``;
* ``AvgModel`` (avg) and ``MlpModel`` (mlp): Avg or Mlp blocks only, no
  operator read; the Mlp trunk ends in a batch norm ``bn``, an ELU and a
  head without batch norm;
* ``DirModel`` (dir): Dirac blocks on even layers (vertex and face streams,
  the faces starting at zero), Avg blocks on the vertex stream on odd ones.

Submodule names follow the JAX package's flax names (``trunk``, ``conv1``,
``rn{i}``, ``bn``, ``conv2``), so ``convert.params_from_flax`` maps a flax
``SiameseModel`` tree onto ``state_dict``.  ``dtype`` is the trunk's
computation dtype: with bf16 the features are cast to bf16 (the trunk's
head is fp32 through the coordinate residual), as the JAX model's are, and
the logits are fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from surfacenetworks_tpu_torch.nn.blocks import AvgResNet2, DirResNet2, LapResNet2, MlpResNet2, dirac_num_faces
from surfacenetworks_tpu_torch.nn.layers import GraphBatchNorm, GraphConv1x1, at_least_fp32

WIDTH = 128
OUT = 120


def _head(x: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """The coordinate residual: the last three input channels tiled to OUT."""
    return x + inputs[..., -3:].repeat(1, 1, OUT // 3)


class _Trunk(nn.Module):
    """``conv1`` (3 -> WIDTH, no batch norm), the blocks ``rn{i}`` made by
    ``block(i)``, and ``conv2`` (WIDTH -> OUT, batch norm ``head_bn``)."""

    def __init__(self, layers: int, block, dtype: torch.dtype | None, head_bn: str | None = "pre"):
        super().__init__()
        self.layers = layers
        self.conv1 = GraphConv1x1(3, WIDTH, None, dtype=dtype)
        for i in range(layers):
            self.add_module(f"rn{i}", block(i)(WIDTH, dtype=dtype))
        self.conv2 = GraphConv1x1(WIDTH, OUT, head_bn, dtype=dtype)


class Model(_Trunk):
    """Lap trunk: Lap blocks on even layers, Avg blocks on odd ones, an ELU
    and a batch-normed 1x1 head to OUT channels, plus the coordinate
    residual.  ``remat`` recomputes each block's activations in the
    backward (``checkpoint(..., use_reentrant=False)``): the same values and
    gradients, the activations of one block at a time."""

    def __init__(self, layers: int = 15, dtype: torch.dtype | None = None, remat: bool = False):
        super().__init__(layers, lambda i: LapResNet2 if i % 2 == 0 else AvgResNet2, dtype)
        self.remat = remat

    def forward(self, op, mask, inputs):
        x = self.conv1(inputs)
        for i in range(self.layers):
            block = getattr(self, f"rn{i}")
            x = checkpoint(block, op, mask, x, use_reentrant=False) if self.remat else block(op, mask, x)
        x = self.conv2(F.elu(x))
        return _head(x, inputs)


class AmplifyModel(_Trunk):
    """Squared-Laplacian pyramid trunk: ``ops`` is one operator per level;
    even layer ``i`` is a Lap block on ``ops[min(i // 2, len(ops) - 1)]``
    (the last level repeated past the end), odd layers Avg blocks."""

    def __init__(self, layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__(layers, lambda i: LapResNet2 if i % 2 == 0 else AvgResNet2, dtype)

    def forward(self, ops, mask, inputs):
        x = self.conv1(inputs)
        for i in range(self.layers):
            x = getattr(self, f"rn{i}")(ops[min(i // 2, len(ops) - 1)], mask, x)
        x = self.conv2(F.elu(x))
        return _head(x, inputs)


class AvgModel(_Trunk):
    """Avg blocks only: no operator read."""

    def __init__(self, layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__(layers, lambda i: AvgResNet2, dtype)

    def forward(self, op, mask, inputs):
        x = self.conv1(inputs)
        for i in range(self.layers):
            x = getattr(self, f"rn{i}")(op, mask, x)
        return _head(self.conv2(F.elu(x)), inputs)


class MlpModel(_Trunk):
    """Mlp blocks only, then a batch norm ``bn`` (over every row), an ELU
    and a head without batch norm: no operator read."""

    def __init__(self, layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__(layers, lambda i: MlpResNet2, dtype, head_bn=None)
        self.bn = GraphBatchNorm(WIDTH)

    def forward(self, op, mask, inputs):
        x = self.conv1(inputs)
        for i in range(self.layers):
            x = getattr(self, f"rn{i}")(op, mask, x)
        return _head(self.conv2(F.elu(self.bn(x))), inputs)


class DirModel(_Trunk):
    """Dirac trunk: Dirac blocks on even layers over the vertex stream and a
    face stream that starts at zero (``dirac_num_faces(op)`` rows), Avg
    blocks on the vertex stream on odd ones."""

    def __init__(self, layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__(layers, lambda i: DirResNet2 if i % 2 == 0 else AvgResNet2, dtype)

    def forward(self, op, mask, inputs):
        v = self.conv1(inputs)
        f = v.new_zeros(inputs.shape[0], dirac_num_faces(op), WIDTH)
        for i in range(self.layers):
            if i % 2 == 0:
                v, f = getattr(self, f"rn{i}")(op, v, f)
            else:
                v = getattr(self, f"rn{i}")(None, mask, v)
        return _head(self.conv2(F.elu(v)), inputs)


TRUNKS = {
    "lap": Model,
    "amp": AmplifyModel,
    "avg": AvgModel,
    "mlp": MlpModel,
    "dir": DirModel,
}


class SiameseModel(nn.Module):
    """Shared trunk over both shapes; logits ``FA @ FB^T``.  The trunk is
    the first key of ``TRUNKS`` that occurs in ``model`` (as in the JAX
    package); ``remat`` applies to the lap trunk only."""

    def __init__(self, model: str = "lap", layers: int = 15, dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        key = next((k for k in TRUNKS if k in model), None)
        if key is None:
            raise ValueError(f"unknown trunk {model!r}")
        self.dtype = dtype
        self.trunk = Model(layers, dtype, remat) if key == "lap" else TRUNKS[key](layers, dtype)

    def features(self, operation_a, operation_b, input_a, input_b):
        """Both trunks' 120-d embeddings, without the ``N x N`` logits
        (``operation_*`` is ``(operator, mask)``), in ``dtype`` where it is
        set."""
        fa, fb = self.trunk(*operation_a, input_a), self.trunk(*operation_b, input_b)
        if self.dtype is not None:
            fa, fb = fa.to(self.dtype), fb.to(self.dtype)
        return fa, fb

    def forward(self, operation_a, operation_b, input_a, input_b):
        """The logits ``FA @ FB^T``, summed in fp32 (at least)."""
        fa, fb = self.features(operation_a, operation_b, input_a, input_b)
        return torch.einsum("bnc,bmc->bnm", at_least_fp32(fa), at_least_fp32(fb))
