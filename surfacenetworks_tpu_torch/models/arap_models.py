"""ARAP temporal-deformation models (counterpart of
``surfacenetworks_tpu/models/arap_models.py``).

The input is 2 frames of coordinates (6 channels), the output 40 predicted
frames (120 channels), and every model ends in the residual ``x + last
input frame tiled 40 times``.  The operator comes from the last input
frame.  Submodule names follow the JAX package's flax names (``conv1``,
``rn{i}``, ``bn``, ``conv2``), so ``convert.params_from_flax`` maps a flax
tree onto ``state_dict``.

* ``Model``: Lap blocks on even layers, Avg blocks on odd ones.
* ``AvgModel``: Avg blocks only.  ``MlpModel``: pointwise blocks, then a
  batch norm.
* ``DirModel``: Dirac blocks on even layers over a vertex stream and a face
  stream that starts at zero, Avg blocks on odd ones.
* ``GCNModel``: ``GCNResNet2`` on even layers, Avg blocks on odd ones.  The
  JAX trainer feeds it the same cotan Laplacian as every other model, and
  so does the port's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from surfacenetworks_tpu_torch.data.batching import IN_FRAMES, OUT_FRAMES
from surfacenetworks_tpu_torch.models.normal_models import DirTrunk
from surfacenetworks_tpu_torch.nn.blocks import AvgResNet2, LapResNet2, MlpResNet2
from surfacenetworks_tpu_torch.nn.layers import GraphBatchNorm, GraphConv1x1

WIDTH = 128


def _residual_head(x: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """``x`` plus the last input frame tiled OUT_FRAMES times."""
    return x + inputs[..., -3:].repeat(1, 1, OUT_FRAMES)


class _BlockStack(nn.Module):
    """conv1 (no norm) -> blocks ``rn{i} = block(i)`` -> [batch norm] ->
    ELU -> conv2 -> the residual head."""

    def __init__(self, layers: int, block: Callable[[int], nn.Module], conv2_bn: str | None = "pre",
                 final_bn: bool = False):
        super().__init__()
        self.layers = layers
        self.conv1 = GraphConv1x1(3 * IN_FRAMES, WIDTH, None)
        for i in range(layers):
            self.add_module(f"rn{i}", block(i))
        self.bn = GraphBatchNorm(WIDTH) if final_bn else None
        self.conv2 = GraphConv1x1(WIDTH, 3 * OUT_FRAMES, conv2_bn)

    def forward(self, op, mask, inputs):
        x = self.conv1(inputs)
        for i in range(self.layers):
            x = getattr(self, f"rn{i}")(op, mask, x)
        if self.bn is not None:
            x = self.bn(x)
        return _residual_head(self.conv2(F.elu(x)), inputs)


# The JAX package's GCN block computes what LapResNet2 computes, with the
# same parameters; the trainer feeds it the cotan L as it feeds every model.
GCNResNet2 = LapResNet2


class Model(_BlockStack):
    """The Lap model."""

    def __init__(self, layers: int = 15):
        super().__init__(layers, lambda i: LapResNet2(WIDTH) if i % 2 == 0 else AvgResNet2(WIDTH))


class AvgModel(_BlockStack):
    def __init__(self, layers: int = 15):
        super().__init__(layers, lambda i: AvgResNet2(WIDTH))


class MlpModel(_BlockStack):
    """Pointwise blocks, a batch norm over every row, ELU, conv2 without a
    norm."""

    def __init__(self, layers: int = 15):
        super().__init__(layers, lambda i: MlpResNet2(WIDTH), conv2_bn=None, final_bn=True)


class GCNModel(_BlockStack):
    def __init__(self, layers: int = 15):
        super().__init__(layers, lambda i: GCNResNet2(WIDTH) if i % 2 == 0 else AvgResNet2(WIDTH))


class DirModel(DirTrunk):
    """The Dirac model: ``op`` is a ``DiracOperator`` or a dense (Di, DiA)
    pair."""

    def __init__(self, layers: int = 15):
        super().__init__(3 * IN_FRAMES, layers)
        self.conv2 = GraphConv1x1(WIDTH, 3 * OUT_FRAMES, "pre")

    def forward(self, op, mask, inputs):
        v, _ = self.trunk(op, mask, inputs)
        return _residual_head(self.conv2(F.elu(v)), inputs)


MODELS = {"lap": Model, "avg": AvgModel, "mlp": MlpModel, "dir": DirModel, "gcn": GCNModel}
