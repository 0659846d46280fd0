"""FAUST dense-correspondence models (counterpart of
``surfacenetworks_tpu/models/correspondence.py``, Lap trunk).

A shared trunk embeds each shape to 120-d per-vertex features; the siamese
head forms correspondence logits ``FA @ FB^T [B, NA, NB]``, or hands the two
feature sets to the streaming loss without forming them.  Submodule names
follow the JAX package's flax names (``trunk``, ``conv1``, ``rn{i}``,
``conv2``), so ``convert.params_from_flax`` maps a flax ``SiameseModel``
tree onto ``state_dict``.  ``dtype`` is the trunk's computation dtype: with
bf16 the features are cast to bf16 (the trunk's head is fp32 through the
coordinate residual), as the JAX model's are, and the logits are fp32.  The
amp, avg, mlp and dir trunks and ``remat`` are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surfacenetworks_tpu_torch.nn.blocks import AvgResNet2, LapResNet2
from surfacenetworks_tpu_torch.nn.layers import GraphConv1x1, at_least_fp32

WIDTH = 128
OUT = 120


def _head(x: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """The coordinate residual: the last three input channels tiled to OUT."""
    return x + inputs[..., -3:].repeat(1, 1, OUT // 3)


class Model(nn.Module):
    """Lap trunk: Lap blocks on even layers, Avg blocks on odd ones, an
    ELU and a batch-normed 1x1 head to OUT channels, plus the coordinate
    residual."""

    def __init__(self, layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__()
        self.layers = layers
        self.conv1 = GraphConv1x1(3, WIDTH, None, dtype=dtype)
        for i in range(layers):
            cls = LapResNet2 if i % 2 == 0 else AvgResNet2
            self.add_module(f"rn{i}", cls(WIDTH, dtype=dtype))
        self.conv2 = GraphConv1x1(WIDTH, OUT, "pre", dtype=dtype)

    def forward(self, op, mask, inputs):
        x = self.conv1(inputs)
        for i in range(self.layers):
            x = getattr(self, f"rn{i}")(op, mask, x)
        x = self.conv2(F.elu(x))
        return _head(x, inputs)


class SiameseModel(nn.Module):
    """Shared trunk over both shapes; logits ``FA @ FB^T``."""

    def __init__(self, model: str = "lap", layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__()
        if model != "lap":
            raise NotImplementedError(f"trunk {model!r}: only 'lap' is ported")
        self.dtype = dtype
        self.trunk = Model(layers, dtype)

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
