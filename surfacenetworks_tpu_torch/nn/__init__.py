"""Layers and blocks (counterpart of ``surfacenetworks_tpu/nn``)."""

from surfacenetworks_tpu_torch.nn.blocks import (
    AvgResNet2,
    LapResNet2,
    WideAvgResNet2,
    WideLapResNet2,
    apply_operator,
)
from surfacenetworks_tpu_torch.nn.layers import (
    GraphBatchNorm,
    GraphConv1x1,
    global_average,
    repeating_expand,
)

__all__ = [
    "AvgResNet2",
    "GraphBatchNorm",
    "GraphConv1x1",
    "LapResNet2",
    "WideAvgResNet2",
    "WideLapResNet2",
    "apply_operator",
    "global_average",
    "repeating_expand",
]
