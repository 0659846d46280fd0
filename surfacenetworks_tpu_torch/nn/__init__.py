"""Layers and blocks (counterpart of ``surfacenetworks_tpu/nn``)."""

from surfacenetworks_tpu_torch.nn.blocks import (
    AvgResNet2,
    DirResNet2,
    LapResNet2,
    MlpResNet2,
    WideAvgResNet2,
    WideLapResNet2,
    apply_dirac_fv,
    apply_dirac_vf,
    apply_operator,
    dirac_num_faces,
)
from surfacenetworks_tpu_torch.nn.layers import (
    GraphBatchNorm,
    GraphConv1x1,
    global_average,
    repeating_expand,
)

__all__ = [
    "AvgResNet2",
    "DirResNet2",
    "GraphBatchNorm",
    "GraphConv1x1",
    "LapResNet2",
    "MlpResNet2",
    "WideAvgResNet2",
    "WideLapResNet2",
    "apply_dirac_fv",
    "apply_dirac_vf",
    "apply_operator",
    "dirac_num_faces",
    "global_average",
    "repeating_expand",
]
