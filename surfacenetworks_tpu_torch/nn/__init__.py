"""Layers and blocks (counterpart of ``surfacenetworks_tpu/nn``)."""

from surfacenetworks_tpu_torch.nn.blocks import (
    AvgResNet2,
    DenseLapResNet2,
    DirResNet2,
    GatResNet2,
    IdResNet2,
    LapResNet2,
    MlpResNet2,
    WideAvgResNet2,
    WideLapResNet2,
    apply_dirac_fv,
    apply_dirac_vf,
    apply_operator,
    dirac_num_faces,
    gat_attend,
)
from surfacenetworks_tpu_torch.nn.layers import (
    GraphBatchNorm,
    GraphConv1x1,
    at_least_fp32,
    global_average,
    repeating_expand,
)

__all__ = [
    "AvgResNet2",
    "DenseLapResNet2",
    "DirResNet2",
    "GatResNet2",
    "GraphBatchNorm",
    "GraphConv1x1",
    "IdResNet2",
    "LapResNet2",
    "MlpResNet2",
    "WideAvgResNet2",
    "WideLapResNet2",
    "apply_dirac_fv",
    "apply_dirac_vf",
    "apply_operator",
    "at_least_fp32",
    "dirac_num_faces",
    "gat_attend",
    "global_average",
    "repeating_expand",
]
