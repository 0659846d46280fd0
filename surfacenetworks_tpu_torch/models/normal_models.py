"""Normal-prediction models (counterpart of ``surfacenetworks_tpu/models/normal_models.py``).

Models map ``(operator, mask, inputs [B,N,Cin]) -> [B,N,Cout]`` on padded
tensors.  Submodule names follow the JAX package's flax names (``conv1``,
``rn0`` ... ``rn{layers-1}``, ``conv2``) so converted weights load with
``load_state_dict``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surfacenetworks_tpu_torch.nn.blocks import WideAvgResNet2, WideLapResNet2
from surfacenetworks_tpu_torch.nn.layers import GraphBatchNorm, GraphConv1x1, repeating_expand

WIDTH = 128


def _conv2_bn(bnmode: str | None) -> str | None:
    return None if bnmode is None else bnmode + "pre"


class LapDeepModel(nn.Module):
    """Deep Laplacian network: width-changing Lap blocks on even layers (all
    layers with ``only_lap``), Avg blocks on odd ones, an optional bottleneck
    width schedule, an ELU + 1x1 head and the repeating-expand input
    residual.  ``remat`` and ``dtype`` of the JAX model come with the
    training and bf16 slices."""

    def __init__(self, in_features: int, out_features: int, layers: int = 15,
                 bnmode: str | None = "", only_lap: bool = False, bottleneck: bool = False):
        super().__init__()
        if bottleneck:
            if layers != 16:
                raise ValueError(f"bottleneck needs layers=16, got {layers}")
            widths = [128, 128, 64, 64, 32, 32, 16, 16, 16, 16, 32, 32, 64, 64, 128, 128, 128]
        else:
            widths = [WIDTH] * (layers + 1)
        self.layers = layers
        self.conv1 = GraphConv1x1(in_features, WIDTH, "")
        for i in range(layers):
            cls = WideLapResNet2 if i % 2 == 0 or only_lap else WideAvgResNet2
            self.add_module(f"rn{i}", cls(widths[i], widths[i + 1], bnmode))
        self.conv2 = GraphConv1x1(WIDTH, out_features, _conv2_bn(bnmode))

    def forward(self, op, mask, inputs):
        x = self.conv1(inputs)
        for i in range(self.layers):
            x = getattr(self, f"rn{i}")(op, mask, x)
        x = self.conv2(F.elu(x))
        return x + repeating_expand(inputs, x.shape[-1])


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation in the JAX package's convention: Linear weights
    from a normal with variance 1/fan_in (lecun), zero biases, unit BN
    scales.  The numbers differ from flax's for the same seed."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            fan_in = m.weight.shape[1]
            w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32)
            m.weight.copy_(w / fan_in**0.5)
            m.bias.zero_()
        elif isinstance(m, GraphBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
