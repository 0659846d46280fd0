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
from torch.utils.checkpoint import checkpoint

from surfacenetworks_tpu_torch.nn.blocks import (
    AvgResNet2,
    DirResNet2,
    GatResNet2,
    IdResNet2,
    MlpResNet2,
    WideAvgResNet2,
    WideLapResNet2,
    dirac_num_faces,
)
from surfacenetworks_tpu_torch.nn.layers import GraphBatchNorm, GraphConv1x1, repeating_expand

WIDTH = 128


def _conv2_bn(bnmode: str | None) -> str | None:
    return None if bnmode is None else bnmode + "pre"


class LapDeepModel(nn.Module):
    """Deep Laplacian network: width-changing Lap blocks on even layers (all
    layers with ``only_lap``), Avg blocks on odd ones, an optional bottleneck
    width schedule, an ELU + 1x1 head and the repeating-expand input
    residual.  ``dtype`` is the computation dtype (bf16: mixed precision);
    the output is fp32 whatever it is, through the fp32 input residual.
    ``remat`` runs each block under ``torch.utils.checkpoint`` (the JAX
    model's ``nn.remat``): its activations are recomputed in the backward
    instead of stored, for the same outputs and gradients (the blocks'
    batch norms read batch statistics and draw nothing at random)."""

    def __init__(self, in_features: int, out_features: int, layers: int = 15,
                 bnmode: str | None = "", only_lap: bool = False, bottleneck: bool = False,
                 remat: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.remat = remat
        if bottleneck:
            if layers != 16:
                raise ValueError(f"bottleneck needs layers=16, got {layers}")
            widths = [128, 128, 64, 64, 32, 32, 16, 16, 16, 16, 32, 32, 64, 64, 128, 128, 128]
        else:
            widths = [WIDTH] * (layers + 1)
        self.layers = layers
        self.conv1 = GraphConv1x1(in_features, WIDTH, "", dtype=dtype)
        for i in range(layers):
            cls = WideLapResNet2 if i % 2 == 0 or only_lap else WideAvgResNet2
            self.add_module(f"rn{i}", cls(widths[i], widths[i + 1], bnmode, dtype=dtype))
        self.conv2 = GraphConv1x1(WIDTH, out_features, _conv2_bn(bnmode), dtype=dtype)

    def forward(self, op, mask, inputs):
        x = self.conv1(inputs)
        for i in range(self.layers):
            block = getattr(self, f"rn{i}")
            x = checkpoint(block, op, mask, x, use_reentrant=False) if self.remat else block(op, mask, x)
        x = self.conv2(F.elu(x))
        return x + repeating_expand(inputs, x.shape[-1])


class DirTrunk(nn.Module):
    """Dirac blocks on even layers over coupled vertex and face streams (the
    face stream starts at zero, in the vertex stream's dtype), Avg blocks on
    odd ones; ``dtype`` is the computation dtype."""

    def __init__(self, in_features: int, layers: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.layers = layers
        self.conv1 = GraphConv1x1(in_features, WIDTH, None, dtype=dtype)
        for i in range(layers):
            self.add_module(f"rn{i}", DirResNet2(WIDTH, dtype=dtype) if i % 2 == 0 else AvgResNet2(WIDTH, dtype=dtype))

    def trunk(self, op, mask, inputs) -> tuple[torch.Tensor, torch.Tensor]:
        v = self.conv1(inputs)
        f = v.new_zeros(inputs.shape[0], dirac_num_faces(op), WIDTH)
        for i in range(self.layers):
            if i % 2 == 0:
                v, f = getattr(self, f"rn{i}")(op, v, f)
            else:
                v = getattr(self, f"rn{i}")(None, mask, v)
        return v, f


class DirDeepModel(DirTrunk):
    """Deep Dirac network: the Dirac trunk, then conv2 ('pre') and an ELU;
    no input residual.  ``op`` is a ``DiracOperator`` or a dense (Di, DiA)
    pair."""

    def __init__(self, in_features: int, out_features: int, layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__(in_features, layers, dtype)
        self.conv2 = GraphConv1x1(WIDTH, out_features, "pre", dtype=dtype)

    def forward(self, op, mask, inputs):
        v, _ = self.trunk(op, mask, inputs)
        # fp32 output whatever the compute dtype, as in the JAX package
        return F.elu(self.conv2(v).float())


class DirModelToFace(DirTrunk):
    """Dirac network whose output is the face stream: ELU, then conv2
    ('pre'), per face ``[B, M, out_features]``."""

    def __init__(self, in_features: int, out_features: int, layers: int = 16, dtype: torch.dtype | None = None):
        super().__init__(in_features, layers, dtype)
        self.conv2 = GraphConv1x1(WIDTH, out_features, "pre", dtype=dtype)

    def forward(self, op, mask, inputs):
        _, f = self.trunk(op, mask, inputs)
        return self.conv2(F.elu(f)).float()


class GatDeepModel(nn.Module):
    """Deep graph-attention network: ``GatResNet2`` blocks (masked attention
    over the operator's ELL pattern, ``heads`` heads) on even layers, Avg
    blocks on odd ones, an ELU + 'pre' conv head and the repeating-expand
    input residual; the output is fp32 whatever ``dtype`` is."""

    def __init__(self, in_features: int, out_features: int, layers: int = 15, heads: int = 4,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.layers = layers
        self.conv1 = GraphConv1x1(in_features, WIDTH, "", dtype=dtype)
        for i in range(layers):
            self.add_module(f"rn{i}", GatResNet2(WIDTH, heads=heads, dtype=dtype) if i % 2 == 0
                            else AvgResNet2(WIDTH, dtype=dtype))
        self.conv2 = GraphConv1x1(WIDTH, out_features, "pre", dtype=dtype)

    def forward(self, op, mask, inputs):
        x = self.conv1(inputs)
        for i in range(self.layers):
            x = getattr(self, f"rn{i}")(op, mask, x)
        x = self.conv2(F.elu(x))
        return x + repeating_expand(inputs, x.shape[-1])


class _PlainTrunk(nn.Module):
    """``conv1`` (no batch norm), then ``layers`` blocks of one class, none
    of which reads the operator."""

    def __init__(self, block, in_features: int, layers: int, dtype: torch.dtype | None):
        super().__init__()
        self.layers = layers
        self.conv1 = GraphConv1x1(in_features, WIDTH, None, dtype=dtype)
        for i in range(layers):
            self.add_module(f"rn{i}", block(WIDTH, dtype=dtype))

    def trunk(self, op, mask, inputs) -> torch.Tensor:
        x = self.conv1(inputs)
        for i in range(self.layers):
            x = getattr(self, f"rn{i}")(op, mask, x)
        return x


class AvgModel(_PlainTrunk):
    """Graph-agnostic ablation: Avg blocks only, an ELU + 'pre' conv head,
    plus the input (fp32 out)."""

    def __init__(self, in_features: int, out_features: int, layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__(AvgResNet2, in_features, layers, dtype)
        self.conv2 = GraphConv1x1(WIDTH, out_features, "pre", dtype=dtype)

    def forward(self, op, mask, inputs):
        return self.conv2(F.elu(self.trunk(op, mask, inputs))) + inputs


class MlpModel(_PlainTrunk):
    """Pointwise-only ablation: Mlp blocks, a batch norm ``bn`` (over every
    row), ELU and a conv head without batch norm, plus the input (fp32
    out)."""

    def __init__(self, in_features: int, out_features: int, layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__(MlpResNet2, in_features, layers, dtype)
        self.bn = GraphBatchNorm(WIDTH)
        self.conv2 = GraphConv1x1(WIDTH, out_features, None, dtype=dtype)

    def forward(self, op, mask, inputs):
        return self.conv2(F.elu(self.bn(self.trunk(op, mask, inputs)))) + inputs


class IdDeepModel(_PlainTrunk):
    """Identity-op ablation: Id blocks, a 'pre' conv head, then an ELU in
    fp32; no input residual."""

    def __init__(self, in_features: int, out_features: int, layers: int = 15, dtype: torch.dtype | None = None):
        super().__init__(IdResNet2, in_features, layers, dtype)
        self.conv2 = GraphConv1x1(WIDTH, out_features, "pre", dtype=dtype)

    def forward(self, op, mask, inputs):
        return F.elu(self.conv2(self.trunk(op, mask, inputs)).float())


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation in the JAX package's convention: Linear weights
    from a normal with variance 1/fan_in (lecun), zero biases, unit BN
    scales, attention vectors from flax's glorot uniform (limit
    ``sqrt(6 / (H + ch))``).  The numbers differ from flax's for the same
    seed."""
    for m in model.modules():
        if isinstance(m, GatResNet2):
            for name, p in m.named_parameters(recurse=False):
                limit = (6.0 / sum(p.shape)) ** 0.5
                p.copy_((torch.rand(p.shape, generator=generator, dtype=torch.float32) * 2 - 1) * limit)
        elif isinstance(m, nn.Linear):
            fan_in = m.weight.shape[1]
            w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32)
            m.weight.copy_(w / fan_in**0.5)
            m.bias.zero_()
        elif isinstance(m, GraphBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
