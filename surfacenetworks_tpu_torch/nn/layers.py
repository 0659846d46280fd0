"""Core layers (counterpart of ``surfacenetworks_tpu/nn/layers.py``).

* ``GraphConv1x1``: per-vertex Linear on ``[B, N, C]`` with optional batch
  norm before ('pre') or after ('post') it; any other string means no norm.
* ``GraphBatchNorm``: batch norm over all ``B*N`` rows per channel, always
  with batch statistics (the reference keeps BN in training mode when it
  evaluates), taken in fp32, or in fp64 for fp64 inputs.  By default padding rows take part in the statistics, as in the
  reference; ``masked=True`` weights rows by the mask instead.
* ``global_average``: masked mean over the vertex axis, keepdim.

Parameter names follow the JAX package's flax names (``fc``, ``bn``) so that
``convert.params_from_flax`` maps a flax tree onto ``state_dict`` keys.
"""

from __future__ import annotations

import torch
from torch import nn


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """Statistics in fp32, or in fp64 for an fp64 reference run."""
    return torch.promote_types(x.dtype, torch.float32)


def global_average(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the vertex axis, keepdim. ``x [B,N,C]``, ``mask [B,N,1]``."""
    xf = x.to(_stat_dtype(x))
    mf = mask.to(xf.dtype)
    num = (xf * mf).sum(dim=-2, keepdim=True)
    den = (mf * torch.ones_like(xf)).sum(dim=-2, keepdim=True)
    return (num / den).to(x.dtype)


class GraphBatchNorm(nn.Module):
    """Batch normalization over all (batch, vertex) rows per channel, with
    biased variance and eps 1e-5; statistics in fp32 (fp64 for fp64 x)."""

    def __init__(self, features: int, eps: float = 1e-5, masked: bool = False):
        super().__init__()
        self.eps = eps
        self.masked = masked
        self.weight = nn.Parameter(torch.ones(features))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        out_dtype = x.dtype
        x = x.to(_stat_dtype(x))
        dims = tuple(range(x.dim() - 1))
        if self.masked and mask is not None:
            w = mask.to(x.dtype) * torch.ones_like(x)
            denom = w.sum(dim=dims).clamp_min(1.0)
            mean = (x * w).sum(dim=dims) / denom
            var = (w * (x - mean) ** 2).sum(dim=dims) / denom
        else:
            mean = x.mean(dim=dims)
            var = ((x - mean) ** 2).mean(dim=dims)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return (y * self.weight + self.bias).to(out_dtype)


class GraphConv1x1(nn.Module):
    """Per-vertex Linear with optional pre/post batch norm.

    ``batch_norm`` accepts None/''/'pre'/'post'; any other string (such as
    the reference's 'grouppre') applies no normalization, as in the
    reference.
    """

    def __init__(self, num_inputs: int, num_outputs: int, batch_norm: str | None = None,
                 masked_bn: bool = False):
        super().__init__()
        self.batch_norm = batch_norm
        self.fc = nn.Linear(num_inputs, num_outputs)
        if batch_norm == "pre":
            self.bn = GraphBatchNorm(num_inputs, masked=masked_bn)
        elif batch_norm == "post":
            self.bn = GraphBatchNorm(num_outputs, masked=masked_bn)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.batch_norm == "pre":
            x = self.bn(x, mask)
        x = self.fc(x)
        if self.batch_norm == "post":
            x = self.bn(x, mask)
        return x


def repeating_expand(inputs: torch.Tensor, out_features: int) -> torch.Tensor:
    """Tile the channel axis up to ``out_features`` (with a truncated tail)."""
    in_features = inputs.shape[-1]
    times = out_features // in_features
    rem = out_features % in_features
    parts = [inputs] * times + ([inputs[..., :rem]] if rem else [])
    return torch.cat(parts, dim=-1)
