"""Residual Laplacian and average blocks (counterpart of
``surfacenetworks_tpu/nn/blocks.py``).

Every block keeps the signature ``block(op, mask, x)``:

* ``LapResNet2``: x -> ELU -> [x || L x] -> conv(2d -> d, 'pre') twice, + input.
* ``AvgResNet2``: the operator replaced by the masked global average.
* ``WideLapResNet2`` / ``WideAvgResNet2``: width-changing versions with
  ``inner_layers`` steps and the truncating or doubling residual.

``op`` is an ``EllOperator``, a ``BsrOperator``, a dense ``[B, N, N]``
tensor, or any callable ``x -> L x`` (dispatch in ``apply_operator``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from surfacenetworks_tpu_torch.nn.layers import GraphConv1x1, global_average
from surfacenetworks_tpu_torch.sparse.bsr import BsrOperator
from surfacenetworks_tpu_torch.sparse.ell import EllOperator
from surfacenetworks_tpu_torch.sparse.ops import bsr_spmm, dense_bmm, spmm


def apply_operator(op: Any, x: torch.Tensor) -> torch.Tensor:
    """``L @ x`` over the supported operator representations."""
    if isinstance(op, EllOperator):
        return spmm(op, x)
    if isinstance(op, BsrOperator):
        return bsr_spmm(op, x)
    if isinstance(op, torch.Tensor):
        return dense_bmm(op, x)
    if callable(op):
        return op(x)
    raise TypeError(f"unsupported operator {type(op).__name__}")


def _cat_op(x: torch.Tensor, ox: torch.Tensor) -> torch.Tensor:
    """Concat [x || Op x] in the wider of the two dtypes."""
    dt = torch.promote_types(x.dtype, ox.dtype)
    return torch.cat([x.to(dt), ox.to(dt)], dim=-1)


def _bn_mode(bnmode: str | None) -> str | None:
    """Reference convention: bnmode '' -> 'pre'; None -> no norm; other strings
    pass through (and unknown strings disable norm inside GraphConv1x1)."""
    if bnmode is None:
        return None
    return bnmode + "pre"


def _cat_avg(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, global_average(x, mask).expand_as(x)], dim=-1)


class LapResNet2(nn.Module):
    """Two-step Laplacian residual block."""

    def __init__(self, features: int, bnmode: str | None = ""):
        super().__init__()
        self.bn_fc0 = GraphConv1x1(2 * features, features, _bn_mode(bnmode))
        self.bn_fc1 = GraphConv1x1(2 * features, features, _bn_mode(bnmode))

    def forward(self, op, mask, inputs):
        x = F.elu(inputs)
        x = self.bn_fc0(_cat_op(x, apply_operator(op, x)))
        x = F.elu(x)
        x = self.bn_fc1(_cat_op(x, apply_operator(op, x)))
        return x + inputs


class AvgResNet2(nn.Module):
    """Global-average residual block."""

    def __init__(self, features: int, bnmode: str | None = ""):
        super().__init__()
        self.bn_fc0 = GraphConv1x1(2 * features, features, _bn_mode(bnmode))
        self.bn_fc1 = GraphConv1x1(2 * features, features, _bn_mode(bnmode))

    def forward(self, op, mask, inputs):
        x = F.elu(inputs)
        x = self.bn_fc0(_cat_avg(x, mask))
        x = F.elu(x)
        x = self.bn_fc1(_cat_avg(x, mask))
        return x + inputs


class _WideBlock(nn.Module):
    """Shared body of the width-changing blocks: ``inner_layers`` steps of
    ELU -> [x || neighbourhood(x)] -> conv, then the truncating (narrower or
    equal output) or doubling (wider output) input residual."""

    def __init__(self, num_inputs: int, num_outputs: int | None = None, bnmode: str | None = "",
                 inner_layers: int = 2):
        super().__init__()
        num_outputs = num_inputs if num_outputs is None else num_outputs
        self.num_outputs = num_outputs
        self.inner_layers = inner_layers
        widths_in = [num_inputs] + [num_outputs] * (inner_layers - 1)
        for i in range(inner_layers):
            self.add_module(f"bn_fc{i}", GraphConv1x1(2 * widths_in[i], num_outputs, _bn_mode(bnmode)))

    def _neighbourhood(self, op, mask, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, op, mask, inputs):
        x = inputs
        for i in range(self.inner_layers):
            x = F.elu(x)
            x = getattr(self, f"bn_fc{i}")(self._neighbourhood(op, mask, x))
        if self.num_outputs <= inputs.shape[-1]:
            return x + inputs[..., : self.num_outputs]
        return x + torch.cat([inputs, inputs], dim=-1)


class WideLapResNet2(_WideBlock):
    """Width-changing Laplacian block."""

    def _neighbourhood(self, op, mask, x):
        return _cat_op(x, apply_operator(op, x))


class WideAvgResNet2(_WideBlock):
    """Width-changing global-average block."""

    def _neighbourhood(self, op, mask, x):
        return _cat_avg(x, mask)
