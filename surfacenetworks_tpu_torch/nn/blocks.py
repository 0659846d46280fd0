"""Residual Laplacian, average and Dirac blocks (counterpart of
``surfacenetworks_tpu/nn/blocks.py``).

Every block keeps the signature ``block(op, mask, x)`` (Dirac:
``block(dirac_op, v, f)``):

* ``LapResNet2``: x -> ELU -> [x || L x] -> conv(2d -> d, 'pre') twice, + input.
* ``AvgResNet2``: the operator replaced by the masked global average.
* ``MlpResNet2``: no operator; batch norm, ELU and conv per vertex, twice.
* ``WideLapResNet2`` / ``WideAvgResNet2``: width-changing versions with
  ``inner_layers`` steps and the truncating or doubling residual.
* ``DirResNet2``: vertex and face streams coupled through the Dirac pair in
  quaternion layout; the face stream has no residual.

``op`` is an ``EllOperator``, a ``BsrOperator``, a dense ``[B, N, N]``
tensor, or any callable ``x -> L x`` (dispatch in ``apply_operator``).  A
Dirac operator is a structured ``DiracOperator`` or a dense pair ``(Di [B,
4M, 4N], DiA [B, 4N, 4M])`` (dispatch in ``apply_dirac_vf`` /
``apply_dirac_fv``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from surfacenetworks_tpu_torch.nn.layers import GraphBatchNorm, GraphConv1x1, global_average
from surfacenetworks_tpu_torch.sparse.bsr import BsrOperator
from surfacenetworks_tpu_torch.sparse.ell import DiracOperator, EllOperator
from surfacenetworks_tpu_torch.sparse.ops import bsr_spmm, dense_bmm, dirac_apply_fv, dirac_apply_vf, spmm


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


def _dense_pair(op: Any) -> tuple[torch.Tensor, torch.Tensor]:
    if isinstance(op, tuple) and len(op) == 2 and all(isinstance(t, torch.Tensor) for t in op):
        return op
    raise TypeError(f"unsupported Dirac operator {type(op).__name__}: a DiracOperator or a dense (Di, DiA) pair")


def _dense_dirac(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A dense Dirac matrix ``[B, 4R, 4S]`` on ``x [B, S, C]`` in quaternion
    layout: ``x`` viewed ``[B, 4S, C/4]``; the matrix is widened for fp64
    ``x``."""
    *lead, n, c = x.shape
    out = dense_bmm(d.to(x.dtype), x.reshape(*lead, n * 4, c // 4))
    return out.reshape(*lead, out.shape[-2] // 4, c)


def apply_dirac_vf(op: Any, v: torch.Tensor) -> torch.Tensor:
    """``Di @ v`` (vertices -> faces) for a structured or a dense operator."""
    if isinstance(op, DiracOperator):
        return dirac_apply_vf(op, v)
    return _dense_dirac(_dense_pair(op)[0], v)


def apply_dirac_fv(op: Any, f: torch.Tensor) -> torch.Tensor:
    """``DiA @ f`` (faces -> vertices)."""
    if isinstance(op, DiracOperator):
        return dirac_apply_fv(op, f)
    return _dense_dirac(_dense_pair(op)[1], f)


def dirac_num_faces(op: Any) -> int:
    """Face count of a structured or a dense Dirac operator."""
    if isinstance(op, DiracOperator):
        return op.n_faces
    return _dense_pair(op)[0].shape[-2] // 4


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


class MlpResNet2(nn.Module):
    """Pointwise residual block: two steps of batch norm (over every row,
    padding included) -> ELU -> conv, + input; no operator."""

    def __init__(self, features: int):
        super().__init__()
        self.bn0 = GraphBatchNorm(features)
        self.fc0 = GraphConv1x1(features, features, None)
        self.bn1 = GraphBatchNorm(features)
        self.fc1 = GraphConv1x1(features, features, None)

    def forward(self, op, mask, inputs):
        x = self.fc0(F.elu(self.bn0(inputs)))
        x = self.fc1(F.elu(self.bn1(x)))
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


class DirResNet2(nn.Module):
    """Dirac residual block over coupled vertex and face streams:
    ``forward(op, v, f) -> (v + v', f')`` (channels divisible by 4).  The
    face stream's batch norm takes every ``B*M`` face row, padded faces
    included, as the JAX package's does."""

    def __init__(self, features: int):
        super().__init__()
        self.bn_fc0 = GraphConv1x1(2 * features, features, "pre")
        self.bn_fc1 = GraphConv1x1(2 * features, features, "pre")

    def forward(self, op, v, f):
        x_in, f_in = F.elu(v), F.elu(f)
        f_out = self.bn_fc0(_cat_op(f_in, apply_dirac_vf(op, x_in)))
        v_out = self.bn_fc1(_cat_op(x_in, apply_dirac_fv(op, F.elu(f_out))))
        return v + v_out, f_out
