"""Multiresolution models (counterpart of ``surfacenetworks_tpu/models/cascade.py``):
the ``EfficientCascade`` U-Net, ``GlobalLocalModel`` and ``LapMATModel``.

The cascade consumes a Laplacian pyramid ``laps[0..k-1]`` (coarsest first,
``geometry.coarsening``; ``data.cascade_batch`` packs one ELL operator per
level) over a vertex order in which each coarse vertex's two children sit
at fine positions ``2c, 2c+1``.  The down path is a width-changing
LapResNet and a max-pool over pairs of rows; the up path a 2x
nearest-neighbour upsample, the skip add and a LapResNet; the head the
repeating-expand input residual.  Submodule names are the flax names, so
``convert.params_from_flax`` maps a flax tree onto ``state_dict`` keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surfacenetworks_tpu_torch.models.normal_models import LapDeepModel
from surfacenetworks_tpu_torch.nn.blocks import AvgResNet2, WideLapResNet2, apply_operator
from surfacenetworks_tpu_torch.nn.layers import GraphConv1x1, repeating_expand

WIDTH = 128


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool1d(2) over the vertex axis of ``[B, N, C]``.  ``amax`` splits
    the gradient evenly between equal values, as ``jnp.max`` does: the
    pairs of fake slots at a bucket's tail compute equal rows."""
    b, n, c = x.shape
    return torch.amax(x.reshape(b, n // 2, 2, c), dim=2)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling over the vertex axis: each row
    twice in place (``jnp.repeat``), not the whole tensor tiled."""
    return x.repeat_interleave(2, dim=1)


class LaplacianPooling(nn.Module):
    """Learned pooling: a one-inner-layer width-changing LapResNet (``lap``)
    to half (down) or double (up) the channels, reshaped to half or double
    the vertex count at ``num_inputs`` channels."""

    def __init__(self, num_inputs: int, down: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.num_inputs = num_inputs
        num_outputs = num_inputs // 2 if down else num_inputs * 2
        self.lap = WideLapResNet2(num_inputs, num_outputs, "", inner_layers=1, dtype=dtype)

    def forward(self, op, x: torch.Tensor) -> torch.Tensor:
        y = self.lap(op, None, x)
        return y.reshape(x.shape[0], -1, self.num_inputs)


class EfficientCascade(nn.Module):
    """The multiresolution U-Net over ``cascade_levels`` pyramid levels:
    ``forward(laps, mask, inputs)`` with ``laps`` the per-level operators
    (coarsest first) and ``mask``, ``inputs`` at the finest level.  Widths
    are 128 at every level, or 16/32/64/128 (coarsest to finest) with
    ``bottleneck``; ``with_avg`` adds an Avg block after each down block;
    ``naive_pool=False`` pools and unpools with ``LaplacianPooling``;
    ``bnmode`` is the blocks' batch-norm mode (None: none); ``dtype`` the
    computation dtype."""

    def __init__(self, in_features: int = 3, out_features: int = 3, cascade_levels: int = 4,
                 inner_layers: int = 2, bnmode: str | None = "", with_avg: bool = False, naive_pool: bool = True,
                 bottleneck: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        k = self.cascade_levels = cascade_levels
        self.with_avg, self.naive_pool = with_avg, naive_pool
        widths = [16, 32, 64, 128] if bottleneck else [WIDTH] * k
        self.conv1 = GraphConv1x1(in_features, WIDTH, None, dtype=dtype)
        for i in range(k - 1, 0, -1):
            self.add_module(f"down_rn{i}", WideLapResNet2(widths[i], widths[i - 1], bnmode, inner_layers, dtype=dtype))
            if with_avg:
                self.add_module(f"down_avg{i}", AvgResNet2(widths[i - 1], bnmode, dtype=dtype))
            if not naive_pool:
                self.add_module(f"down_pool{i}", LaplacianPooling(widths[i - 1], down=True, dtype=dtype))
        self.lap0 = WideLapResNet2(widths[0], widths[0], bnmode, inner_layers, dtype=dtype)
        for i in range(1, k):
            if not naive_pool:
                self.add_module(f"up_pool{i}", LaplacianPooling(widths[i], down=False, dtype=dtype))
            self.add_module(f"up_rn{i}", WideLapResNet2(widths[i - 1], widths[i], bnmode, inner_layers, dtype=dtype))
        self.conv2 = GraphConv1x1(WIDTH, out_features, None if bnmode is None else bnmode + "pre", dtype=dtype)

    def forward(self, laps, mask, inputs):
        k = self.cascade_levels
        x = self.conv1(inputs)
        down_series, mask_series = [], []
        ma = mask
        for i in range(k - 1, 0, -1):
            down_series.append(x)
            mask_series.append(ma)
            x = getattr(self, f"down_rn{i}")(laps[i], ma, x)
            if self.with_avg:
                x = getattr(self, f"down_avg{i}")(laps[i], ma, x)
            x = max_pool2(x) if self.naive_pool else getattr(self, f"down_pool{i}")(laps[i], x)
            ma = max_pool2(ma)
        x = self.lap0(laps[0], None, x)
        for i in range(1, k):
            x = upsample2(x) if self.naive_pool else getattr(self, f"up_pool{i}")(laps[i - 1], x)
            x = x + down_series[-i][..., : x.shape[-1]]
            x = getattr(self, f"up_rn{i}")(laps[i], mask_series[-i], x)
        x = self.conv2(F.elu(x))
        return x + repeating_expand(inputs, x.shape[-1])


class GlobalLocalModel(nn.Module):
    """Two branches, a cascade (``global_net``, one extra output channel: the
    gate) and a LapDeepModel (``local_net``), blended by the sigmoid gate.
    ``forward((laps, l_local), (mask_global, mask_local), inputs)`` returns
    the global, local and final scores concatenated on the vertex axis,
    ``[B, 3N, out_features]``."""

    def __init__(self, in_features: int = 3, out_features: int = 1, cascade_levels: int = 4, local_layers: int = 15):
        super().__init__()
        self.out_features = out_features
        self.global_net = EfficientCascade(in_features, out_features + 1, cascade_levels)
        self.local_net = LapDeepModel(in_features, out_features, local_layers)

    def forward(self, operators, masks, inputs, sigmoid: bool = False):
        laps, l_local = operators
        mask_global, mask_local = masks
        swg = self.global_net(laps, mask_global, inputs)
        score_local = self.local_net(l_local, mask_local, inputs)
        score_global = swg[..., : self.out_features]
        weight_global = torch.sigmoid(swg[..., -1:])
        if sigmoid:
            score_global = torch.sigmoid(score_global)
            score_local = torch.sigmoid(score_local)
        score_final = weight_global * score_global + (1 - weight_global) * score_local
        return torch.cat([score_global, score_local, score_final], dim=1)


class LapMATModel(nn.Module):
    """A LapDeepModel (``LapModel``) with medial-axis-transform double
    supervision: ``forward((op, mass), mask, inputs)`` returns the model's
    outputs and ``sqrt(max(mass, 0)) * L elu(outputs)`` clipped to +-4,
    concatenated on the channel axis."""

    def __init__(self, in_features: int = 3, out_features: int = 2, layers: int = 15):
        super().__init__()
        self.LapModel = LapDeepModel(in_features, out_features // 2, layers)

    def forward(self, op_and_mass, mask, inputs):
        op, mass = op_and_mass
        outputs = self.LapModel(op, mask, inputs)
        x = apply_operator(op, F.elu(outputs))
        x = torch.sqrt(torch.clamp_min(mass, 0.0)) * x
        return torch.cat([outputs, torch.clamp(x, -4.0, 4.0)], dim=-1)
