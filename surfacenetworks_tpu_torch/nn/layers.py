"""Core layers (counterpart of ``surfacenetworks_tpu/nn/layers.py``).

* ``GraphConv1x1``: per-vertex Linear on ``[B, N, C]`` with optional batch
  norm before ('pre') or after ('post') it; any other string means no norm.
* ``GraphBatchNorm``: batch norm over all ``B*N`` rows per channel, always
  with batch statistics (the reference keeps BN in training mode when it
  evaluates), taken in fp32, or in fp64 for fp64 inputs.  By default padding rows take part in the statistics, as in the
  reference; ``masked=True`` weights rows by the mask instead.
* ``global_average``: masked mean over the vertex axis, keepdim.

Inside a sharded context (``parallel_context.sharded_axes``: a rank holds a
slice of the vertex rows, of the mesh batch, or both) the global average
sums its masked sums over the vertex axis, and batch norm takes its
statistics over the global (batch x vertex) rows in two passes (count and
sum, then the squared deviations), each summed over the context's axes, as
the JAX package's graph-parallel body does; both sums are differentiable
(``parallel_context.psum``).

Parameter names follow the JAX package's flax names (``fc``, ``bn``) so that
``convert.params_from_flax`` maps a flax tree onto ``state_dict`` keys.

Mixed precision follows flax's ``dtype`` convention, threaded explicitly
(not ``torch.autocast``, whose per-op rules differ): ``GraphConv1x1(dtype=
torch.bfloat16)`` computes its Linear in bf16 from fp32 parameters, as
``nn.Dense(dtype=bf16)`` does; batch-norm statistics and global averages run
in fp32 and cast back to the input's dtype; a 'pre' batch norm reads its
input at the precision it arrives in.  ``dtype=None`` is the fp32 model.
"""

from __future__ import annotations

import torch
from torch import nn

from surfacenetworks_tpu_torch import parallel_context


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """Statistics in fp32, or in fp64 for an fp64 reference run."""
    return torch.promote_types(x.dtype, torch.float32)


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or in its own dtype where that is wider (fp64 runs):
    where the mixed-precision models and the losses leave bf16."""
    return x.to(_stat_dtype(x))


def global_average(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the vertex axis, keepdim. ``x [B,N,C]``, ``mask [B,N,1]``."""
    xf = x.to(_stat_dtype(x))
    mf = mask.to(xf.dtype)
    num = (xf * mf).sum(dim=-2, keepdim=True)
    den = (mf * torch.ones_like(xf)).sum(dim=-2, keepdim=True)
    axis = parallel_context.vertex_reduction_axis()
    if axis is not None:
        num, den = parallel_context.psum(torch.stack([num, den]), [axis]).unbind(0)
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
        axes = parallel_context.reduction_axes_for_stats()
        if axes:
            # statistics over the GLOBAL rows: count and sum, then the
            # squared deviations (the single-pass E[x^2] - E[x]^2 loses
            # too much fp32 precision)
            w = mask.to(x.dtype) * torch.ones_like(x) if self.masked and mask is not None else torch.ones_like(x)
            cnt, s1 = parallel_context.psum(torch.stack([w.sum(dim=dims), (x * w).sum(dim=dims)]), axes).unbind(0)
            denom = cnt.clamp_min(1.0)
            mean = s1 / denom
            var = parallel_context.psum((w * (x - mean) ** 2).sum(dim=dims), axes) / denom
        elif self.masked and mask is not None:
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
    reference.  ``dtype`` is the computation dtype (the parameters stay
    fp32): with ``torch.bfloat16`` the input and the weight are cast to
    bf16, multiplied with fp32 accumulation into a bf16 product, and the
    bias is added in bf16, two roundings as in flax's ``nn.Dense`` (a fused
    ``F.linear`` bias would round once).
    """

    def __init__(self, num_inputs: int, num_outputs: int, batch_norm: str | None = None,
                 masked_bn: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.batch_norm = batch_norm
        self.dtype = dtype
        self.fc = nn.Linear(num_inputs, num_outputs)
        if batch_norm == "pre":
            self.bn = GraphBatchNorm(num_inputs, masked=masked_bn)
        elif batch_norm == "post":
            self.bn = GraphBatchNorm(num_outputs, masked=masked_bn)

    def _linear(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return self.fc(x)
        dt = self.dtype
        return torch.matmul(x.to(dt), self.fc.weight.to(dt).t()) + self.fc.bias.to(dt)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.batch_norm == "pre":
            x = self.bn(x, mask)
        x = self._linear(x)
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
