"""Mesh-MNIST classifiers (counterpart of ``surfacenetworks_tpu/models/mnist_models.py``).

conv1 (3 -> 64, no norm) -> ``layers`` residual blocks at width 64 -> the
head: ELU -> 'pre' conv ``bn_conv2`` -> ELU -> masked global average ->
dropout 0.5 -> ``fc1`` (64 -> 10, at least fp32) -> log-softmax.  Models map
``(op, mask, inputs [B, N, 3])`` to log-probabilities ``[B, 10]``.

Dropout keeps each pooled feature with probability 0.5 and doubles the
kept ones, as flax's ``Dropout(0.5)`` does.  Its keep mask ``[B, 64]``
comes from the caller (``keep``, so a test can hand in the JAX package's
mask) or is drawn from ``generator`` on the model's device
(``dropout_keep``); ``deterministic=True`` turns dropout off.  Submodule
names follow the JAX package's flax names (``conv1``, ``rn{i}``,
``head.bn_conv2``, ``head.fc1``), so ``convert.params_from_flax`` maps a
flax tree onto ``state_dict``.

* ``Model``: Laplacian blocks; ``AvgModel``: global-average blocks;
  ``MlpModel``: pointwise blocks.
* ``DirModel``: Dirac blocks in every layer over a vertex stream and a face
  stream that starts at zero (the normal trainer's ``DirTrunk`` alternates
  Dirac and Avg blocks; this one does not); the vertex stream is pooled.

Every model takes ``dtype``, the computation dtype (bf16: mixed precision);
the pooled features reach ``fc1`` and the log-softmax in fp32 whatever it
is, as in the JAX models.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surfacenetworks_tpu_torch.nn.blocks import AvgResNet2, DirResNet2, LapResNet2, MlpResNet2, dirac_num_faces
from surfacenetworks_tpu_torch.nn.layers import GraphConv1x1, at_least_fp32, global_average

WIDTH = 64
NUM_CLASSES = 10
KEEP_PROB = 0.5


def dropout_keep(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """A keep mask (1 kept, 0 dropped) drawn with probability KEEP_PROB
    from ``generator`` on ``device``."""
    return torch.bernoulli(torch.full(shape, KEEP_PROB, device=device), generator=generator)


class _ClassifierHead(nn.Module):
    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.bn_conv2 = GraphConv1x1(WIDTH, WIDTH, "pre", dtype=dtype)
        self.fc1 = nn.Linear(WIDTH, NUM_CLASSES)

    def forward(self, x, mask, deterministic: bool, keep=None, generator=None):
        x = F.elu(self.bn_conv2(F.elu(x)))
        x = global_average(x, mask).squeeze(-2)
        if not deterministic:
            if keep is None:
                keep = dropout_keep(x.shape, generator, x.device)
            x = torch.where(keep.bool(), x / KEEP_PROB, torch.zeros_like(x))
        return torch.log_softmax(self.fc1(at_least_fp32(x)), dim=-1)


class _Classifier(nn.Module):
    """conv1 -> blocks ``rn{i} = block(dtype)`` (each ``block(op, mask,
    x)``) -> the head; ``dtype`` is the computation dtype."""

    def __init__(self, layers: int, block, dtype: torch.dtype | None = None):
        super().__init__()
        self.layers = layers
        self.conv1 = GraphConv1x1(3, WIDTH, None, dtype=dtype)
        for i in range(layers):
            self.add_module(f"rn{i}", block(dtype))
        self.head = _ClassifierHead(dtype)

    def trunk(self, op, mask, inputs) -> torch.Tensor:
        x = self.conv1(inputs)
        for i in range(self.layers):
            x = getattr(self, f"rn{i}")(op, mask, x)
        return x

    def forward(self, op, mask, inputs, deterministic: bool = False, keep=None, generator=None):
        return self.head(self.trunk(op, mask, inputs), mask, deterministic, keep, generator)


class Model(_Classifier):
    """The Laplacian classifier."""

    def __init__(self, layers: int = 5, dtype: torch.dtype | None = None):
        super().__init__(layers, lambda dt: LapResNet2(WIDTH, dtype=dt), dtype)


class AvgModel(_Classifier):
    def __init__(self, layers: int = 5, dtype: torch.dtype | None = None):
        super().__init__(layers, lambda dt: AvgResNet2(WIDTH, dtype=dt), dtype)


class MlpModel(_Classifier):
    def __init__(self, layers: int = 5, dtype: torch.dtype | None = None):
        super().__init__(layers, lambda dt: MlpResNet2(WIDTH, dtype=dt), dtype)


class DirModel(_Classifier):
    """The Dirac classifier: ``op`` is a ``DiracOperator`` or a dense (Di,
    DiA) pair."""

    def __init__(self, layers: int = 5, dtype: torch.dtype | None = None):
        super().__init__(layers, lambda dt: DirResNet2(WIDTH, dtype=dt), dtype)

    def trunk(self, op, mask, inputs) -> torch.Tensor:
        v = self.conv1(inputs)
        f = v.new_zeros(inputs.shape[0], dirac_num_faces(op), WIDTH)
        for i in range(self.layers):
            v, f = getattr(self, f"rn{i}")(op, v, f)
        return v


MODELS = {"lap": Model, "avg": AvgModel, "mlp": MlpModel, "dirac": DirModel}
