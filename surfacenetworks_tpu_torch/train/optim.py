"""Optimizers (counterpart of ``surfacenetworks_tpu/train/optim.py``)."""

from __future__ import annotations

from typing import Iterable

import torch


def adam(params: Iterable[torch.nn.Parameter], lr: float = 1e-3, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with coupled L2: the decay is added to the gradient before the
    moments, as ``optax.chain(add_decayed_weights(wd), adam(lr))`` does in the
    JAX package (betas 0.9 and 0.999, eps 1e-8 in both)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
