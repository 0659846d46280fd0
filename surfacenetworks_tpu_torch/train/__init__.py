"""Losses, metrics and the optimizer (counterpart of ``surfacenetworks_tpu/train``)."""

from surfacenetworks_tpu_torch.train import losses, optim

__all__ = ["losses", "optim"]
