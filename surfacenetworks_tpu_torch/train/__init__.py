"""Losses, metrics, optimizers and checkpoints (counterpart of ``surfacenetworks_tpu/train``)."""

from surfacenetworks_tpu_torch.train import checkpoint, losses, optim

__all__ = ["checkpoint", "losses", "optim"]
