"""Losses, metrics, optimizers, checkpoints and JAX's random draws (counterpart of
``surfacenetworks_tpu/train``)."""

from surfacenetworks_tpu_torch.train import checkpoint, losses, optim, prng

__all__ = ["checkpoint", "losses", "optim", "prng"]
