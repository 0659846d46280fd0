"""Losses, metrics, optimizers, checkpoints, JAX's random draws and the timing
tools (counterpart of ``surfacenetworks_tpu/train``)."""

from surfacenetworks_tpu_torch.train import checkpoint, losses, optim, prng, timing
from surfacenetworks_tpu_torch.train.timing import ThroughputMeter, device_timer, time_string, trace

__all__ = ["ThroughputMeter", "checkpoint", "device_timer", "losses", "optim", "prng", "time_string", "timing",
           "trace"]
