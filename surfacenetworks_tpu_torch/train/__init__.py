"""Losses, metrics, optimizers, checkpoints, the train steps, JAX's random
draws and the timing tools (counterpart of ``surfacenetworks_tpu/train``)."""

from surfacenetworks_tpu_torch.train import checkpoint, losses, loop, optim, prng, timing
from surfacenetworks_tpu_torch.train.loop import TrainState
from surfacenetworks_tpu_torch.train.timing import ThroughputMeter, device_timer, time_string, trace

__all__ = ["ThroughputMeter", "TrainState", "checkpoint", "device_timer", "loop", "losses", "optim", "prng",
           "time_string", "timing", "trace"]
