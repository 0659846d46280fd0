"""Losses, metrics, optimizers, checkpoints, the train steps, JAX's random
draws and the timing tools (counterpart of ``surfacenetworks_tpu/train``)."""

from surfacenetworks_tpu_torch.train import checkpoint, losses, loop, optim, prng, timing
from surfacenetworks_tpu_torch.train.loop import TrainState, make_eval_step, make_train_step
from surfacenetworks_tpu_torch.train.timing import ThroughputMeter, device_timer, time_string, trace

__all__ = ["ThroughputMeter", "TrainState", "checkpoint", "device_timer", "loop", "losses", "make_eval_step",
           "make_train_step", "optim", "prng", "time_string", "timing", "trace"]
