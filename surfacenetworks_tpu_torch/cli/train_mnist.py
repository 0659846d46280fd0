"""Mesh-MNIST classifier trainer on one device (counterpart of
``surfacenetworks_tpu/cli/train_mnist.py``: its single-device path).

Models ``lap``, ``avg``, ``mlp`` and ``dirac`` (any name starting with
``dir``) classify height-field meshes into 10 classes with the NLL loss;
accuracy is the metric.  Data: ``--synthetic N`` height fields (blob-count
labels; ``--synthetic-classes``, ``--synthetic-points``) or a
``--data-path`` pickle in the reference's ``train_plus.np`` layout.  Runs on
``cuda`` unless given ``--device cpu``::

    python -m surfacenetworks_tpu_torch.cli.train_mnist --synthetic 320 --synthetic-points 210 --num-epoch 2
    python -m surfacenetworks_tpu_torch.cli.train_mnist --device cpu \\
        --data-path tests/fixtures/mnist_plus.np --layer 2 --num-epoch 1 --batch-size 4

As in the JAX trainer: the samples split 80/20 by index; one bucket over
all of them (vertex and face counts rounded to 8); the train batches from
``EpochSampler(train, batch, seed)``, the test batches in order;
``max(len(train) // batch, 1)`` updates an epoch and as many test batches
from the test set; Adam at ``--lr`` with coupled L2 weight decay 1e-5 and
no schedule; dropout in the update, none in the test pass (batch norms take
batch statistics in both); the log lines ``Train epoch ...`` and ``Test
epoch ...`` in ``log/<prefix>.log``, ``log/<prefix>.metrics.jsonl`` (the
plot is not drawn: the card's machine has no matplotlib) and a checkpoint
each epoch, here ``pts/<prefix>.pt`` in the port's format.  Every sample is
packed alone with ``fmt='auto'`` (dense at mesh-MNIST sizes) and the
dataset uploaded once; a batch is an index gather on the device.  The
dropout masks come from a ``torch.Generator`` seeded with ``--seed`` on the
device, so they differ from flax's draws.  ``MnistTrainer`` also takes
samples and an operator format from code.  ``--bf16`` trains in mixed
precision as the JAX trainer does (``dtype=torch.bfloat16``: bf16
activations and matmuls; the pooled features, ``fc1``, the loss, the
parameters and the optimizer state fp32).  Flags of the JAX trainer that
later slices bring are refused when given.
"""

from __future__ import annotations

import argparse
import os
import platform
import sys

import torch

from surfacenetworks_tpu_torch.cli.common import EpochSampler, MetricsLogger, make_logger
from surfacenetworks_tpu_torch.data import Buckets, datasets, mnist_batch
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples, to_device
from surfacenetworks_tpu_torch.models import init_weights
from surfacenetworks_tpu_torch.models.mnist_models import MODELS, WIDTH, dropout_keep
from surfacenetworks_tpu_torch.serve import resolve_device
from surfacenetworks_tpu_torch.train import checkpoint, losses, optim

parser = argparse.ArgumentParser(description="Mesh-MNIST classifier (PyTorch, one device)")
parser.add_argument("--batch-size", type=int, default=64)
parser.add_argument("--num-epoch", type=int, default=1000)
parser.add_argument("--model", default="lap", help="lap | avg | mlp | dirac")
parser.add_argument("--layer", type=int, default=5)
parser.add_argument("--synthetic", type=int, default=0)
parser.add_argument("--synthetic-classes", type=int, default=10)
parser.add_argument("--synthetic-points", type=int, default=120)
parser.add_argument("--data-path", default=None, help="train_plus.np-style pickle")
parser.add_argument("--lr", type=float, default=1e-3)
parser.add_argument("--result-prefix", default="mnist")
parser.add_argument("--result-dir", default="results/mesh_mnist_torch")
parser.add_argument("--seed", type=int, default=17)
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
parser.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: bf16 activations and matmuls, fp32 parameters, "
                         "optimizer state and losses")
# flags of the JAX trainer that later slices bring: refused when given
parser.add_argument("--data-parallel", type=int, default=0)
parser.add_argument("--graph-parallel", type=int, default=0)
parser.add_argument("--config", default=None)
parser.add_argument("--preset", default=None)


def refuse_unported(args, trainer: str) -> None:
    """Raise on any flag whose path this slice does not port (the flags the
    classifier and the VAE share)."""
    refused = {
        "--data-parallel": args.data_parallel != 0,
        "--graph-parallel": args.graph_parallel != 0,
        "--config and --preset": args.config is not None or args.preset is not None,
    }
    given = [k for k, v in refused.items() if v]
    if given:
        raise SystemExit(f"{trainer} (PyTorch port): not ported yet: {', '.join(given)}")


def dtype(args) -> torch.dtype | None:
    """The models' computation dtype: bf16 under ``--bf16``, else fp32."""
    return torch.bfloat16 if args.bf16 else None


def model_key(name: str, known) -> str:
    """The model family a ``--model`` name selects (``dir...`` is dirac)."""
    key = "dirac" if name.startswith("dir") else name
    if key not in known:
        raise SystemExit(f"unknown --model {name!r}: expected one of {', '.join(sorted(known))}")
    return key


def load_data(args) -> list[dict]:
    if args.synthetic:
        return datasets.synthetic_mnist_dataset(args.synthetic, seed=args.seed, n_classes=args.synthetic_classes,
                                                n_points=args.synthetic_points)
    if args.data_path:
        return datasets.load_mnist_mesh_pickle(args.data_path)
    raise SystemExit("provide --synthetic N or --data-path train_plus.np")


class MeshMnistRun:
    """What the classifier and the VAE trainers share: the device, the
    80/20 split, the bucket, each sample packed once by ``batch_fn`` in
    ``fmt``, the samplers, the steps per epoch, the device dataset (unless
    ``store`` is False or the 6 GiB budget is exceeded), the random
    generator on the device, ``model`` with seeded weights on the device,
    coupled-L2 Adam and the update count."""

    def __init__(self, args, samples: list[dict], batch_fn, kind: str, fmt: str, store: bool,
                 model: torch.nn.Module, log):
        self.args, self.log = args, log
        self.device = resolve_device(args.device)
        log(f"devices {self.device}" + (f" ({torch.cuda.get_device_name(self.device)})"
                                        if self.device.type == "cuda" else ""))
        # fp32 matmuls and convolutions in full fp32 (no TF32), and bf16 ones
        # (--bf16) summed in fp32 throughout, as XLA sums them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        sep = max(1, int(len(samples) * 0.8))
        self.train_samples, self.test_samples = samples[:sep], samples[sep:]
        self.kind, self.fmt = kind, fmt
        self.buckets = Buckets.for_samples(samples, multiple=8)
        self.packed = PackedSamples(lambda s: batch_fn([s], self.buckets, model=kind, fmt=fmt))
        B = args.batch_size
        self.train_sampler = EpochSampler(self.train_samples, B, seed=args.seed)
        self.test_sampler = EpochSampler(self.test_samples, B, shuffle=False)
        self.steps_per_epoch = max(len(self.train_samples) // B, 1)
        self.test_steps = max(len(self.test_samples) // B, 1)
        self.gen = torch.Generator(device=self.device).manual_seed(args.seed)
        self.step = 0  # updates taken (the JAX trainer's TrainState.step)
        self.store = DeviceDataset.build(samples, self.packed, self.device) if store else None
        if self.store is None:
            why = "the dataset exceeds the device budget" if store else "--no-device-store"
            log(f"batches assembled on the host and uploaded per step ({why})")
        else:
            log(self.store.stats())
        init_weights(model, torch.Generator().manual_seed(0))
        self.model = model.to(self.device)
        log(f"Num parameters {sum(p.numel() for p in self.model.parameters())}")
        self.opt = optim.adam(self.model.parameters(), args.lr, weight_decay=1e-5)

    def batch(self, samples: list[dict]):
        """The batch of ``samples`` on the device."""
        if self.store is None:
            return to_device(self.packed.batch(samples), self.device)
        return self.store.batch(samples).gather()

    def save(self, path: str, epoch: int) -> None:
        checkpoint.save_checkpoint(path, self.model, self.opt, epoch, self.step)


def classify(model, batch, deterministic: bool, keep=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(NLL loss, accuracy) of the model's log-probabilities on a batch."""
    logp = model(batch.operator, batch.mask, batch.inputs, deterministic=deterministic, keep=keep)
    return losses.nll_loss(logp, batch.targets), losses.accuracy(logp, batch.targets)


def train_step(model, opt, batch, keep) -> tuple[torch.Tensor, torch.Tensor]:
    """One update with the dropout keep mask ``keep [B, 64]``: the loss, its
    gradients and the Adam step.  Returns the loss and the accuracy (on the
    device); the gradients stay in ``.grad`` until the next step."""
    opt.zero_grad(set_to_none=True)
    loss, acc = classify(model, batch, False, keep)
    loss.backward()
    opt.step()
    return loss.detach(), acc


@torch.no_grad()
def eval_step(model, batch) -> tuple[torch.Tensor, torch.Tensor]:
    return classify(model, batch, True)


class MnistTrainer(MeshMnistRun):
    """Data, model, optimizer, samplers, dropout generator and the device
    dataset of one run; ``samples`` (sample dicts) replace the ones the
    flags name, and ``fmt`` is the Laplacian's operator format."""

    def __init__(self, args, samples: list[dict] | None = None, fmt: str = "auto", log=print):
        refuse_unported(args, "train_mnist")
        key = model_key(args.model, MODELS)
        super().__init__(args, load_data(args) if samples is None else samples, mnist_batch,
                         "dirac" if key == "dirac" else "lap", fmt, True, MODELS[key](layers=args.layer, dtype=dtype(args)),
                         log)
        self.last_keep = None

    def update(self, batch, keep=None) -> tuple[torch.Tensor, torch.Tensor]:
        """One update; the keep mask is drawn from the run's generator
        unless given, and kept as ``last_keep``."""
        if keep is None:
            keep = dropout_keep((batch.inputs.shape[0], WIDTH), self.gen, self.device)
        self.last_keep = keep
        out = train_step(self.model, self.opt, batch, keep)
        self.step += 1
        return out

    def train_epoch(self, epoch: int, metrics_log: MetricsLogger | None = None) -> tuple[float, float]:
        """An epoch of updates; logs and returns the mean loss and accuracy."""
        n = self.steps_per_epoch
        sums = torch.zeros(2, device=self.device)
        for _ in range(n):
            sums += torch.stack(self.update(self.batch(self.train_sampler.next_batch())))
        loss, acc = (v / n for v in sums.tolist())
        self.log(f"Train epoch {epoch}, loss {loss}, acc {acc}")
        if metrics_log is not None:
            metrics_log.write(epoch, "train", loss=loss, acc=acc)
        return loss, acc

    def test_pass(self, epoch: int, metrics_log: MetricsLogger | None = None) -> tuple[float, float]:
        """The test batches (the sampler goes on where the last pass ended);
        logs and returns the mean loss and accuracy."""
        loss_sum = acc_sum = 0.0
        for _ in range(self.test_steps):
            loss, acc = eval_step(self.model, self.batch(self.test_sampler.next_batch()))
            loss_sum += float(loss)
            acc_sum += float(acc)
        loss, acc = loss_sum / self.test_steps, acc_sum / self.test_steps
        self.log(f"Test epoch {epoch}, loss {loss}, acc {acc}")
        if metrics_log is not None:
            metrics_log.write(epoch, "test", loss=loss, acc=acc)
        return loss, acc


def main(argv=None) -> dict:
    """Train; returns each epoch's train and test (loss, accuracy)."""
    args = parser.parse_args(argv)
    log = make_logger(args.result_prefix, os.path.join(args.result_dir, "log"))
    log(args)
    log(f"hostname {platform.node()}")
    trainer = MnistTrainer(args, log=log)
    metrics_log = MetricsLogger(args.result_prefix, os.path.join(args.result_dir, "log"))
    ckpt = os.path.join(args.result_dir, "pts", f"{args.result_prefix}.pt")
    history: dict = {"train": [], "test": []}
    for epoch in range(args.num_epoch):
        history["train"].append(trainer.train_epoch(epoch, metrics_log))
        history["test"].append(trainer.test_pass(epoch, metrics_log))
        trainer.save(ckpt, epoch)
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
