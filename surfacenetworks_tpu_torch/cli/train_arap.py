"""ARAP temporal-deformation trainer on one device (counterpart of
``surfacenetworks_tpu/cli/train_arap.py``: its single-device path).

Two input frames predict the next 40; the operator comes from the last
input frame; the output is masked and the loss is the smooth-L1 sum per
batch item.  Models ``lap``, ``avg``, ``mlp``, ``dir`` and ``gcn`` (every
one but ``dir`` takes the cotan Laplacian, as in the JAX trainer), the
Laplacian packed as ELL or, with ``--dense``, dense.  Runs on ``cuda``
unless given ``--device cpu``::

    python -m surfacenetworks_tpu_torch.cli.train_arap --synthetic 10 --layer 3 \\
        --num-epoch 2 --num-updates 10 --batch-size 4
    python -m surfacenetworks_tpu_torch.cli.train_arap --device cpu \\
        --data-path tests/fixtures/arap --layer 2 --num-epoch 1 --num-updates 3 --batch-size 4

As in the JAX trainer: the sequences split 80/20 by index; the train picks
(sequence, offset) are drawn from ``np.random.default_rng(--seed)`` in its
order, the draws of its init batch included; the test picks follow its
counter; Adam at ``--lr`` with coupled L2 weight decay 1e-5 under the LR
halved every 10 epochs past 50; the log lines ``Train epoch ...`` and
``Test epoch ...`` in ``log/<id>.log``, ``log/<id>.metrics.jsonl``, and a
checkpoint each epoch, here ``pts/<id>_<layer>_<model>.pt`` in the port's
format.  Every valid pick is packed once and, unless ``--dense`` or
``--no-device-store`` is given or the 6 GiB budget is exceeded, the picks
are uploaded once and a batch is an index gather on the device; otherwise
each batch is stacked on the host and uploaded.  ``ArapTrainer`` also takes
sequences handed in from code.  ``--bf16`` trains in mixed precision as the
JAX trainer does (``dtype=torch.bfloat16``; ELL applies take bf16 x and
return fp32, dense ones promote to fp32).  Flags of the JAX trainer that
later slices bring are refused when given.
"""

from __future__ import annotations

import argparse
import glob
import os
import platform
import sys

import numpy as np
import torch

from surfacenetworks_tpu_torch.cli.common import MetricsLogger, Throughput, make_logger
from surfacenetworks_tpu_torch.data import Buckets, arap_batch, datasets
from surfacenetworks_tpu_torch.data.batching import IN_FRAMES, OUT_FRAMES
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples, to_device
from surfacenetworks_tpu_torch.models import init_weights
from surfacenetworks_tpu_torch.models.arap_models import MODELS
from surfacenetworks_tpu_torch.serve import resolve_device
from surfacenetworks_tpu_torch.train import checkpoint, losses, optim

parser = argparse.ArgumentParser(description="As Rigid As Possible (PyTorch, one device)")
parser.add_argument("--batch-size", type=int, default=32)
parser.add_argument("--num-epoch", type=int, default=110)
parser.add_argument("--num-updates", type=int, default=1000)
parser.add_argument("--model", default="lap", choices=sorted(MODELS))
parser.add_argument("--layer", type=int, default=15)
parser.add_argument("--dense", action="store_true")
parser.add_argument("--first100", action="store_true")
parser.add_argument("--synthetic", type=int, default=0, help="N synthetic sequences")
parser.add_argument("--data-path", default="as_rigid_as_possible/data_plus")
parser.add_argument("--id", dest="result_prefix", default="test")
parser.add_argument("--result-dir", default="results/arap_torch")
parser.add_argument("--lr", type=float, default=1e-3)
parser.add_argument("--seed", type=int, default=17)
parser.add_argument("--no-device-store", action="store_true",
                    help="assemble every batch on the host (the path taken over the device budget)")
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
parser.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: bf16 activations and matmuls, fp32 parameters, "
                         "optimizer state and losses")
# flags of the JAX trainer that later slices bring: refused when given
parser.add_argument("--data-parallel", type=int, default=0)
parser.add_argument("--graph-parallel", type=int, default=0)
parser.add_argument("--dump-rollout", default=None)
parser.add_argument("--config", default=None)
parser.add_argument("--preset", default=None)


def refuse_unported(args) -> None:
    """Raise on any flag whose path this slice does not port."""
    refused = {
        "--data-parallel": args.data_parallel != 0,
        "--graph-parallel": args.graph_parallel != 0,
        "--dump-rollout (it draws with matplotlib)": args.dump_rollout is not None,
        "--config and --preset": args.config is not None or args.preset is not None,
    }
    given = [k for k, v in refused.items() if v]
    if given:
        raise SystemExit(f"train_arap (PyTorch port): not ported yet: {', '.join(given)}")


def load_sequences(args) -> list[list[dict]]:
    if args.synthetic:
        return datasets.synthetic_arap_sequences(args.synthetic, seed=args.seed)
    files = sorted(glob.glob(os.path.join(args.data_path, "*.npy")))
    if args.first100:
        files = files[:100]
    return [datasets.load_arap_sequence(f) for f in files]


def max_offsets(seq: list[dict]) -> int:
    """How many frame offsets of ``seq`` a pick may take: the operators
    exist on the first 10 frames only, so the last input frame lies in
    them."""
    return max(min(len(seq) - IN_FRAMES - OUT_FRAMES, 10 - IN_FRAMES), 1)


def masked_loss(model, batch) -> torch.Tensor:
    out = model(batch.operator, batch.mask, batch.inputs) * batch.mask
    return losses.smooth_l1_sum(out, batch.targets, batch.inputs.shape[0])


def train_step(model, opt, batch, schedule=None) -> torch.Tensor:
    """One update on a batch on the model's device: the loss, its
    gradients, the scheduled LR and the optimizer step.  Returns the loss
    (on the device); the gradients stay in ``.grad`` until the next step."""
    opt.zero_grad(set_to_none=True)
    loss = masked_loss(model, batch)
    loss.backward()
    optim.apply_schedule(opt, schedule)
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model, batch) -> torch.Tensor:
    return masked_loss(model, batch)


class ArapTrainer:
    """Sequences, model, optimizer, pick draws and the device store of one
    run; ``sequences`` (lists of frame dicts) replace the ones the flags
    name."""

    def __init__(self, args, sequences: list[list[dict]] | None = None, log=print):
        refuse_unported(args)
        self.args, self.log = args, log
        self.device = resolve_device(args.device)
        log(f"devices {self.device}" + (f" ({torch.cuda.get_device_name(self.device)})"
                                        if self.device.type == "cuda" else ""))
        # fp32 matmuls and convolutions in full fp32 (no TF32), and bf16 ones
        # (--bf16) summed in fp32 throughout, as XLA sums them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.sequences = load_sequences(args) if sequences is None else sequences
        self.n_train = max(len(self.sequences) * 8 // 10, 1)
        self.buckets = Buckets.for_samples([{"V": s[0]["V"], "F": s[0]["F"]} for s in self.sequences])
        self.fmt = "dense" if args.dense else "ell"
        kind = "dirac" if args.model == "dir" else "lap"
        self.packed = PackedSamples(
            lambda pick: arap_batch(self.sequences, [pick], self.buckets, model=kind, fmt=self.fmt),
            value_keys=True)
        self.rng = np.random.default_rng(args.seed)
        self.test_counter = 0
        self.model = MODELS[args.model](layers=args.layer, dtype=torch.bfloat16 if args.bf16 else None)
        init_weights(self.model, torch.Generator().manual_seed(0))
        self.model.to(self.device)
        # the JAX trainer initialises from one batch of train picks: its draws are used up here too
        self.sample_train_picks()
        log(f"Num parameters {sum(p.numel() for p in self.model.parameters())}")
        self.schedule = optim.epoch_halving_schedule(args.lr, args.num_updates, 50, 10)
        self.opt = optim.adam(self.model.parameters(), self.schedule, weight_decay=1e-5)
        self.step = 0  # updates taken (the JAX trainer's TrainState.step)
        self.all_picks = [(si, off) for si, seq in enumerate(self.sequences) for off in range(max_offsets(seq))]
        self.store = None
        if not (args.dense or args.no_device_store):
            self.store = DeviceDataset.build(self.all_picks, self.packed, self.device)
        if self.store is None:
            why = ("--dense" if args.dense else "--no-device-store" if args.no_device_store
                   else "the picks exceed the device budget")
            log(f"batches assembled on the host and uploaded per step ({why})")
        else:
            log(self.store.stats())

    def sample_train_picks(self) -> list[tuple[int, int]]:
        """A batch of (sequence, offset) picks from the train sequences,
        drawn as the JAX trainer draws them."""
        picks = []
        for _ in range(self.args.batch_size):
            ind = int(self.rng.integers(0, self.n_train))
            picks.append((ind, int(self.rng.integers(0, max_offsets(self.sequences[ind])))))
        return picks

    def sample_test_picks(self) -> list[tuple[int, int]]:
        """The next batch of test picks: sequence and offset both follow one
        counter over the test sequences."""
        picks = []
        n_test = max(len(self.sequences) - self.n_train, 1)
        for _ in range(self.args.batch_size):
            ind = self.n_train + self.test_counter % n_test
            picks.append((ind, self.test_counter % max_offsets(self.sequences[ind])))
            self.test_counter += 1
        return picks

    def batch(self, picks: list[tuple[int, int]]):
        """The batch of ``picks`` on the device."""
        if self.store is None:
            return to_device(self.packed.batch(picks), self.device)
        return self.store.batch(picks).gather()

    def update(self, batch) -> torch.Tensor:
        loss = train_step(self.model, self.opt, batch, self.schedule)
        self.step += 1
        return loss

    def train_epoch(self, epoch: int, metrics_log: MetricsLogger | None = None) -> float:
        """``--num-updates`` updates; logs and returns the mean loss."""
        n = self.args.num_updates
        meter = Throughput()
        loss_sum = torch.zeros((), device=self.device)
        for _ in range(n):
            batch = self.batch(self.sample_train_picks())
            loss_sum += self.update(batch)
            meter.tick(batch.inputs.shape[0] * batch.inputs.shape[1])
        loss = float(loss_sum) / n
        self.log(f"Train epoch {epoch}, loss {loss}, {meter.report()}")
        if metrics_log is not None:
            metrics_log.write(epoch, "train", loss=loss, steps_per_s=meter.steps_per_s)
        return loss

    def test_pass(self, epoch: int, metrics_log: MetricsLogger | None = None) -> float:
        """The test batches (the counter goes on where the last pass ended);
        logs and returns the mean loss."""
        trials = max(len(self.sequences) // 5 // self.args.batch_size, 1)
        loss_sum = 0.0
        for _ in range(trials):
            loss_sum += float(eval_step(self.model, self.batch(self.sample_test_picks())))
        self.log(f"Test epoch {epoch}, loss {loss_sum / trials}")
        if metrics_log is not None:
            metrics_log.write(epoch, "test", loss=loss_sum / trials)
        return loss_sum / trials

    def save(self, path: str, epoch: int) -> None:
        checkpoint.save_checkpoint(path, self.model, self.opt, epoch, self.step)


def main(argv=None) -> dict:
    """Train; returns each epoch's train and test loss."""
    args = parser.parse_args(argv)
    log = make_logger(args.result_prefix, os.path.join(args.result_dir, "log"))
    log(args)
    log(f"hostname {platform.node()}")
    trainer = ArapTrainer(args, log=log)
    metrics_log = MetricsLogger(args.result_prefix, os.path.join(args.result_dir, "log"))
    ckpt = os.path.join(args.result_dir, "pts", f"{args.result_prefix}_{args.layer}_{args.model}.pt")
    history: dict = {"train": [], "test": []}
    for epoch in range(args.num_epoch):
        history["train"].append(trainer.train_epoch(epoch, metrics_log))
        history["test"].append(trainer.test_pass(epoch, metrics_log))
        trainer.save(ckpt, epoch)
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
