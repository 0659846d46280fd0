"""Normal-prediction trainer on one device (counterpart of
``surfacenetworks_tpu/cli/train_normal.py``: its single-device path for
``--model lap`` and ``--model dirac``).

LapDeepModel or DirDeepModel regresses per-vertex normals with the masked
cosine loss; the mean angle deviation is its metric.  Laplacian operators
are ELL, BSR (over RCM-ordered vertices) or dense; ``auto`` resolves against
the dataset as the JAX trainer does.  Dirac models (``--model`` starting
with ``dirac``) take the structured Dirac tables whatever the format flag
says, and keep the vertex order; ``--operator-format bsr`` only rounds their
buckets to 128, as in the JAX trainer.  Runs on ``cuda`` unless given
``--device cpu``::

    python -m surfacenetworks_tpu_torch.cli.train_normal --synthetic 8 \\
        --layer 3 --num-epoch 2 --num-updates 10 --batch-size 2
    python -m surfacenetworks_tpu_torch.cli.train_normal --device cpu \\
        --data-path tests/fixtures/objs --layer 2 --num-epoch 1 --num-updates 3 --batch-size 2
    python -m surfacenetworks_tpu_torch.cli.train_normal --device cpu --model dirac \\
        --data-path tests/fixtures/objs --layer 2 --num-epoch 1 --num-updates 3 --batch-size 2

The train/test split, the batch order, the log lines and the files
(``log/<prefix>.log``, ``log/<prefix>.metrics.jsonl``, ``cfg/<prefix>.json``)
are the JAX trainer's; checkpoints go to ``pts/<prefix>_normal_state.pt``
every 10th epoch and at the end, and ``--deser`` resumes from the port's
checkpoints or the JAX package's ``.msgpack`` files.  Every sample is packed
once and the dataset uploaded once (a batch is an index gather on the
device); over a 6 GiB budget, or with ``--no-device-store``, each batch is
stacked on the host and uploaded.  ``--bf16`` trains in mixed precision as
the JAX trainer does: the model computes in bf16 from fp32 parameters
(``dtype=torch.bfloat16``; its output, the loss, the gradients and the
optimizer state stay fp32) and BSR blocks are stored in bf16.  Flags of the
JAX trainer that later slices bring are refused when given.
"""

from __future__ import annotations

import argparse
import math
import os
import platform
import random
import sys
import tempfile

import numpy as np
import torch

from surfacenetworks_tpu_torch.cli.common import EpochSampler, MetricsLogger, Throughput, dump_config, make_logger
from surfacenetworks_tpu_torch.data import Buckets, datasets, dirac_batch, laplacian_batch, round_up
from surfacenetworks_tpu_torch.data.batching import choose_operator_format, fit_bsr_k, rcm_reorder_sample
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples, to_device
from surfacenetworks_tpu_torch.models import DirDeepModel, LapDeepModel, init_weights
from surfacenetworks_tpu_torch.serve import resolve_device
from surfacenetworks_tpu_torch.train import checkpoint, losses, optim

parser = argparse.ArgumentParser(description="Normal Predictor (PyTorch, one device)")
parser.add_argument("--model", default="lap",
                    help="lap, or dirac (any name starting with dirac); the other models are not ported yet")
parser.add_argument("--layer", type=int, default=15)
parser.add_argument("--batch-size", type=int, default=1)
parser.add_argument("--num-epoch", type=int, default=500)
parser.add_argument("--start-epoch", type=int, default=0)
parser.add_argument("--num-updates", type=int, default=500)
parser.add_argument("--lr", type=float, default=1e-3)
parser.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
parser.add_argument("--half-lr", type=int, default=-1, help="halve LR every N epochs past 100")
parser.add_argument("--data-path", default=None, help="obj tree root")
parser.add_argument("--test-path", default="@")
parser.add_argument("--synthetic", type=int, default=0, help="use N synthetic meshes instead of files")
parser.add_argument("--synthetic-points", type=int, default=150)
parser.add_argument("--no-test", action="store_true")
parser.add_argument("--uniform-mesh", action="store_true")
parser.add_argument("--additional-opt", default=[], action="append",
                    choices=["hack1", "hack0", "amsgrad", "intrinsic", ""])
parser.add_argument("--operator-format", default="auto", choices=["auto", "ell", "bsr", "dense"])
parser.add_argument("--result-prefix", default="debug")
parser.add_argument("--result-dir", default="results/normal_predict_torch")
parser.add_argument("--deser", default=None, help="checkpoint to resume from (.pt of the port or .msgpack of JAX)")
parser.add_argument("--only-forward-test", action="store_true")
parser.add_argument("--dump-dir", default=tempfile.gettempdir())
parser.add_argument("--debug", action="store_true")
parser.add_argument("--no-device-store", action="store_true",
                    help="assemble every batch on the host (the path taken over the device budget)")
parser.add_argument("--seed", type=int, default=17)
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
parser.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: bf16 activations and matmuls, fp32 parameters, "
                         "optimizer state and losses")
# flags of the JAX trainer that later slices bring: refused when given
parser.add_argument("--data-parallel", type=int, default=0)
parser.add_argument("--graph-parallel", type=int, default=0)
parser.add_argument("--buckets", type=int, default=1)
parser.add_argument("--cascade-levels", type=int, default=4)
parser.add_argument("--rotate-augment", action="store_true")
parser.add_argument("--flip-variants", type=int, default=0)
parser.add_argument("--jax-profile", default=None)
parser.add_argument("--multihost", action="store_true")
parser.add_argument("--coordinator-address", default=None)
parser.add_argument("--num-processes", type=int, default=None)
parser.add_argument("--process-id", type=int, default=None)
parser.add_argument("--config", default=None)
parser.add_argument("--preset", default=None)


def is_dirac(args) -> bool:
    """The JAX trainer's test for the Dirac model (a name with ``avg`` in it
    builds its AvgModel first)."""
    return args.model.startswith("dirac") and "avg" not in args.model


def refuse_unported(args) -> None:
    """Raise on any flag whose path this slice does not port."""
    refused = {
        "--model other than lap and dirac": args.model != "lap" and not is_dirac(args),
        "--data-parallel": args.data_parallel != 0,
        "--graph-parallel": args.graph_parallel != 0,
        "--buckets > 1": args.buckets > 1,
        "--rotate-augment": args.rotate_augment,
        "--flip-variants": args.flip_variants > 0,
        "--additional-opt intrinsic": "intrinsic" in args.additional_opt,
        "--jax-profile": args.jax_profile is not None,
        "--config and --preset": args.config is not None or args.preset is not None,
        "--multihost and its coordinator flags": args.multihost or any(
            v is not None for v in (args.coordinator_address, args.num_processes, args.process_id)),
    }
    given = [k for k, v in refused.items() if v]
    if given:
        raise SystemExit(f"train_normal (PyTorch port): not ported yet: {', '.join(given)}")


def load_samples(args, rnd: random.Random, log) -> tuple[list[dict], list[dict]]:
    """The train and test samples, split as the JAX trainer splits them
    (``rnd`` seeded with ``--seed`` draws what its global ``random`` draws)."""
    operator = "dirac" if is_dirac(args) else "lap"
    hack = 0.0 if "hack0" in args.additional_opt else 1.0
    if args.synthetic:
        samples = datasets.synthetic_normal_dataset(args.synthetic, n_points=args.synthetic_points,
                                                    seed=args.seed, operator=operator, hack=hack)
        rnd.shuffle(samples)
        sep = max(1, int(len(samples) * 0.8))
        return samples[:sep], samples[sep:]
    names = datasets.scan_mesh_tree(args.data_path)
    log(f"SEQ:{len(names)}")
    if args.test_path != "@":
        train_names, test_names = names, datasets.scan_mesh_tree(args.test_path)
    else:
        sep = len(names) // 10 * 8
        rnd.shuffle(names)
        train_names, test_names = names[:sep], names[sep:]

    def load_all(paths):
        out = []
        for p in paths:
            if p.endswith(".npz"):
                s = datasets.load_normal_npz(p)
            else:
                s = datasets.load_normal_sample(p, operator=operator, hack=hack, uniform_mesh=args.uniform_mesh)
            if s is not None:
                out.append(s)
        return out

    return load_all(train_names), load_all(test_names)


def train_step(model, opt, batch, schedule=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One update on a batch on the model's device: the cosine loss, its
    gradients, the scheduled LR and the optimizer step.  Returns the loss and
    the mean angle deviation (on the device); the gradients stay in each
    parameter's ``.grad`` until the next step."""
    opt.zero_grad(set_to_none=True)
    out = model(batch.operator, batch.mask, batch.inputs)
    loss = losses.normal_cosine_loss(out, batch.mask, batch.targets)
    mad = losses.mean_angle_deviation(out, batch.mask, batch.targets)
    loss.backward()
    optim.apply_schedule(opt, schedule)
    opt.step()
    return loss.detach(), mad


@torch.no_grad()
def eval_step(model, batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    out = model(batch.operator, batch.mask, batch.inputs)
    return losses.normal_cosine_loss(out, batch.mask, batch.targets), losses.mean_angle_deviation(
        out, batch.mask, batch.targets), out


class NormalTrainer:
    """Data, model, optimizer, samplers and the device dataset of one run."""

    def __init__(self, args, log=print):
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
        dtype = torch.bfloat16 if args.bf16 else None
        train, test = load_samples(args, random.Random(args.seed), log)
        log(f"Train size: {len(train)} Test size: {len(test)}")
        fmt = args.operator_format
        dirac = is_dirac(args)
        if dirac:
            # as in the JAX trainer: no 'auto' resolution and no RCM order for
            # Dirac; 'bsr' still rounds the buckets to 128 rows
            log(f"operator format for {args.model}: structured Dirac tables "
                f"(--operator-format {fmt}{': buckets rounded to 128' if fmt == 'bsr' else ''})")
        elif fmt == "auto":
            nv_all = max((s["V"].shape[0] for s in train + test), default=0)
            fmt = choose_operator_format(args.batch_size, round_up(nv_all, 8), rcm_ok=True)
            log(f"operator format auto -> {fmt}")
        if fmt == "bsr" and not dirac:
            train = [rcm_reorder_sample(s) for s in train]
            test = [rcm_reorder_sample(s) for s in test]
        self.train_samples, self.test_samples = train, test
        all_samples = train + test
        self.buckets = Buckets.for_samples(all_samples, multiple=128 if fmt == "bsr" else 8)
        if dirac:
            self.fmt = "structured"
            self.packed = PackedSamples(lambda s: dirac_batch([s], self.buckets))
            self.model = DirDeepModel(3, 3, layers=args.layer, dtype=dtype)
        else:
            self.fmt = fmt
            if fmt == "bsr":
                fit_bsr_k(all_samples, self.buckets)
            op_dtype = dtype if fmt == "bsr" else None  # bf16 blocks under --bf16, as in the JAX trainer
            self.packed = PackedSamples(lambda s: laplacian_batch([s], self.buckets, fmt=fmt, op_dtype=op_dtype))
            self.model = LapDeepModel(3, 3, layers=args.layer, dtype=dtype)
        init_weights(self.model, torch.Generator().manual_seed(0))
        self.model.to(self.device)
        log(f"Num parameters {sum(p.numel() for p in self.model.parameters())}")
        self.schedule = (optim.epoch_halving_schedule(args.lr, args.num_updates, 100, args.half_lr)
                         if args.half_lr > 0 else None)
        lr = self.schedule or args.lr
        if args.optimizer == "adam":
            self.opt = optim.adam(self.model.parameters(), lr, amsgrad="amsgrad" in args.additional_opt)
        else:
            self.opt = optim.sgd(self.model.parameters(), lr)
        self.step = 0  # updates taken (the JAX trainer's TrainState.step)
        self.start_epoch = args.start_epoch
        if args.deser:
            log("Continue...")
            self.start_epoch, self.step, loaded = checkpoint.restore_training(args.deser, self.model, self.opt)
            if not loaded:
                log("Warning: Optimizer is not loaded")

        self.train_sampler = EpochSampler(train, args.batch_size, seed=args.seed)
        self.test_sampler = EpochSampler(test, args.batch_size, shuffle=False)
        self.store = None if args.no_device_store else DeviceDataset.build(all_samples, self.packed, self.device)
        if self.store is None:
            why = "--no-device-store" if args.no_device_store else "the dataset exceeds the device budget"
            log(f"batches assembled on the host and uploaded per step ({why})")

    def batch(self, samples: list[dict]):
        """The batch of ``samples`` on the device."""
        if self.store is None:
            return to_device(self.packed.batch(samples), self.device)
        return self.store.batch(samples).gather()

    def update(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        loss, mad = train_step(self.model, self.opt, batch, self.schedule)
        self.step += 1
        return loss, mad

    def data_stats(self) -> str:
        if self.store is not None:
            return self.store.stats()
        return f"host batch assembly: {len(self.train_samples) + len(self.test_samples)} samples, each packed once"

    def train_epoch(self, epoch: int, metrics_log: MetricsLogger | None = None) -> tuple[float, float]:
        """``--num-updates`` updates; logs and returns the mean loss and mad.
        A non-finite mean loss raises ``FloatingPointError``."""
        n = self.args.num_updates
        meter = Throughput()
        sums = torch.zeros(2, device=self.device)
        for _ in range(n):
            batch = self.batch(self.train_sampler.next_batch())
            loss, mad = self.update(batch)
            sums += torch.stack([loss, mad])
            meter.tick(batch.inputs.shape[0] * batch.inputs.shape[1])
        loss_mean, mad_mean = (v / n for v in sums.tolist())
        checkpoint.check_finite({"loss": loss_mean}, f"at epoch {epoch}")
        self.log("Train {}, loss {}, mad {}, {}".format(epoch, loss_mean, mad_mean, meter.report()))
        if metrics_log is not None:
            metrics_log.write(epoch, "train", loss=loss_mean, mad=mad_mean, steps_per_s=meter.steps_per_s)
        if epoch == self.start_epoch:
            self.log(self.data_stats())
        return loss_mean, mad_mean

    def test_pass(self, epoch: int, metrics_log: MetricsLogger | None = None,
                  dump_dir: str | None = None) -> tuple[float, float]:
        """The test batches (the sampler goes on where the last pass ended);
        logs and returns the mean loss and mad.  With ``dump_dir``, each
        prediction (padded rows, the samples' order) goes to
        ``<dump_dir>/<basename of its name>.csv``."""
        trials = max(math.ceil(len(self.test_samples) / self.args.batch_size), 1)
        loss_sum = mad_sum = 0.0
        for _ in range(trials):
            batch = self.batch(self.test_sampler.next_batch())
            loss, mad, out = eval_step(self.model, batch)
            loss_sum += float(loss)
            mad_sum += float(mad)
            if dump_dir is not None:
                os.makedirs(dump_dir, exist_ok=True)
                for name, pred in zip(batch.names, out.cpu().numpy()):
                    np.savetxt(os.path.join(dump_dir, os.path.basename(str(name)) + ".csv"), pred, delimiter=",")
        self.log("Eval {}, loss {}, mad {}".format(epoch, loss_sum / trials, mad_sum / trials))
        if metrics_log is not None:
            metrics_log.write(epoch, "test", loss=loss_sum / trials, mad=mad_sum / trials)
        return loss_sum / trials, mad_sum / trials

    def save(self, path: str, epoch: int) -> None:
        checkpoint.save_checkpoint(path, self.model, self.opt, epoch, self.step)


def main(argv=None) -> dict:
    """Train (or, with ``--only-forward-test``, evaluate once); returns each
    epoch's train and test (loss, mad)."""
    args = parser.parse_args(argv)
    log = make_logger(args.result_prefix, os.path.join(args.result_dir, "log"), args.debug)
    log(args)
    log(f"hostname {platform.node()}")
    if not args.debug:
        dump_config(args, os.path.join(args.result_dir, "cfg", f"{args.result_prefix}.json"))
    trainer = NormalTrainer(args, log)
    ckpt_path = os.path.join(args.result_dir, "pts", f"{args.result_prefix}_normal_state.pt")
    metrics_log = MetricsLogger(args.result_prefix, os.path.join(args.result_dir, "log"), args.debug)
    history: dict = {"train": [], "test": []}
    for epoch in range(trainer.start_epoch, args.num_epoch):
        if not args.only_forward_test:
            history["train"].append(trainer.train_epoch(epoch, metrics_log))
        if not args.no_test and trainer.test_samples:
            dump = os.path.join(args.dump_dir, args.result_prefix) if args.only_forward_test else None
            history["test"].append(trainer.test_pass(epoch, metrics_log, dump))
        if args.only_forward_test:
            return history
        if epoch % 10 == 9 and not args.debug:
            trainer.save(ckpt_path, epoch)
    trainer.save(ckpt_path, args.num_epoch - 1)
    log("done")
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
