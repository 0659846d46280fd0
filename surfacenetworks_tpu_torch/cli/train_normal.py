"""Normal-prediction trainer on one device (counterpart of
``surfacenetworks_tpu/cli/train_normal.py``: its single-device path).

A model of the normal zoo regresses per-vertex normals with the masked
cosine loss; the mean angle deviation is its metric.  ``--model`` picks it
as the JAX trainer's ``build_model`` does: ``cas`` the multiresolution
EfficientCascade, a name with ``avg`` in it AvgModel, ``mlp`` MlpModel,
``id`` IdDeepModel, ``gat`` GatDeepModel, a name starting with ``dirac``
DirDeepModel, any other LapDeepModel.  The cascade trains on
``--cascade-levels`` Laplacian pyramid levels (``data.cascade_batch``: one
ELL operator of 32 slots per level, the finest over a bucket rounded up to
``2**(levels-1)`` rows), whatever the format flag says (``bsr`` still
RCM-orders the meshes first, as in the JAX trainer).
Laplacian operators are ELL, BSR (over RCM-ordered vertices) or dense;
``auto`` resolves against the dataset for ``--model lap`` as the JAX trainer
does, and for the other Laplacian-data models as its per-sample packing does
(dense up to 2,048 vertices, else ELL).  ``gat`` attends over the ELL
pattern: its format is ELL whatever the flag says, over RCM-ordered
vertices.  Dirac data (``--model`` starting with ``dirac``) is the
structured Dirac tables whatever the format flag says, in the vertex order;
``--operator-format bsr`` only rounds their buckets to 128, as in the JAX
trainer.  ``--flip-variants K`` adds K constrained-edge-flip variants of
each train mesh (``np.random.default_rng(seed + 101)``, the JAX trainer's
draws) with their normals and operators recomputed.  ``--rotate-augment``
rotates each train batch's inputs and targets by random rotations ``Rz Ry
Rx``, their angles JAX's ``uniform(fold_in(key(seed), step), (B, 3),
maxval=2 pi)`` (``train.prng``), ``step`` the updates taken; evaluation is
not rotated.  ``--buckets N`` pads each batch to the smallest of N size
tiers that fits it (``BucketSet``; batches drawn tier by tier,
``TieredSampler``); not with the cascade.  ``--additional-opt intrinsic``
is accepted and, as in the JAX trainer, changes nothing: the operator is the
cotangent Laplacian.  Runs on ``cuda`` unless given ``--device cpu``::

    python -m surfacenetworks_tpu_torch.cli.train_normal --synthetic 8 \\
        --layer 3 --num-epoch 2 --num-updates 10 --batch-size 2
    python -m surfacenetworks_tpu_torch.cli.train_normal --device cpu \\
        --data-path tests/fixtures/objs --layer 2 --num-epoch 1 --num-updates 3 --batch-size 2
    python -m surfacenetworks_tpu_torch.cli.train_normal --device cpu --model dirac \\
        --data-path tests/fixtures/objs --layer 2 --num-epoch 1 --num-updates 3 --batch-size 2
    python -m surfacenetworks_tpu_torch.cli.train_normal --device cpu --model gat --flip-variants 1 \\
        --data-path tests/fixtures/objs --layer 2 --num-epoch 1 --num-updates 3 --batch-size 2
    python -m surfacenetworks_tpu_torch.cli.train_normal --device cpu --model cas --cascade-levels 3 \\
        --synthetic 4 --num-epoch 1 --num-updates 2 --batch-size 2

The train/test split, the batch order, the log lines and the files
(``log/<prefix>.log``, ``log/<prefix>.metrics.jsonl``, ``cfg/<prefix>.json``)
are the JAX trainer's; checkpoints go to ``pts/<prefix>_normal_state.pt``
every 10th epoch and at the end, and ``--deser`` resumes from the port's
checkpoints or the JAX package's ``.msgpack`` files.  Every sample is packed
once and the dataset uploaded once (a batch is an index gather on the
device; one dataset per size tier); over a 6 GiB budget, or with
``--no-device-store``, each batch is stacked on the host and uploaded.
``--bf16`` trains in mixed precision as the JAX trainer does: the model
computes in bf16 from fp32 parameters (``dtype=torch.bfloat16``; its output,
the loss, the gradients and the optimizer state stay fp32) and BSR blocks
are stored in bf16.  Flags of the JAX trainer that later slices bring are
refused when given.
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

from surfacenetworks_tpu_torch.cli.common import (
    EpochSampler,
    MetricsLogger,
    Throughput,
    TieredSampler,
    dump_config,
    make_logger,
)
from surfacenetworks_tpu_torch.data import BucketSet, cascade_batch, datasets, dirac_batch, laplacian_batch, round_up
from surfacenetworks_tpu_torch.data.batching import choose_operator_format, fit_bsr_k, rcm_reorder_sample
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples, to_device
from surfacenetworks_tpu_torch.geometry import dirac_coeffs, igl_style_laplacian, repair, vertex_normals
from surfacenetworks_tpu_torch.models import (
    AvgModel,
    DirDeepModel,
    EfficientCascade,
    GatDeepModel,
    IdDeepModel,
    LapDeepModel,
    MlpModel,
    init_weights,
)
from surfacenetworks_tpu_torch.serve import resolve_device
from surfacenetworks_tpu_torch.train import checkpoint, losses, optim, prng

parser = argparse.ArgumentParser(description="Normal Predictor (PyTorch, one device)")
parser.add_argument("--model", default="lap", help="lap | dirac | avg | mlp | id | gat | cas")
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
parser.add_argument("--flip-variants", type=int, default=0, metavar="K",
                    help="append K constrained-edge-flip variants of every train mesh, with their normals and "
                         "operators recomputed")
parser.add_argument("--buckets", type=int, default=1,
                    help="number of size tiers: each batch pads to the smallest tier that fits it")
parser.add_argument("--cascade-levels", type=int, default=4, help="pyramid depth for --model cas")
parser.add_argument("--rotate-augment", action="store_true",
                    help="rotate each train batch's inputs and targets by random rotations (JAX's draws)")
# flags of the JAX trainer that later slices bring: refused when given
parser.add_argument("--data-parallel", type=int, default=0)
parser.add_argument("--graph-parallel", type=int, default=0)
parser.add_argument("--jax-profile", default=None)
parser.add_argument("--multihost", action="store_true")
parser.add_argument("--coordinator-address", default=None)
parser.add_argument("--num-processes", type=int, default=None)
parser.add_argument("--process-id", type=int, default=None)
parser.add_argument("--config", default=None)
parser.add_argument("--preset", default=None)


def dirac_data(args) -> bool:
    """The JAX trainer's test for Dirac data (structured Dirac tables, not a
    Laplacian): a model name starting with ``dirac``."""
    return args.model.startswith("dirac")


def build_model(args, dtype: torch.dtype | None = None):
    """The model ``--model`` names, chosen in the JAX trainer's order (a
    name with ``avg`` in it builds AvgModel first, so ``diracavg`` is
    AvgModel on Dirac data)."""
    if args.model == "cas":
        return EfficientCascade(3, 3, cascade_levels=args.cascade_levels, dtype=dtype)
    if "avg" in args.model:
        return AvgModel(3, 3, args.layer, dtype=dtype)
    if args.model == "mlp":
        return MlpModel(3, 3, args.layer, dtype=dtype)
    if args.model == "id":
        return IdDeepModel(3, 3, args.layer, dtype=dtype)
    if args.model == "gat":
        return GatDeepModel(3, 3, args.layer, dtype=dtype)
    if dirac_data(args):
        return DirDeepModel(3, 3, layers=args.layer, dtype=dtype)
    return LapDeepModel(3, 3, layers=args.layer, dtype=dtype)


def refuse_unported(args) -> None:
    """Raise on any flag whose path this slice does not port."""
    refused = {
        "--data-parallel": args.data_parallel != 0,
        "--graph-parallel": args.graph_parallel != 0,
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
    operator = "dirac" if dirac_data(args) else "lap"
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


def flip_variants(train: list[dict], k: int, seed: int, dirac: bool, hack: float) -> list[dict]:
    """``k`` constrained-edge-flip variants of each train sample, drawn as
    the JAX trainer draws them (``np.random.default_rng(seed + 101)``, mesh
    by mesh, a tenth of the faces' edges tried, at least 4): the same
    vertices and inputs, the flipped faces, their vertex normals as targets
    and their Laplacian (or Dirac coefficients) rebuilt."""
    rng = np.random.default_rng(seed + 101)
    extra = []
    for s in train:
        for i in range(k):
            _, F2 = repair.constrained_edge_flip(s["V"], s["F"], num_flipped_edges=max(s["F"].shape[0] // 10, 4),
                                                 rng=rng)
            v = {"V": s["V"], "F": np.asarray(F2, dtype=np.asarray(s["F"]).dtype), "input": s["input"],
                 "target": vertex_normals(s["V"], F2).astype(np.float32), "name": f"{s.get('name', 'mesh')}_flip{i}"}
            if dirac:
                v["dirac"] = dirac_coeffs(v["V"], v["F"])
            else:
                v["L"] = igl_style_laplacian(v["V"], v["F"], hack=hack)
            extra.append(v)
    return extra


def rotations(angles: torch.Tensor) -> torch.Tensor:
    """``[B, 3, 3]`` rotations ``Rz @ Ry @ Rx`` of the Euler angles ``[B, 3]``
    (x, y, z), in the angles' dtype and on their device."""
    c, s = torch.cos(angles), torch.sin(angles)
    z = torch.zeros_like(c[:, 0])
    one = torch.ones_like(z)

    def rows(r0, r1, r2):
        return torch.stack([torch.stack(r0, -1), torch.stack(r1, -1), torch.stack(r2, -1)], -2)

    rx = rows([one, z, z], [z, c[:, 0], -s[:, 0]], [z, s[:, 0], c[:, 0]])
    ry = rows([c[:, 1], z, s[:, 1]], [z, one, z], [-s[:, 1], z, c[:, 1]])
    rz = rows([c[:, 2], -s[:, 2], z], [s[:, 2], c[:, 2], z], [z, z, one])
    return rz @ ry @ rx


def step_rotations(seed: int, step: int, batch_size: int, device) -> torch.Tensor:
    """The rotations of ``--rotate-augment`` at update ``step``: the angles
    JAX draws, ``uniform(fold_in(key(seed), step), (B, 3), maxval=2 pi)``,
    from their bits on the host; cosines, sines and products in fp32 on
    ``device``."""
    angles = prng.uniform(prng.fold_in(prng.key(seed), step), (batch_size, 3), maxval=2 * np.pi)
    return rotations(torch.from_numpy(angles).to(device))


def train_step(model, opt, batch, schedule=None, rotation: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One update on a batch on the model's device: the cosine loss, its
    gradients, the scheduled LR and the optimizer step; with ``rotation``
    (``[B, 3, 3]``) the inputs and targets rotated first, ``x @ R`` row by
    row.  Returns the loss and the mean angle deviation (on the device); the
    gradients stay in each parameter's ``.grad`` until the next step."""
    opt.zero_grad(set_to_none=True)
    inputs, targets = batch.inputs, batch.targets
    if rotation is not None:
        inputs, targets = torch.bmm(inputs, rotation), torch.bmm(targets, rotation)
    out = model(batch.operator, batch.mask, inputs)
    loss = losses.normal_cosine_loss(out, batch.mask, targets)
    mad = losses.mean_angle_deviation(out, batch.mask, targets)
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
    """Data, model, optimizer, samplers and the device datasets of one run
    (``store``: one ``DeviceDataset`` per size tier, or None on the host
    path)."""

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
        dirac = dirac_data(args)
        if args.flip_variants > 0:
            extra = flip_variants(train, args.flip_variants, args.seed, dirac,
                                  0.0 if "hack0" in args.additional_opt else 1.0)
            train = train + extra
            log(f"flip augmentation: +{len(extra)} variants ({args.flip_variants} per train mesh)")
        log(f"Train size: {len(train)} Test size: {len(test)}")
        fmt = args.operator_format
        if dirac:
            # as in the JAX trainer: no 'auto' resolution and no RCM order for
            # Dirac; 'bsr' still rounds the buckets to 128 rows
            log(f"operator format for {args.model}: structured Dirac tables "
                f"(--operator-format {fmt}{': buckets rounded to 128' if fmt == 'bsr' else ''})")
        elif fmt == "auto" and args.model == "lap":
            nv_all = max((s["V"].shape[0] for s in train + test), default=0)
            fmt = choose_operator_format(args.batch_size, round_up(nv_all, 8), rcm_ok=True)
            log(f"operator format auto -> {fmt}")
        if args.model == "gat" and fmt != "ell":
            fmt = "ell"
            log("operator format -> ell (gat attends over the operator pattern)")
        if (fmt == "bsr" and not dirac) or args.model == "gat":
            train = [rcm_reorder_sample(s) for s in train]
            test = [rcm_reorder_sample(s) for s in test]
        self.train_samples, self.test_samples = train, test
        all_samples = train + test
        if args.buckets > 1 and args.model == "cas":
            raise SystemExit("--buckets > 1 does not support the cascade model (one pyramid bucket chain per run)")
        self.bucketset = BucketSet.for_samples(all_samples, n_tiers=max(args.buckets, 1),
                                               multiple=128 if fmt == "bsr" else 8)
        self.buckets = self.bucketset.tiers[-1]  # the dataset's largest
        tiers = self.bucketset.tiers
        if len(tiers) > 1:
            log(f"bucket tiers: {[(b.n_vertices, b.n_faces) for b in tiers]}")
        # each sample's operator packed alone at its tier, as the JAX trainer's device store packs it:
        # 'auto' resolves per tier
        tier_fmt = [fmt if fmt != "auto" or dirac else choose_operator_format(1, b.n_vertices) for b in tiers]
        if fmt == "auto" and not dirac and args.model != "cas":
            log(f"operator format auto -> {'/'.join(tier_fmt)} (per sample)")
        self.model = build_model(args, dtype)
        if dirac:
            self.fmt = "structured"
            self.packed = PackedSamples(lambda s: dirac_batch([s], self.bucketset.select([s])))
        elif args.model == "cas":
            levels = args.cascade_levels
            self.fmt = "ell"
            n_bucket = round_up(self.buckets.n_vertices, 2 ** (levels - 1))
            log(f"cascade: {levels} pyramid levels of {[n_bucket >> (levels - 1 - i) for i in range(levels)]} rows, "
                f"ELL at K=32")
            self.packed = PackedSamples(lambda s: cascade_batch([s], levels, n_bucket))
        else:
            self.fmt = tier_fmt[-1]
            op_dtype = dtype if fmt == "bsr" else None  # bf16 blocks under --bf16, as in the JAX trainer

            def pack(s):
                ti = self.bucketset.tier_index([s])
                return laplacian_batch([s], tiers[ti], fmt=tier_fmt[ti], op_dtype=op_dtype)
            self.packed = PackedSamples(pack)
        if fmt == "bsr" and not dirac:
            fit_bsr_k(all_samples, self.bucketset)
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

        if len(tiers) > 1:
            self.train_sampler = TieredSampler(train, self.bucketset, args.batch_size, seed=args.seed)
            self.test_sampler = (TieredSampler(test, self.bucketset, args.batch_size, shuffle=False) if test
                                 else EpochSampler(test, args.batch_size, shuffle=False))
        else:
            self.train_sampler = EpochSampler(train, args.batch_size, seed=args.seed)
            self.test_sampler = EpochSampler(test, args.batch_size, shuffle=False)
        self.store = None
        if not args.no_device_store:
            by_tier = {}
            for s in all_samples:
                by_tier.setdefault(self.bucketset.tier_index([s]), []).append(s)
            self.store = {ti: DeviceDataset.build(items, self.packed, self.device) for ti, items in by_tier.items()}
            if any(ds is None for ds in self.store.values()):
                self.store = None
        if self.store is None:
            why = "--no-device-store" if args.no_device_store else "the dataset exceeds the device budget"
            log(f"batches assembled on the host and uploaded per step ({why})")

    def batch(self, samples: list[dict]):
        """The batch of ``samples`` (of one tier) on the device."""
        if self.store is None:
            return to_device(self.packed.batch(samples), self.device)
        return self.store[self.bucketset.tier_index(samples)].batch(samples).gather()

    def rotation(self, batch_size: int) -> torch.Tensor | None:
        """The next update's rotations under ``--rotate-augment``, keyed by
        the updates taken; None without the flag."""
        if not self.args.rotate_augment:
            return None
        return step_rotations(self.args.seed, self.step, batch_size, self.device)

    def update(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        loss, mad = train_step(self.model, self.opt, batch, self.schedule, self.rotation(batch.inputs.shape[0]))
        self.step += 1
        return loss, mad

    def data_stats(self) -> str:
        if self.store is not None:
            return " + ".join(ds.stats() for ds in self.store.values())
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
