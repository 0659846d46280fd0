"""FAUST dense-correspondence siamese trainer on one device (counterpart of
``surfacenetworks_tpu/cli/train_correspondence.py``: its single-device fast
path for ``--model lap --loss dcel``).

Two shapes per step through a shared Lap trunk; the dcel loss against the
per-pair argmin of the aggregated geodesic cost, with the streaming head by
default at buckets of 4,096 vertices and more; optional random XZ/XY rotation
augmentation and the ``--smooth-reg`` feature-smoothness term (the SDDMM
consumer).  Runs on ``cuda`` unless given ``--device cpu``::

    python -m surfacenetworks_tpu_torch.cli.train_correspondence \\
        --synthetic 4 --synthetic-points 7000 --smooth-reg 0.1 --xz-rotate
    python -m surfacenetworks_tpu_torch.cli.train_correspondence \\
        --datapath tests/fixtures/faust --device cpu --layer 2 --num-updates 2

Each sample's operator, mask, unrotated inputs, padded geodesic matrix and
label tables go to the device once; each (shape A, shape B) pair's dcel
target is computed once on the device and cached, with its inverse (built on
the host) for the streaming head's backward.  Updates run one per step
in the order of the epoch plan (the JAX trainer's ``--no-epoch-scan``
order).  ``--bf16`` trains in mixed precision as the JAX trainer does: the
trunk computes in bf16 from fp32 parameters (``dtype=torch.bfloat16``), the
BSR blocks are stored in bf16, the features are cast to bf16 and widened to
fp32 for the dcel head, and the smoothness term's SDDMM runs on the bf16
features.  The run writes the JAX trainer's files: ``log/<prefix>.log``,
``log/<prefix>.metrics.jsonl``, ``cfg/<prefix>.json``, and checkpoints at
``pts/<prefix>_state.pt`` every 10th epoch and at the end; with
``--deser-option auto`` (the default) or ``force`` it resumes from
``--deser-path`` or that checkpoint where the file exists (the port's ``.pt``
or the JAX package's ``.msgpack``).  Flags of the JAX trainer that later
slices bring (other trunks and losses, multihost, graph-parallel, the light
path, remat, the intrinsic Laplacian, eval-only) are refused when given.
"""

from __future__ import annotations

import argparse
import glob
import itertools
import os
import random
import sys

import numpy as np
import torch

from surfacenetworks_tpu_torch.cli.common import MetricsLogger, Throughput, dump_config, make_logger
from surfacenetworks_tpu_torch.data import Buckets, correspondence_batch, datasets, round_up
from surfacenetworks_tpu_torch.data.batching import (
    _fixed_k_operator,
    choose_operator_format,
    fit_bsr_k,
    rcm_reorder_sample,
)
from surfacenetworks_tpu_torch.models import SiameseModel, init_weights
from surfacenetworks_tpu_torch.nn.layers import at_least_fp32
from surfacenetworks_tpu_torch.serve import resolve_device
from surfacenetworks_tpu_torch.sparse import stack_operators
from surfacenetworks_tpu_torch.train import checkpoint, losses, optim

parser = argparse.ArgumentParser(description="Dense correspondence (PyTorch, one device)")
parser.add_argument("--batch-size", type=int, default=1, help="accepted and not read, as in the JAX trainer")
parser.add_argument("--datapath", default="train_FAUST_npz/")
parser.add_argument("--synthetic", type=int, default=0)
parser.add_argument("--synthetic-points", type=int, default=200)
parser.add_argument("--layer", type=int, default=15)
parser.add_argument("--loss", default="dcel", choices=["sl1", "cel", "dcel"])
parser.add_argument("--lr", default="1e-3")
parser.add_argument("--model", default="lap")
parser.add_argument("--num-epoch", type=int, default=110)
parser.add_argument("--num-updates", type=int, default=100)
parser.add_argument("--result-prefix", default="test")
parser.add_argument("--result-dir", default="results/dense_correspondence_torch")
parser.add_argument("--xz-rotate", action="store_true")
parser.add_argument("--xy-rotate", action="store_true")
parser.add_argument("--complete-test", action="store_true")
parser.add_argument("--full-train", action="store_true")
parser.add_argument("--operator-format", default="auto", choices=["auto", "ell", "bsr"],
                    help="auto: BSR over RCM-ordered vertices above 2,048 vertices, ELL below")
parser.add_argument("--streaming-head", action="store_true",
                    help="dcel loss and test metrics tile by tile, without the N x N logits "
                         "(the default at buckets of 4,096 vertices and more)")
parser.add_argument("--no-streaming-head", action="store_true",
                    help="the N x N logits head at any size")
parser.add_argument("--smooth-reg", type=float, default=0.0,
                    help="weight of the feature-smoothness term (losses.corr_feature_smoothness)")
parser.add_argument("--seed", type=int, default=17)
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
parser.add_argument("--deser-option", default="auto", choices=["auto", "no", "force"],
                    help="resume from --deser-path or the run's checkpoint where it exists (auto, force), or not (no)")
parser.add_argument("--deser-path", default=None)
parser.add_argument("--num-vertices", type=int, default=7000, help="accepted and not read, as in the JAX trainer")
parser.add_argument("--no-epoch-scan", action="store_true",
                    help="one dispatch per update in the epoch plan's order: what the port always does")
parser.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: bf16 activations and matmuls, fp32 parameters, "
                         "optimizer state and losses")
# flags of the JAX trainer that later slices bring: refused when given
parser.add_argument("--remat", action="store_true")
parser.add_argument("--intrinsic", action="store_true")
parser.add_argument("--eval-only", action="store_true")
parser.add_argument("--graph-parallel", type=int, default=0)
parser.add_argument("--multihost", action="store_true")
parser.add_argument("--coordinator-address", default=None)
parser.add_argument("--num-processes", type=int, default=None)
parser.add_argument("--process-id", type=int, default=None)
parser.add_argument("--config", default=None)
parser.add_argument("--preset", default=None)

# the JAX trainer keeps every sample's [N, N] geodesic matrix on the device
# below this estimate and takes its light path above it
DEVICE_BUDGET_BYTES = 10 << 30


def refuse_unported(args) -> None:
    """Raise on any flag whose path this slice does not port."""
    refused = {
        "--model other than lap": args.model != "lap",
        "--loss other than dcel": args.loss != "dcel",
        "--remat": args.remat,
        "--intrinsic": args.intrinsic,
        "--eval-only": args.eval_only,
        "--graph-parallel": args.graph_parallel != 0,
        "--multihost and its coordinator flags": args.multihost or any(
            v is not None for v in (args.coordinator_address, args.num_processes, args.process_id)),
        "--config and --preset": args.config is not None or args.preset is not None,
    }
    given = [k for k, v in refused.items() if v]
    if given:
        raise SystemExit(f"train_correspondence (PyTorch port): not ported yet: {', '.join(given)}")


def rot_matrix(txz: float, txy: float, device, dtype=torch.float32) -> torch.Tensor:
    """``Rxz @ Rxy``: inputs are rotated by ``V @ Rxz @ Rxy``."""
    t = torch.tensor([txz, txy], dtype=dtype, device=device)
    c1, c2 = torch.cos(t)
    s1, s2 = torch.sin(t)
    z, one = torch.zeros_like(c1), torch.ones_like(c1)
    Rxz = torch.stack([torch.stack([c1, z, s1]), torch.stack([z, one, z]), torch.stack([-s1, z, c1])])
    Rxy = torch.stack([torch.stack([c2, s2, z]), torch.stack([-s2, c2, z]), torch.stack([z, z, one])])
    return Rxz @ Rxy


def objective(model, da: dict, db: dict, rots, target, smooth_w: float, use_stream: bool,
              target_inv=None) -> torch.Tensor:
    """The training loss of one pair: dcel (streaming or over the full
    logits) plus ``smooth_w`` times both shapes' smoothness terms.
    ``target_inv`` is the target's cached inverse for the streaming head's
    backward (``losses.target_inverse``)."""
    dt = da["inputs"].dtype
    inx = da["inputs"] @ rot_matrix(rots[0], rots[1], target.device, dt)
    iny = db["inputs"] @ rot_matrix(rots[2], rots[3], target.device, dt)
    fa, fb = model.features((da["op"], da["mask"]), (db["op"], db["mask"]), inx, iny)
    # the dcel head in fp32 whatever the features' dtype (bf16 under --bf16)
    fa32, fb32 = at_least_fp32(fa), at_least_fp32(fb)
    if use_stream:
        loss = losses.corr_dcel_streaming(fa32[0], fb32[0], target, target_inv=target_inv)
    else:
        loss = losses.corr_delta_cross_entropy_from_target(torch.einsum("bnc,bmc->bnm", fa32, fb32)[0], target)
    if smooth_w > 0:
        loss = loss + smooth_w * (
            losses.corr_feature_smoothness(da["reg_op"], fa) + losses.corr_feature_smoothness(db["reg_op"], fb)
        )
    return loss


def train_step(model, opt, da: dict, db: dict, rots, target, smooth_w: float, use_stream: bool,
               target_inv=None) -> torch.Tensor:
    """One update; returns the loss (on the device).  The gradients stay in
    each parameter's ``.grad`` until the next step."""
    opt.zero_grad(set_to_none=True)
    loss = objective(model, da, db, rots, target, smooth_w, use_stream, target_inv)
    loss.backward()
    opt.step()
    return loss.detach()


class CorrespondenceTrainer:
    """Data, model, optimizer and the device caches of one training run;
    ``data`` (FAUST-like sample dicts) replaces the scans the flags name."""

    def __init__(self, args, log=print, data: list | None = None):
        refuse_unported(args)
        self.args, self.log = args, log
        self.device = resolve_device(args.device)
        # fp32 matmuls and convolutions in full fp32 (no TF32), and bf16 ones
        # (--bf16) summed in fp32 throughout, as XLA sums them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.dtype = torch.bfloat16 if args.bf16 else None
        self.rng = np.random.default_rng(args.seed)
        if data is not None:
            data = list(data)
        elif args.synthetic:
            data = datasets.synthetic_correspondence_dataset(
                args.synthetic, n_points=args.synthetic_points, seed=args.seed)
        else:
            files = sorted(glob.glob(os.path.join(args.datapath, "*.npz")))
            if not files:
                raise SystemExit(f"no .npz files under {args.datapath}")
            data = [datasets.load_faust_npz(f) for f in files]
        self.n_train = len(data) if args.full_train else max(len(data) * 8 // 10, 1)
        if args.operator_format == "auto":
            nv_max = max(s["V"].shape[0] for s in data)
            resolved = choose_operator_format(1, round_up(nv_max, 8), rcm_ok=True)
            self.fmt = "bsr" if resolved == "bsr" else "ell"
            log(f"operator format auto -> {self.fmt}")
        else:
            self.fmt = args.operator_format
        if self.fmt == "bsr":
            data = [rcm_reorder_sample(s) for s in data]
        self.data = data
        self.buckets = Buckets.for_samples(data, multiple=128 if self.fmt == "bsr" else 8)
        if self.fmt == "bsr":
            fit_bsr_k([s["L"] for s in data], self.buckets)
        self.N = self.buckets.n_vertices
        est_bytes = len(data) * (self.N * self.N * 4 + 40 * self.N * 4)
        if est_bytes >= DEVICE_BUDGET_BYTES:
            raise SystemExit(f"the light path (geodesic matrices of {est_bytes / 1e9:.1f} GB kept on the host) "
                             "is not ported yet")
        # the JAX trainer rotates the batch it initialises with, which draws
        # once per rotation axis before the first epoch
        self.angles()

        self.model = SiameseModel("lap", args.layer, self.dtype)
        init_weights(self.model, torch.Generator().manual_seed(0))
        self.model.to(self.device)
        self.opt = optim.adam(self.model.parameters(), float(args.lr), weight_decay=1e-5)
        log(f"Num parameters {sum(p.numel() for p in self.model.parameters())}")
        self.step = 0  # updates taken (the JAX trainer's TrainState.step)
        self.use_stream = bool(args.streaming_head) or (not args.no_streaming_head and self.N >= 4096)
        if self.use_stream and not args.streaming_head:
            log("streaming head ON by default (bucket >= 4096 vertices; --no-streaming-head opts out)")
        self.smooth_w = float(args.smooth_reg)
        self._dev: dict[int, dict] = {}
        self._targets: dict[tuple[int, int], torch.Tensor] = {}
        self._inverses: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def angles(self) -> tuple[float, float]:
        a = self.args
        return (
            float(np.float32(self.rng.uniform(0, 2 * np.pi))) if a.xz_rotate else 0.0,
            float(np.float32(self.rng.uniform(0, 2 * np.pi))) if a.xy_rotate else 0.0,
        )

    def dev_sample(self, i: int) -> dict:
        """Sample ``i``'s operator, mask, inputs, padded geodesic matrix and
        label tables (and the smoothness pattern) on the device, built once."""
        hit = self._dev.get(i)
        if hit is not None:
            return hit
        sample, N, dev = self.data[i], self.N, self.device
        pack = correspondence_batch(sample, self.buckets, fmt=self.fmt, op_dtype=self.dtype)
        G, lab, li = pack.targets
        G_pad = np.zeros((N, N), np.float32)
        G_pad[: G.shape[0], : G.shape[1]] = G
        lab_pad, li_pad = np.zeros(N, np.int64), np.zeros(N, np.int64)
        lab_pad[: lab.shape[0]] = lab
        li_pad[: li.shape[0]] = li
        reg = None
        if self.smooth_w > 0:
            # the smoothness pattern is the fixed-k ELL operator, whatever
            # format the trunk runs (in ELL it is the trunk's own operator);
            # its transpose map, for the SDDMM's backward, is built here
            reg = pack.operator if self.fmt == "ell" else stack_operators(
                [_fixed_k_operator(sample["L"], self.buckets, N)])
            reg.transpose_map()
        entry = {
            "op": pack.operator.to(dev),
            "mask": pack.mask.to(dev),
            "inputs": pack.inputs.to(dev),
            "G": torch.from_numpy(G_pad).to(dev),
            "l": torch.from_numpy(lab_pad).to(dev),
            "li": torch.from_numpy(li_pad).to(dev),
            "n": sample["V"].shape[0],
        }
        if reg is not None:
            entry["reg_op"] = entry["op"] if reg is pack.operator else reg.to(dev)
        self._dev[i] = entry
        return entry

    def aggregate_padded(self, da: dict, db: dict) -> torch.Tensor:
        """The pair's cost ``[N, N]``: the aggregated geodesic cost on the
        valid block, 0 on rows past A's vertices and 1e9 on columns past
        B's (so argmin ignores padded columns)."""
        agg = losses.aggregate_G(da["G"], da["l"], da["li"], db["G"], db["l"], db["li"])
        r = torch.arange(self.N, device=agg.device)
        valid = (r[:, None] < da["n"]) & (r[None, :] < db["n"])
        GAB = torch.where(valid, agg, torch.zeros_like(agg))
        return torch.where(r[None, :] >= db["n"], torch.full_like(GAB, 1e9), GAB)

    def pair_target(self, ia: int, ib: int) -> torch.Tensor:
        """The pair's dcel target, argmin of its cost: fixed per pair, so
        computed once and cached on the device."""
        t = self._targets.get((ia, ib))
        if t is None:
            t = torch.argmin(self.aggregate_padded(self.dev_sample(ia), self.dev_sample(ib)), dim=-1)
            self._targets[(ia, ib)] = t
        return t

    def pair_inverse(self, ia: int, ib: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The inverse of the pair's target (``losses.target_inverse``),
        built once on the host and cached on the device: the streaming
        head's backward sums ``fa`` by target through it in a fixed order.
        Its width is the target's largest multiplicity."""
        inv = self._inverses.get((ia, ib))
        if inv is None:
            inv = losses.target_inverse(self.pair_target(ia, ib), self.N)
            self._inverses[(ia, ib)] = inv
        return inv

    def epoch_plan(self) -> tuple[np.ndarray, np.ndarray]:
        """The epoch's pair indices and rotation angles, in the JAX
        trainer's draw order."""
        n = self.args.num_updates
        pair_idx = np.zeros((n, 2), np.int32)
        rots = np.zeros((n, 4), np.float32)
        for u in range(n):
            pair_idx[u] = self.rng.integers(0, self.n_train, size=2)
            rots[u] = self.angles() + self.angles()
        return pair_idx, rots

    def update(self, ia: int, ib: int, rots) -> torch.Tensor:
        inv = self.pair_inverse(ia, ib) if self.use_stream else None
        loss = train_step(self.model, self.opt, self.dev_sample(ia), self.dev_sample(ib),
                          [float(r) for r in rots], self.pair_target(ia, ib), self.smooth_w, self.use_stream, inv)
        self.step += 1
        return loss

    def train_epoch(self, epoch: int, metrics_log: MetricsLogger | None = None) -> float:
        pair_idx, rots = self.epoch_plan()
        meter = Throughput()
        total = torch.zeros((), device=self.device)
        for (ia, ib), r in zip(pair_idx, rots):
            total += self.update(int(ia), int(ib), r)
            meter.tick()
        mean = float(total) / len(pair_idx)
        self.log(f"Train epoch {epoch}, loss {mean}, {meter.report()}")
        if metrics_log is not None:
            metrics_log.write(epoch, "train", loss=mean, steps_per_s=meter.steps_per_s)
        return mean

    @torch.no_grad()
    def eval_pair(self, ia: int, ib: int, rots) -> tuple[torch.Tensor, dict]:
        """Loss and FAUST metrics of one pair (B's columns masked)."""
        da, db = self.dev_sample(ia), self.dev_sample(ib)
        inx = da["inputs"] @ rot_matrix(rots[0], rots[1], self.device)
        iny = db["inputs"] @ rot_matrix(rots[2], rots[3], self.device)
        GAB = self.aggregate_padded(da, db)
        fa, fb = self.model.features((da["op"], da["mask"]), (db["op"], db["mask"]), inx, iny)
        fa, fb = at_least_fp32(fa), at_least_fp32(fb)
        if self.use_stream:
            pred = losses.streaming_corr_argmax(fa[0], fb[0], db["mask"][0, :, 0])
            metrics = losses.corr_metrics_from_pred(pred, da["l"], db["l"], db["li"], db["G"], da["mask"][0, :, 0])
            return losses.corr_dcel_streaming(fa[0], fb[0], torch.argmin(GAB, dim=-1)), metrics
        logits = torch.einsum("bnc,bmc->bnm", fa, fb)[0]
        metrics = losses.corr_accuracy_metrics(logits, da["l"], db["l"], db["li"], db["G"],
                                               da["mask"][0, :, 0], db["mask"][0, :, 0])
        return losses.corr_delta_cross_entropy(logits, GAB), metrics

    def test_pass(self, epoch: int, metrics_log: MetricsLogger | None = None) -> dict | None:
        """Mean loss and metrics over the test pairs (20 drawn ones unless
        ``--complete-test``); None without test samples."""
        test_ids = list(range(self.n_train, len(self.data)))
        if not test_ids:
            return None
        pairs = list(itertools.product(test_ids, repeat=2))
        if not self.args.complete_test:
            pairs = random.Random(epoch).choices(pairs, k=min(20, len(pairs)))
        sums: dict[str, float] = {}
        for i, j in pairs:
            loss, metrics = self.eval_pair(i, j, self.angles() + self.angles())
            for k, v in {"loss": loss, **metrics}.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        mean = {k: v / len(pairs) for k, v in sums.items()}
        mstr = " ".join(f"{k} {mean[k]:.4f}" for k in sorted(mean) if k != "loss")
        self.log(f"Test epoch {epoch}, loss {mean['loss']}, {mstr}")
        if metrics_log is not None:
            metrics_log.write(epoch, "test", **mean)
        return mean

    def save(self, path: str, epoch: int) -> None:
        checkpoint.save_checkpoint(path, self.model, self.opt, epoch, self.step)


def main(argv=None) -> dict:
    """Train; returns each epoch's mean train loss and test results."""
    args = parser.parse_args(argv)
    log_dir = os.path.join(args.result_dir, "log")
    log = make_logger(args.result_prefix, log_dir)
    log(args)
    dump_config(args, os.path.join(args.result_dir, "cfg", f"{args.result_prefix}.json"))
    trainer = CorrespondenceTrainer(args, log)
    ckpt_path = os.path.join(args.result_dir, "pts", f"{args.result_prefix}_state.pt")
    if args.deser_option != "no":
        path = args.deser_path or ckpt_path
        if os.path.isfile(path):
            log("Continue...")
            _, trainer.step, _ = checkpoint.restore_training(path, trainer.model, trainer.opt)
    metrics_log = MetricsLogger(args.result_prefix, log_dir)
    history: dict = {"train_loss": [], "test": []}
    for epoch in range(args.num_epoch):
        history["train_loss"].append(trainer.train_epoch(epoch, metrics_log))
        history["test"].append(trainer.test_pass(epoch, metrics_log))
        if epoch % 10 == 9:
            trainer.save(ckpt_path, epoch)
    trainer.save(ckpt_path, args.num_epoch - 1)
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
