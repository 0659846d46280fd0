"""FAUST dense-correspondence siamese trainer on one device (counterpart of
``surfacenetworks_tpu/cli/train_correspondence.py``: its single-device
paths).

Two shapes per step through a shared trunk (``--model lap|amp|avg|mlp|dir``,
``models.correspondence.TRUNKS``); the loss (``--loss``) is dcel against the
per-pair argmin of the aggregated geodesic cost, with the streaming head by
default at buckets of 4,096 vertices and more, or sl1 / cel over the full
logits against the padded cost; optional random XZ/XY rotation augmentation
and the ``--smooth-reg`` feature-smoothness term (the SDDMM consumer, on the
fixed-K ELL pattern of ``L`` whatever the trunk).  Runs on ``cuda`` unless
given ``--device cpu``::

    python -m surfacenetworks_tpu_torch.cli.train_correspondence \\
        --synthetic 4 --synthetic-points 7000 --smooth-reg 0.1 --xz-rotate
    python -m surfacenetworks_tpu_torch.cli.train_correspondence \\
        --datapath tests/fixtures/faust --device cpu --layer 2 --num-updates 2 --model amp

The operator key follows the JAX trainer: ``"dir"`` in ``--model`` packs
the Dirac tables, ``"amp"`` the squared-Laplacian pyramid (every level at
the pyramid's widest row), anything else ``L`` (``--intrinsic``: the
intrinsic Delaunay Laplacian); ``auto`` takes BSR over RCM order above
2,048 vertices for that last key only (so the avg and mlp trunks, which
read no operator, train on RCM-ordered vertices there too).  Each sample's
operator, mask, unrotated inputs, padded geodesic matrix and label tables
go to the device once; each (shape A, shape B) pair's dcel target is
computed once on the device and cached, with its inverse (built on the
host) for the streaming head's backward.  Past ``DEVICE_BUDGET_BYTES`` of
geodesic matrices (or with ``_FORCE_LIGHT``) dcel takes the light path: no
geodesic matrix goes to the device, each pair's target is a chunked argmin
on the host (``host_pair_target``), and the per-epoch test pass is
skipped; sl1 and cel, which read the whole cost every step, are refused
there.  ``--eval-only`` restores the checkpoint and reports the FAUST
metrics over the test pairs (every pair when there are none) from a
streaming argmax on the device, computed on the host (``host_corr_metrics``).
Updates run one per step in the order of the epoch plan (the JAX trainer's
``--no-epoch-scan`` order).  ``--remat`` recomputes the lap trunk's blocks
in the backward.  ``--bf16`` trains in mixed precision as the JAX trainer
does: the trunk computes in bf16 from fp32 parameters
(``dtype=torch.bfloat16``), the BSR blocks are stored in bf16, the
features are cast to bf16 and widened to fp32 for the heads, and the
smoothness term's SDDMM runs on the bf16 features.  The run writes the JAX
trainer's files: ``log/<prefix>.log``, ``log/<prefix>.metrics.jsonl``,
``cfg/<prefix>.json``, and checkpoints at ``pts/<prefix>_state.pt`` every
10th epoch and at the end; with ``--deser-option auto`` (the default) or
``force`` it resumes from ``--deser-path`` or that checkpoint where the
file exists (the port's ``.pt`` or the JAX package's ``.msgpack``).  The
multi-device flags (``--graph-parallel``, ``--multihost`` and its
coordinator flags) and ``--config``/``--preset`` are refused.
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
from surfacenetworks_tpu_torch.geometry import graph_ops, intrinsic
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
parser.add_argument("--model", default="lap", help="lap | dir | avg | mlp | amp")
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
parser.add_argument("--remat", action="store_true",
                    help="recompute the lap trunk's blocks in the backward (memory for compute)")
parser.add_argument("--intrinsic", action="store_true",
                    help="the intrinsic-Delaunay Laplacian (lap operator key only)")
parser.add_argument("--eval-only", action="store_true",
                    help="no training: restore the checkpoint and report FAUST metrics over the test pairs, "
                         "computed on the host")
# flags of the JAX trainer's multi-device paths and its config presets: refused when given
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

LOSSES = {
    "sl1": losses.corr_smooth_l1,
    "cel": losses.corr_softmin_cross_entropy,
    "dcel": losses.corr_delta_cross_entropy,
}

# test hook: the light path (host-computed dcel targets) whatever the size
_FORCE_LIGHT = False


def refuse_unported(args) -> None:
    """Raise on any flag whose path the port does not have: the multi-device
    paths and the config presets.  (sl1 and cel past the device budget, the
    JAX trainer's host path, are refused once the budget is known.)"""
    refused = {
        "--graph-parallel": args.graph_parallel != 0,
        "--multihost and its coordinator flags": args.multihost or any(
            v is not None for v in (args.coordinator_address, args.num_processes, args.process_id)),
        "--config and --preset": args.config is not None or args.preset is not None,
    }
    given = [k for k, v in refused.items() if v]
    if given:
        raise SystemExit(f"train_correspondence (PyTorch port): not ported yet: {', '.join(given)}")


def model_key_of(model: str) -> str:
    """The operator a ``--model`` reads, as the JAX trainer picks it:
    ``"dirac"`` where it names ``dir``, ``"amp"`` where it names ``amp``,
    else ``"lap"``."""
    return "dirac" if "dir" in model else ("amp" if "amp" in model else "lap")


def host_pair_target(sa: dict, sb: dict, N: int) -> np.ndarray:
    """The light path's dcel target of a pair on the host: the argmin of
    ``GA[:, liA[lB]] + GB[liB[lA], :]`` over B's columns, in row blocks of
    about 128 MB, so the ``[N, N]`` cost is never formed.  Rows past A's
    vertices keep target 0, as the padded device cost gives them (0 on B's
    columns, 1e9 past them); ``np.argmin`` takes the first minimum, as
    ``torch.argmin`` does, so the targets are the device path's."""
    GA = np.asarray(sa["G"], np.float32)
    GB = np.asarray(sb["G"], np.float32)
    lA, liA = np.asarray(sa["label"]), np.asarray(sa["label_inv"])
    lB, liB = np.asarray(sb["label"]), np.asarray(sb["label_inv"])
    na, nb = GA.shape[0], GB.shape[0]
    cols, rows = liA[lB], liB[lA]
    target = np.zeros(N, np.int64)
    chunk = max(1, (128 << 20) // max(nb * 4, 1))
    for i0 in range(0, na, chunk):
        i1 = min(i0 + chunk, na)
        target[i0:i1] = np.argmin(GA[i0:i1][:, cols] + GB[rows[i0:i1], :], axis=1)
    return target


def host_corr_metrics(pred: np.ndarray, sa: dict, sb: dict) -> dict:
    """``--eval-only``'s FAUST metrics of predictions ``pred`` (vertices of
    B, padded) on the host: the share of A's vertices whose prediction
    carries A's label, and the mean and quartiles (``np.quantile``, linear)
    of the distance on B from the prediction to the true correspondent."""
    lA, lB, liB = np.asarray(sa["label"]), np.asarray(sb["label"]), np.asarray(sb["label_inv"])
    GB = np.asarray(sb["G"], np.float32)
    p = np.asarray(pred)[: lA.shape[0]]
    geo = GB[liB[lA], p]
    return {
        "exact": float((lB[p] == lA).mean()),
        "geo_mean": float(geo.mean()),
        "geo_q25": float(np.quantile(geo, 0.25)),
        "geo_q50": float(np.quantile(geo, 0.50)),
        "geo_q75": float(np.quantile(geo, 0.75)),
    }


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
              target_inv=None, loss_fn=None, GAB=None) -> torch.Tensor:
    """The training loss of one pair: dcel against ``target`` (streaming or
    over the full logits), or, given the pair's padded cost ``GAB``,
    ``loss_fn(logits, GAB)`` over the full logits (sl1, cel); plus
    ``smooth_w`` times both shapes' smoothness terms.  ``target_inv`` is the
    target's cached inverse for the streaming head's backward
    (``losses.target_inverse``)."""
    dt, dev = da["inputs"].dtype, da["inputs"].device
    inx = da["inputs"] @ rot_matrix(rots[0], rots[1], dev, dt)
    iny = db["inputs"] @ rot_matrix(rots[2], rots[3], dev, dt)
    fa, fb = model.features((da["op"], da["mask"]), (db["op"], db["mask"]), inx, iny)
    # the dcel head in fp32 whatever the features' dtype (bf16 under --bf16)
    fa32, fb32 = at_least_fp32(fa), at_least_fp32(fb)
    if use_stream:
        loss = losses.corr_dcel_streaming(fa32[0], fb32[0], target, target_inv=target_inv)
    else:
        logits = torch.einsum("bnc,bmc->bnm", fa32, fb32)[0]
        loss = losses.corr_delta_cross_entropy_from_target(logits, target) if GAB is None else loss_fn(logits, GAB)
    if smooth_w > 0:
        loss = loss + smooth_w * (
            losses.corr_feature_smoothness(da["reg_op"], fa) + losses.corr_feature_smoothness(db["reg_op"], fb)
        )
    return loss


def train_step(model, opt, da: dict, db: dict, rots, target, smooth_w: float, use_stream: bool,
               target_inv=None, loss_fn=None, GAB=None) -> torch.Tensor:
    """One update (``objective``'s arguments); returns the loss (on the
    device).  The gradients stay in each parameter's ``.grad`` until the
    next step."""
    opt.zero_grad(set_to_none=True)
    loss = objective(model, da, db, rots, target, smooth_w, use_stream, target_inv, loss_fn, GAB)
    loss.backward()
    opt.step()
    return loss.detach()


class CorrespondenceTrainer:
    """Data, model, optimizer and the device caches of one training run;
    ``data`` (FAUST-like sample dicts) replaces the scans the flags name
    (they are copied where the run changes them: ``--intrinsic``, the amp
    pyramid, RCM order)."""

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
        self.model_key = model_key_of(args.model)
        if args.intrinsic and self.model_key == "lap":
            data = [dict(s, L=intrinsic.intrinsic_laplacian(s["V"], s["F"])) for s in data]
        if self.model_key == "amp":
            data = [dict(s, L_pyr=graph_ops.amp_pyramid(s["L"], levels=3)) for s in data]
        fmt = args.operator_format
        if fmt == "auto":
            nv_max = max(s["V"].shape[0] for s in data)
            resolved = choose_operator_format(1, round_up(nv_max, 8), rcm_ok=self.model_key == "lap")
            fmt = "bsr" if resolved == "bsr" else "ell"
            log(f"operator format auto -> {fmt}")
        # BSR under the lap key only; the other keys pack their own operators
        self.fmt = "bsr" if fmt == "bsr" and self.model_key == "lap" else "ell"
        if self.fmt == "bsr":
            data = [rcm_reorder_sample(s) for s in data]
        self.data = data
        self.buckets = Buckets.for_samples(data, multiple=128 if self.fmt == "bsr" else 8)
        if self.model_key == "amp":
            # every pyramid level, and the smoothness pattern, at the widest row of any level
            kmax = max(int(np.diff(Lk.tocsr().indptr).max()) for s in data for Lk in s["L_pyr"])
            self.buckets.ell_k = self.buckets.ell_k_t = max(self.buckets.ell_k, kmax)
        if self.fmt == "bsr":
            fit_bsr_k([s["L"] for s in data], self.buckets)
        self.N = self.buckets.n_vertices
        est_bytes = len(data) * (self.N * self.N * 4 + 40 * self.N * 4)
        fits = est_bytes < DEVICE_BUDGET_BYTES
        if not fits and args.loss != "dcel":
            if args.eval_only:
                raise SystemExit("--eval-only needs the single-device fast path")
            raise SystemExit(f"train_correspondence (PyTorch port): not ported yet: --loss {args.loss} with "
                             f"geodesic matrices of {est_bytes / 1e9:.1f} GB past the device budget (the JAX "
                             "trainer's host path)")
        self.light = args.loss == "dcel" and (not fits or _FORCE_LIGHT)
        if self.light:
            log(f"light fast path: geodesic matrices stay on host (est {est_bytes / 1e9:.1f} GB > HBM budget); "
                "dcel targets computed host-side per pair and cached on device")
        # the JAX trainer rotates the batch it initialises with, which draws
        # once per rotation axis before the first epoch
        self.angles()

        self.model = SiameseModel(args.model, args.layer, self.dtype, remat=args.remat)
        init_weights(self.model, torch.Generator().manual_seed(0))
        self.model.to(self.device)
        self.opt = optim.adam(self.model.parameters(), float(args.lr), weight_decay=1e-5)
        log(f"Num parameters {sum(p.numel() for p in self.model.parameters())}")
        self.step = 0  # updates taken (the JAX trainer's TrainState.step)
        self.loss_fn = LOSSES[args.loss]
        if args.streaming_head and args.loss != "dcel":
            raise SystemExit("--streaming-head supports --loss dcel only")
        self.use_stream = bool(args.streaming_head) or (
            not args.no_streaming_head and args.loss == "dcel" and self.N >= 4096)
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
        label tables (none of those three on the light path) and the
        smoothness pattern on the device, built once."""
        hit = self._dev.get(i)
        if hit is not None:
            return hit
        sample, N, dev = self.data[i], self.N, self.device
        pack = correspondence_batch(sample, self.buckets, fmt=self.fmt, op_dtype=self.dtype, model=self.model_key)
        entry = {"op": pack.operator.to(dev) if not isinstance(pack.operator, list)
                 else [o.to(dev) for o in pack.operator],
                 "mask": pack.mask.to(dev), "inputs": pack.inputs.to(dev), "n": sample["V"].shape[0]}
        if not self.light:
            G, lab, li = pack.targets
            G_pad = np.zeros((N, N), np.float32)
            G_pad[: G.shape[0], : G.shape[1]] = G
            lab_pad, li_pad = np.zeros(N, np.int64), np.zeros(N, np.int64)
            lab_pad[: lab.shape[0]] = lab
            li_pad[: li.shape[0]] = li
            entry.update(G=torch.from_numpy(G_pad).to(dev), l=torch.from_numpy(lab_pad).to(dev),
                         li=torch.from_numpy(li_pad).to(dev))
        if self.smooth_w > 0:
            # the smoothness pattern is the fixed-k ELL operator of L, whatever
            # the trunk reads (under the lap key in ELL it is the trunk's own
            # operator); its transpose map, for the SDDMM's backward, is built here
            own = self.model_key == "lap" and self.fmt == "ell"
            reg = pack.operator if own else stack_operators([_fixed_k_operator(sample["L"], self.buckets, N)])
            reg.transpose_map()
            entry["reg_op"] = entry["op"] if own else reg.to(dev)
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
        """The pair's dcel target, argmin of its cost (on the light path on
        the host, ``host_pair_target``): fixed per pair, so computed once
        and cached on the device."""
        t = self._targets.get((ia, ib))
        if t is None:
            if self.light:
                t = torch.from_numpy(host_pair_target(self.data[ia], self.data[ib], self.N)).to(self.device)
            else:
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
        """One update on pair ``(ia, ib)``: dcel against the pair's cached
        target, or sl1 / cel against its padded cost, aggregated anew."""
        da, db = self.dev_sample(ia), self.dev_sample(ib)
        inv = self.pair_inverse(ia, ib) if self.use_stream else None
        if self.args.loss == "dcel":
            target, GAB = self.pair_target(ia, ib), None
        else:
            target, GAB = None, self.aggregate_padded(da, db)
        loss = train_step(self.model, self.opt, da, db, [float(r) for r in rots], target, self.smooth_w,
                          self.use_stream, inv, self.loss_fn, GAB)
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
        """Loss (dcel on the streaming head, else ``--loss``) and FAUST
        metrics of one pair (B's columns masked)."""
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
        return self.loss_fn(logits, GAB), metrics

    def test_pass(self, epoch: int, metrics_log: MetricsLogger | None = None) -> dict | None:
        """Mean loss and metrics over the test pairs (20 drawn ones unless
        ``--complete-test``); None without test samples, and on the light
        path, which has no geodesic matrix on the device."""
        test_ids = list(range(self.n_train, len(self.data)))
        if test_ids and self.light:
            if epoch == 0:
                self.log("light fast path: per-epoch eval skipped — the [N, N] geodesic aggregation exceeds "
                         "device memory at this scale; train with --full-train and evaluate offline from the "
                         "checkpoint")
            return None
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

    @torch.no_grad()
    def predict(self, ia: int, ib: int) -> torch.Tensor:
        """``--eval-only``'s predictions for pair ``(ia, ib)``: the
        streaming argmax of the unrotated shapes' features over B's
        vertices, on the device."""
        da, db = self.dev_sample(ia), self.dev_sample(ib)
        fa, fb = self.model.features((da["op"], da["mask"]), (db["op"], db["mask"]), da["inputs"], db["inputs"])
        return losses.streaming_corr_argmax(at_least_fp32(fa)[0], at_least_fp32(fb)[0], db["mask"][0, :, 0])

    def eval_only(self) -> dict:
        """``--eval-only``: the mean of ``host_corr_metrics`` over every
        ordered pair of the test scans (of all scans when there are none),
        logged as the JAX trainer logs it."""
        eval_ids = list(range(self.n_train, len(self.data))) or list(range(len(self.data)))
        pairs = list(itertools.product(eval_ids, repeat=2))
        msum: dict[str, float] = {}
        for i, j in pairs:
            pred = self.predict(i, j).cpu().numpy()
            for k, v in host_corr_metrics(pred, self.data[i], self.data[j]).items():
                msum[k] = msum.get(k, 0.0) + v
        mean = {k: v / len(pairs) for k, v in msum.items()}
        self.log(f"Eval-only over {len(pairs)} pairs: " + " ".join(f"{k} {mean[k]:.4f}" for k in sorted(mean)))
        return mean

    def save(self, path: str, epoch: int) -> None:
        checkpoint.save_checkpoint(path, self.model, self.opt, epoch, self.step)


def main(argv=None) -> dict:
    """Train; returns each epoch's mean train loss and test results (with
    ``--eval-only``, ``{"eval": metrics}`` and no training)."""
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
    if args.eval_only:
        return {"eval": trainer.eval_only()}
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
