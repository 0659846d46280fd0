"""FAUST dense-correspondence siamese trainer (counterpart of
``surfacenetworks_tpu/cli/train_correspondence.py``).

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
skipped.  sl1 and cel, which read the whole cost every step, take the JAX
trainer's host path there: a prefetch thread draws each update's pair and
rotations, rotates both shapes' inputs on the host (``rotate_host``) and
builds the pair's padded ``[N, N]`` cost (``losses.aggregate_G``,
``pad_cost``) in pinned memory, which the step uploads without blocking;
the test pass assembles each pair the same way, with B's padded geodesic
matrix.  ``--smooth-reg`` and ``--eval-only`` exit there, as in the JAX
trainer.  ``--eval-only`` restores the checkpoint and reports the FAUST
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
file exists (the port's ``.pt`` or the JAX package's ``.msgpack``).
``--config``/``--preset`` layer a JSON file or a named preset under the
flags (``config.py``).

``--graph-parallel G`` (G > 1; the ``lap`` key, whose trunks are lap, avg
and mlp, and the ``dir`` trunk, as in the JAX trainer) starts G ranks that
row-partition both shapes of every pair: the scans RCM-ordered (``dir``:
the faces sorted by their smallest vertex, the coefficients recomputed),
the bucket rounded to ``8 G`` rows (``128 G`` with ``--operator-format
bsr``, which then packs the partitions' interiors as BSR), each scan's
operator partitioned once at its own halo.  A rank holds its rows of both
shapes' features and gathers the second shape's whole
(``parallel_context.gather_rows``, whose backward sums every rank's
cotangent back to the owner rows), so its logits are its rows of ``FA
FB^T``; the loss is this rank's rows' share of the global loss (the streaming
head tiles the rank's rows only).  dcel takes the fast path with each
pair's target computed on the host and cached; sl1 and cel take the host
path, as in the JAX trainer.  The test pass and ``--eval-only`` gather both
shapes' features and score them whole on every rank.  ``--smooth-reg``
is refused under ``--graph-parallel`` with the JAX trainer's message.

``--multihost`` (the coordinator flags, or torchrun's environment) starts
this launch's share of the graph axis's ranks, which meet the other
launches' at the coordinator (``cli.common.run_grid``); without
``--graph-parallel`` every process trains a replica and process 0 writes.
As in the JAX trainer, whose fast path needs one process, every loss then
takes the host path, dcel included (its target the argmin of the uploaded
cost, the light path off): each process assembles the same pairs from the
shared seed.  ``--smooth-reg`` and ``--eval-only`` are refused there with
the JAX trainer's messages.  After each epoch rank 0 redraws
``log/<prefix>_curves.png`` (``MetricsLogger.plot``).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import itertools
import os
import random
import sys

import numpy as np
import torch

from surfacenetworks_tpu_torch import config, native, parallel_context
from surfacenetworks_tpu_torch.cli.common import (
    MetricFetcher,
    MetricsLogger,
    Throughput,
    count_params,
    dump_config,
    log_environment,
    log_multihost,
    make_logger,
    process_index,
    run_grid,
)
from surfacenetworks_tpu_torch.data import Buckets, correspondence_batch, datasets, round_up
from surfacenetworks_tpu_torch.data.batching import (
    _fixed_k_operator,
    choose_operator_format,
    fit_bsr_k,
    rcm_reorder_sample,
)
from surfacenetworks_tpu_torch.data.pipeline import Uploads, prefetch
from surfacenetworks_tpu_torch.dist import data_parallel, dirac_partition, edge_partition, graph_parallel, mesh_setup
from surfacenetworks_tpu_torch.geometry import graph_ops, intrinsic
from surfacenetworks_tpu_torch.models import SiameseModel, init_weights
from surfacenetworks_tpu_torch.nn.layers import at_least_fp32
from surfacenetworks_tpu_torch.serve import resolve_device
from surfacenetworks_tpu_torch.sparse import stack_operators
from surfacenetworks_tpu_torch.train import checkpoint, loop, losses, optim

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
config.add_config_flags(parser)
parser.add_argument("--graph-parallel", type=int, default=0,
                    help="row-partition both shapes over this many ranks (lap and dir trunks; 0 or 1: off)")
parser.add_argument("--multihost", action="store_true",
                    help="spread the graph axis's ranks over --num-processes launches met at the coordinator (or "
                         "torchrun's environment)")
parser.add_argument("--coordinator-address", default=None, help="host:port of process 0's rendezvous")
parser.add_argument("--num-processes", type=int, default=None)
parser.add_argument("--process-id", type=int, default=None)

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


# each loss over a rank's rows of the logits times (1 / G) ** ROW_SHARE_POWER is its share of the global
# loss: dcel is a mean over the N rows, sl1 an element mean over N x N divided by N, cel a sum
ROW_SHARE_POWER = {"dcel": 1, "sl1": 2, "cel": 0}


SMOOTH_REG_FAST_PATH = "--smooth-reg requires the single-device fast path (no --graph-parallel / --multihost)"


def refuse_unported(args) -> None:
    """Raise, with the JAX trainer's messages, on what it refuses under
    ``--graph-parallel`` (0 and 1 mean off) and ``--multihost``: a trunk
    other than the lap key's and dir, and ``--smooth-reg`` off the
    single-device fast path."""
    if mesh_setup.axis_ranks(args.graph_parallel) > 1:
        if model_key_of(args.model) not in ("lap", "dirac"):
            raise SystemExit("--graph-parallel supports the lap and dir trunks")
        if args.smooth_reg > 0:
            raise SystemExit(SMOOTH_REG_FAST_PATH)
    if args.multihost and args.smooth_reg > 0:
        raise SystemExit(SMOOTH_REG_FAST_PATH)


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


def rotate_host(V: np.ndarray, rng: np.random.Generator, xz: bool, xy: bool) -> np.ndarray:
    """The host path's rotation of one shape's fp32 inputs (the JAX
    trainer's ``_rotate``): an XZ rotation, then an XY one, each by an
    angle drawn from ``rng`` when its flag is set, in fp32."""
    if xz:
        t = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]], np.float32)
        V = V @ R
    if xy:
        t = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(t), np.sin(t), 0], [-np.sin(t), np.cos(t), 0], [0, 0, 1]], np.float32)
        V = V @ R
    return V


def pad_cost(agg: torch.Tensor, N: int, pin: bool = False) -> torch.Tensor:
    """The pair's ``[N, N]`` cost as the JAX trainer's host path pads it
    (``assemble_pair``): ``agg`` on its block, 0 below it, 1e9 on every
    column past B's vertices (so the losses ignore them); in pinned memory
    with ``pin``."""
    na, nb = agg.shape
    out = torch.zeros((N, N), dtype=torch.float32, pin_memory=pin)
    out[:na, :nb] = agg
    out[:, nb:] = 1e9
    return out


def _upload_tree(item: dict, device, non_blocking: bool) -> dict:
    return {k: v.to(device, non_blocking=non_blocking) if isinstance(v, torch.Tensor) else v for k, v in item.items()}


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
              target_inv=None, loss_fn=None, GAB=None, mesh: mesh_setup.Mesh | None = None,
              loss_name: str = "dcel") -> torch.Tensor:
    """The training loss of one pair: dcel against ``target`` (streaming or
    over the full logits), or, given the pair's padded cost ``GAB``,
    ``loss_fn(logits, GAB)`` over the full logits (sl1, cel, and dcel on the
    host path; the streaming head then takes the argmin of ``GAB`` as its
    target, as the JAX trainer's host step does); plus
    ``smooth_w`` times both shapes' smoothness terms.  ``target_inv`` is the
    target's cached inverse for the streaming head's backward
    (``losses.target_inverse``).  With ``rots`` None the inputs are taken as
    they are (the host path rotates them on the host).  With a
    graph-parallel ``mesh`` the shapes, ``target`` and ``GAB`` are this
    rank's rows: the second shape's features are gathered whole and the
    loss is this rank's share of ``loss_name``'s global loss."""
    dt, dev = da["inputs"].dtype, da["inputs"].device
    if rots is None:
        inx, iny = da["inputs"], db["inputs"]
    else:
        inx = da["inputs"] @ rot_matrix(rots[0], rots[1], dev, dt)
        iny = db["inputs"] @ rot_matrix(rots[2], rots[3], dev, dt)
    fa, fb = model.features((da["op"], da["mask"]), (db["op"], db["mask"]), inx, iny)
    gp = mesh is not None and mesh.n_graph > 1
    if gp:
        fb = parallel_context.gather_rows(fb, mesh.graph)
    # the dcel head in fp32 whatever the features' dtype (bf16 under --bf16)
    fa32, fb32 = at_least_fp32(fa), at_least_fp32(fb)
    if use_stream:
        if target is None:
            target = torch.argmin(GAB, dim=-1)
        loss = losses.corr_dcel_streaming(fa32[0], fb32[0], target, target_inv=target_inv)
    else:
        logits = torch.einsum("bnc,bmc->bnm", fa32, fb32)[0]
        loss = losses.corr_delta_cross_entropy_from_target(logits, target) if GAB is None else loss_fn(logits, GAB)
    if gp:
        loss = loss * (1.0 / mesh.n_graph) ** ROW_SHARE_POWER[loss_name]
    if smooth_w > 0:
        loss = loss + smooth_w * (
            losses.corr_feature_smoothness(da["reg_op"], fa) + losses.corr_feature_smoothness(db["reg_op"], fb)
        )
    return loss


def train_step(model, opt, da: dict, db: dict, rots, target, smooth_w: float, use_stream: bool,
               target_inv=None, loss_fn=None, GAB=None, mesh: mesh_setup.Mesh | None = None,
               loss_name: str = "dcel") -> torch.Tensor:
    """One update (``objective``'s arguments; ``train/loop.py::update``);
    returns the loss (on the device, the global one over a graph-parallel
    ``mesh``).  The gradients stay in each parameter's ``.grad`` until the
    next step."""
    (loss,) = loop.update(model, opt, lambda: (objective(model, da, db, rots, target, smooth_w, use_stream,
                                                         target_inv, loss_fn, GAB, mesh, loss_name),),
                          mesh=mesh, vertex=mesh is not None)
    return loss


class CorrespondenceTrainer:
    """Data, model, optimizer and the device caches of one training run;
    ``data`` (FAUST-like sample dicts) replaces the scans the flags name
    (they are copied where the run changes them: ``--intrinsic``, the amp
    pyramid, RCM order)."""

    def __init__(self, args, log=print, data: list | None = None, mesh: mesh_setup.Mesh | None = None):
        refuse_unported(args)
        self.args, self.log = args, log
        self.n_gp = mesh_setup.axis_ranks(args.graph_parallel)
        gp = self.n_gp > 1
        if gp and (mesh is None or (mesh.n_data, mesh.n_graph) != (1, self.n_gp)):
            raise ValueError(f"--graph-parallel {self.n_gp} needs a (1, {self.n_gp}) grid of ranks "
                             "(train_correspondence.main makes it)")
        self.mesh = mesh if gp else None
        self.device = self.mesh.device if gp else resolve_device(args.device)
        log_environment(log, self.device)
        if gp:
            log(f"rank grid: 1 data x {self.n_gp} graph ranks over {self.mesh.backend}")
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
            resolved = choose_operator_format(1, round_up(nv_max, 8), rcm_ok=self.model_key == "lap" and not gp)
            fmt = "bsr" if resolved == "bsr" else "ell"
            log(f"operator format auto -> {fmt}")
        # BSR under the lap key only; the other keys pack their own operators.  Under --graph-parallel 'bsr'
        # packs the partitions' interiors as BSR and the rest of the pair is ELL
        self.fmt = "bsr" if fmt == "bsr" and self.model_key == "lap" else "ell"
        self.gp_interior = "bsr" if gp and self.fmt == "bsr" else "ell"
        if gp:
            self.fmt = "ell"
        if self.fmt == "bsr" or gp:
            data = [rcm_reorder_sample(s) for s in data]
        if gp and self.model_key == "dirac":
            # narrow Dirac halos need the face index to follow the (RCM) vertex index
            data = [dict(s, F=np.asarray(s["F"])[dirac_partition.sort_faces_for_partition(s["F"])], dirac=None)
                    for s in data]
        self.data = data
        multiple = 128 if self.fmt == "bsr" else 8
        if gp:
            multiple = (128 if self.gp_interior == "bsr" else 8) * self.n_gp
        self.buckets = Buckets.for_samples(data, multiple=multiple)
        if self.model_key == "amp":
            # every pyramid level, and the smoothness pattern, at the widest row of any level
            kmax = max(int(np.diff(Lk.tocsr().indptr).max()) for s in data for Lk in s["L_pyr"])
            self.buckets.ell_k = self.buckets.ell_k_t = max(self.buckets.ell_k, kmax)
        if self.fmt == "bsr":
            fit_bsr_k([s["L"] for s in data], self.buckets)
        self.N = self.buckets.n_vertices
        est_bytes = len(data) * (self.N * self.N * 4 + 40 * self.N * 4)
        fits = est_bytes < DEVICE_BUDGET_BYTES
        # sl1 and cel past the budget, or under --graph-parallel, and every loss under --multihost: the JAX
        # trainer's host path (its fast path needs one process)
        self.host_path = args.multihost or ((not fits or gp) and args.loss != "dcel")
        if self.host_path:
            if args.smooth_reg > 0:
                raise SystemExit(SMOOTH_REG_FAST_PATH)
            if args.eval_only:
                raise SystemExit("--eval-only needs the single-device fast path")
            why = ("--multihost" if args.multihost else "--graph-parallel" if fits
                   else f"est {est_bytes / 1e9:.1f} GB > HBM budget")
            log(f"host path: geodesic matrices stay on host ({why}); each pair's [N, N] cost is built on a prefetch "
                "thread and uploaded every step")
        self.light = not args.multihost and args.loss == "dcel" and (not fits or _FORCE_LIGHT)
        if self.light:
            log(f"light fast path: geodesic matrices stay on host (est {est_bytes / 1e9:.1f} GB > HBM budget); "
                "dcel targets computed host-side per pair and cached on device")
        # the JAX trainer rotates the batch it initialises with, which draws
        # once per rotation axis before the first epoch
        self.angles()

        self.model = SiameseModel(args.model, args.layer, self.dtype, remat=args.remat)
        init_weights(self.model, torch.Generator().manual_seed(0))
        self.model.to(self.device)
        if gp:
            data_parallel.replicate(self.mesh, self.model)
        self.opt = optim.adam(self.model.parameters(), float(args.lr), weight_decay=1e-5)
        log(f"Num parameters {count_params(self.model)}")
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
        self.uploads = Uploads(self.device)
        self._targets: dict[tuple[int, int], torch.Tensor] = {}
        self._inverses: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def angles(self) -> tuple[float, float]:
        a = self.args
        return (
            float(np.float32(self.rng.uniform(0, 2 * np.pi))) if a.xz_rotate else 0.0,
            float(np.float32(self.rng.uniform(0, 2 * np.pi))) if a.xy_rotate else 0.0,
        )

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows (axis 1) of a whole shape's ``[1, N, ...]`` array
        under ``--graph-parallel``; the array itself otherwise."""
        return edge_partition.shard_rows(t, self.n_gp, self.mesh.graph_index) if self.mesh is not None else t

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows (axis 1) of a row-sharded ``[1, n, ...]`` array
        under ``--graph-parallel``, without a gradient; the array itself
        otherwise."""
        return mesh_setup.all_gather(t, self.mesh.graph, 1) if self.mesh is not None else t

    def partitioned_op(self, sample: dict):
        """The scan's operator row-partitioned over the graph axis (the JAX
        trainer's ``partitioned_op_of``: the Laplacian at its own halo, ELL or
        BSR interiors, or the Dirac pair of its sorted faces), this rank's
        shard."""
        N, n = self.N, self.n_gp
        if self.model_key == "dirac":
            op = graph_parallel.partition_batch_dirac([native.dirac_coeffs(sample["V"], sample["F"])], n, N,
                                                      self.buckets.n_faces, max_valence=self.buckets.max_valence)
        else:
            halo = min(edge_partition.suggest_halo(sample["L"]), N // n)
            op = graph_parallel.partition_batch_operator([sample["L"]], n, n_rows=N, halo=halo, k=self.buckets.ell_k,
                                                         interior_fmt=self.gp_interior)
        return graph_parallel.shard_operator(op, self.mesh.graph_index)

    def dev_sample(self, i: int) -> dict:
        """Sample ``i``'s operator, mask, inputs, padded geodesic matrix and
        label tables (none of those three on the light path and the host
        path) and the smoothness pattern on the device, built once; under
        ``--graph-parallel`` this rank's shard of the partitioned operator and
        its rows of the mask and inputs (the rest whole)."""
        hit = self._dev.get(i)
        if hit is not None:
            return hit
        sample, N, dev = self.data[i], self.N, self.device
        op = self.partitioned_op(sample) if self.mesh is not None else None
        pack = correspondence_batch(sample, self.buckets, fmt=self.fmt, op_dtype=self.dtype, model=self.model_key,
                                    operator=op)
        entry = {"op": pack.operator.to(dev) if not isinstance(pack.operator, list)
                 else [o.to(dev) for o in pack.operator],
                 "mask": self.rows(pack.mask).to(dev), "inputs": self.rows(pack.inputs).to(dev),
                 "n": sample["V"].shape[0]}
        if not (self.light or self.host_path):
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
        """The pair's dcel target, argmin of its cost (on the light path and
        under ``--graph-parallel`` on the host, ``host_pair_target``): fixed
        per pair, so computed once and cached on the device."""
        t = self._targets.get((ia, ib))
        if t is None:
            if self.light or self.mesh is not None:
                t = torch.from_numpy(host_pair_target(self.data[ia], self.data[ib], self.N)).to(self.device)
            else:
                t = torch.argmin(self.aggregate_padded(self.dev_sample(ia), self.dev_sample(ib)), dim=-1)
            self._targets[(ia, ib)] = t
        return t

    def pair_inverse(self, ia: int, ib: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The inverse of the pair's target (``losses.target_inverse``; of
        this rank's rows of it under ``--graph-parallel``), built once on the
        host and cached on the device: the streaming head's backward sums
        ``fa`` by target through it in a fixed order.  Its width is the
        target's largest multiplicity."""
        inv = self._inverses.get((ia, ib))
        if inv is None:
            inv = losses.target_inverse(self.local_rows(self.pair_target(ia, ib)), self.N)
            self._inverses[(ia, ib)] = inv
        return inv

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows (axis 0) of a per-row array of the first shape
        (a target, a cost) under ``--graph-parallel``; the array itself
        otherwise."""
        if self.mesh is None:
            return t
        n = t.shape[0] // self.n_gp
        return t[self.mesh.graph_index * n:(self.mesh.graph_index + 1) * n]

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
            target, GAB = self.local_rows(self.pair_target(ia, ib)), None
        else:
            target, GAB = None, self.aggregate_padded(da, db)
        loss = train_step(self.model, self.opt, da, db, [float(r) for r in rots], target, self.smooth_w,
                          self.use_stream, inv, self.loss_fn, GAB, self.mesh, self.args.loss)
        self.step += 1
        return loss

    def assemble_pair(self, ia: int, ib: int, test: bool = False) -> dict:
        """The host path's pair (the JAX trainer's ``assemble_pair``): A's
        inputs, then B's, rotated by fresh draws (``rotate_host``) and
        padded to ``[1, N, 3]``, and the pair's padded cost (``pad_cost`` of
        ``losses.aggregate_G``); for a test pair also B's padded geodesic
        matrix and the padded label tables.  Run on the card, every tensor
        is in pinned memory: pinning is the only CUDA call of the prefetch
        worker that runs this."""
        pin, N = self.device.type == "cuda", self.N
        sa, sb = self.data[ia], self.data[ib]
        a = self.args
        xs = [rotate_host(np.asarray(s["input"], np.float32), self.rng, a.xz_rotate, a.xy_rotate) for s in (sa, sb)]

        def t(v, dt, n):  # zero-padded to n rows
            out = np.zeros((n,) + np.shape(v)[1:], dt)
            out[: len(v)] = v
            out = torch.from_numpy(out)
            return out.pin_memory() if pin else out

        tables = [(torch.from_numpy(np.asarray(s["G"], np.float32)), torch.from_numpy(np.asarray(s["label"], np.int64)),
                   torch.from_numpy(np.asarray(s["label_inv"], np.int64))) for s in (sa, sb)]
        item = {"ia": ia, "ib": ib, "xa": t(xs[0], np.float32, N)[None], "xb": t(xs[1], np.float32, N)[None],
                "GAB": pad_cost(losses.aggregate_G(*tables[0], *tables[1]), N, pin)}
        if test:
            GB = tables[1][0]
            item["GB"] = torch.zeros((N, N), dtype=torch.float32, pin_memory=pin)
            item["GB"][: GB.shape[0], : GB.shape[1]] = GB
            item.update(lA=t(sa["label"], np.int64, N), lB=t(sb["label"], np.int64, N),
                        liB=t(sb["label_inv"], np.int64, N))
        return item

    def update_host(self, item: dict) -> torch.Tensor:
        """One host-path update on an assembled pair (``assemble_pair``):
        its inputs and cost uploaded without blocking, then sl1 or cel over
        the full logits."""
        d = self.uploads(item, _upload_tree)
        da = dict(self.dev_sample(d["ia"]), inputs=self.rows(d["xa"]))
        db = dict(self.dev_sample(d["ib"]), inputs=self.rows(d["xb"]))
        loss = train_step(self.model, self.opt, da, db, None, None, 0.0, self.use_stream, None, self.loss_fn,
                          self.local_rows(d["GAB"]), self.mesh, self.args.loss)
        self.step += 1
        return loss

    def host_items(self, n: int):
        """The host path's next ``n`` train pairs, assembled on the prefetch
        thread: each update's pair indices drawn, then its rotations
        (``assemble_pair``), in the JAX trainer's order."""
        def make_train_item(_i):
            ia, ib = self.rng.integers(0, self.n_train, size=2)
            return self.assemble_pair(int(ia), int(ib))

        return prefetch(make_train_item, n)

    def host_epoch(self) -> float:
        """The host path's updates (the JAX trainer's host loop) over
        ``host_items``; the losses fetched one step late (``MetricFetcher``)
        and summed on the host."""
        n, total = self.args.num_updates, 0.0
        fetch = MetricFetcher()
        for item in self.host_items(n):
            vals = fetch.push(self.update_host(item))
            total += vals[0] if vals is not None else 0.0
        vals = fetch.flush()
        return total + (vals[0] if vals is not None else 0.0)

    def train_epoch(self, epoch: int, metrics_log: MetricsLogger | None = None) -> float:
        meter = Throughput()
        if self.host_path:
            n = self.args.num_updates
            mean = self.host_epoch() / n
            meter.steps += n
        else:
            pair_idx, rots = self.epoch_plan()
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
    def eval_pair(self, ia: int, ib: int, rots, item: dict | None = None) -> tuple[torch.Tensor, dict]:
        """Loss (dcel on the streaming head, else ``--loss``) and FAUST
        metrics of one pair (B's columns masked); on the host path from the
        pair ``assemble_pair(ia, ib, test=True)`` built (``item``: rotated
        inputs, cost, B's geodesic matrix and the label tables, uploaded
        here), as the JAX trainer's ``run_pair(train=False)``."""
        da, db = self.dev_sample(ia), self.dev_sample(ib)
        if item is None:
            inx = da["inputs"] @ rot_matrix(rots[0], rots[1], self.device)
            iny = db["inputs"] @ rot_matrix(rots[2], rots[3], self.device)
            GAB = self.aggregate_padded(da, db)
            lA, lB, liB, GB = da["l"], db["l"], db["li"], db["G"]
        else:
            d = self.uploads(item, _upload_tree)
            inx, iny, GAB, lA, lB, liB, GB = (d[k] for k in ("xa", "xb", "GAB", "lA", "lB", "liB", "GB"))
            inx, iny = self.rows(inx), self.rows(iny)
        fa, fb, mask_a, mask_b = self.features(da, db, inx, iny)
        if self.use_stream:
            pred = losses.streaming_corr_argmax(fa[0], fb[0], mask_b[0, :, 0])
            metrics = losses.corr_metrics_from_pred(pred, lA, lB, liB, GB, mask_a[0, :, 0])
            return losses.corr_dcel_streaming(fa[0], fb[0], torch.argmin(GAB, dim=-1)), metrics
        logits = torch.einsum("bnc,bmc->bnm", fa, fb)[0]
        metrics = losses.corr_accuracy_metrics(logits, lA, lB, liB, GB, mask_a[0, :, 0], mask_b[0, :, 0])
        return self.loss_fn(logits, GAB), metrics

    def features(self, da: dict, db: dict, inx: torch.Tensor, iny: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Both shapes' features (at least fp32) and masks, whole: under
        ``--graph-parallel`` the trunk runs graph-sharded on this rank's rows
        and every rank's rows are gathered, so the heads and the metrics
        score the whole pair on every rank."""
        ctx = self.mesh.context(vertex=True) if self.mesh is not None else contextlib.nullcontext()
        with ctx:
            fa, fb = self.model.features((da["op"], da["mask"]), (db["op"], db["mask"]), inx, iny)
        return (at_least_fp32(self.whole(fa)), at_least_fp32(self.whole(fb)), self.whole(da["mask"]),
                self.whole(db["mask"]))

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
            if self.host_path:
                loss, metrics = self.eval_pair(i, j, None, self.assemble_pair(i, j, test=True))
            else:
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
        fa, fb, _, mask_b = self.features(da, db, da["inputs"], db["inputs"])
        return losses.streaming_corr_argmax(fa[0], fb[0], mask_b[0, :, 0])

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


def run_rank(mesh: mesh_setup.Mesh | None, args) -> dict:
    """The run on one rank of the graph axis (rank 0 logs and writes the
    metrics and the checkpoints), or alone (``mesh`` None)."""
    rank0 = mesh is None or mesh.rank == 0
    log_dir = os.path.join(args.result_dir, "log")
    log = make_logger(args.result_prefix, log_dir) if rank0 else (lambda _: None)
    log(args)
    log_multihost(log, mesh)
    trainer = CorrespondenceTrainer(args, log, mesh=mesh)
    ckpt_path = os.path.join(args.result_dir, "pts", f"{args.result_prefix}_state.pt")
    if args.deser_option != "no":
        path = args.deser_path or ckpt_path
        if os.path.isfile(path):
            log("Continue...")
            _, trainer.step, _ = checkpoint.restore_training(path, trainer.model, trainer.opt)
    if args.eval_only:
        return {"eval": trainer.eval_only()}
    metrics_log = MetricsLogger(args.result_prefix, log_dir) if rank0 else None
    history: dict = {"train_loss": [], "test": []}
    for epoch in range(args.num_epoch):
        history["train_loss"].append(trainer.train_epoch(epoch, metrics_log))
        history["test"].append(trainer.test_pass(epoch, metrics_log))
        if metrics_log is not None:
            metrics_log.plot()
        if epoch % 10 == 9 and rank0:
            trainer.save(ckpt_path, epoch)
    if rank0:
        trainer.save(ckpt_path, args.num_epoch - 1)
    return history


def main(argv=None) -> dict:
    """Train; returns each epoch's mean train loss and test results (with
    ``--eval-only``, ``{"eval": metrics}`` and no training).  With
    ``--graph-parallel G`` it starts G ranks (with ``--multihost`` this
    launch's share of them) and returns its first rank's; a rank that fails
    makes it raise."""
    args = config.parse_with_config(parser, argv)
    refuse_unported(args)
    if process_index(args) == 0:
        dump_config(args, os.path.join(args.result_dir, "cfg", f"{args.result_prefix}.json"))
    return run_grid(run_rank, 1, mesh_setup.axis_ranks(args.graph_parallel), args)


if __name__ == "__main__":
    main(sys.argv[1:])
