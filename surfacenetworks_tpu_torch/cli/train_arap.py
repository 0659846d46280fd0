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
each train batch is stacked and pinned on a prefetch thread, where the picks
are drawn, and uploaded without blocking (``data.pipeline.host_route``).
``--config``/``--preset`` layer a JSON file or a named preset under the
flags (``config.py``).  ``ArapTrainer`` also takes
sequences handed in from code.  ``--bf16`` trains in mixed precision as the
JAX trainer does (``dtype=torch.bfloat16``; ELL applies take bf16 x and
return fp32, dense ones promote to fp32).  ``--data-parallel N`` (N > 1;
0 and 1 mean off) starts N ranks (``dist.mesh_setup.launch``; gloo on the
CPU, nccl on cards of their own): every rank draws the same picks and trains
on its slice of the batch, the step computing the JAX trainer's global
function (batch norm over the global batch, the loss over the global batch
size, gradients summed over the ranks); rank 0 writes the log, the metrics
and the checkpoints; the test batches run whole on every rank.
``--graph-parallel G`` (G > 1; ``lap`` and ``dir``, not with ``--dense`` or
``--data-parallel``, as in the JAX trainer) starts G ranks that
row-partition every frame: each sequence RCM-ordered by its first frame's
permutation (``rcm_reorder_sequence``; ``dir``: the faces sorted by their
smallest vertex, the coefficients recomputed), the bucket rounded to ``8
G`` rows, the operator frames (the first 10 of each sequence) partitioned
once with dataset-wide halos and floors, each rank holding its rows of
every pick (the device store, or the host route, of its shards); the init
batch draws no picks, as in the JAX trainer's graph-parallel run; the loss
is each rank's rows' share over the global batch, and the test batches run
on the ranks' rows too.  After each test epoch rank 0 redraws
``log/<id>_curves.png`` (``MetricsLogger.plot``).

``--dump-rollout DIR``, after training: the first test batch's first
item predicted, its 40 frames written to ``DIR/rollout_pred.npy`` and the
ground truth to ``DIR/rollout_gt.npy`` (``dump_rollout``, no matplotlib),
then drawn side by side into ``DIR/rollout.gif`` (``viz.animate_sequence``),
as the JAX trainer does.  Where matplotlib is missing (as on the machine
with the card) the flag is refused at the start, not after training as the
JAX trainer would fail.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import importlib.util
import os
import sys

import numpy as np
import torch

from surfacenetworks_tpu_torch import config, native, parallel_context
from surfacenetworks_tpu_torch.cli.common import MetricsLogger, Throughput, count_params, log_environment, make_logger
from surfacenetworks_tpu_torch.data import Buckets, arap_batch, datasets, rcm_reorder_sequence
from surfacenetworks_tpu_torch.data.batching import IN_FRAMES, OUT_FRAMES
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples, host_route, to_device
from surfacenetworks_tpu_torch.dist import data_parallel, dirac_partition, edge_partition, graph_parallel, mesh_setup
from surfacenetworks_tpu_torch.models import init_weights
from surfacenetworks_tpu_torch.models.arap_models import MODELS
from surfacenetworks_tpu_torch.serve import resolve_device
from surfacenetworks_tpu_torch.train import checkpoint, loop, losses, optim

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
config.add_config_flags(parser)
parser.add_argument("--data-parallel", type=int, default=0,
                    help="shard each batch over this many ranks (0 or 1: off); the batch size must be divisible by it")
parser.add_argument("--graph-parallel", type=int, default=0,
                    help="row-partition every frame over this many ranks (lap, dir; 0 or 1: off)")
parser.add_argument("--dump-rollout", default=None, metavar="DIR",
                    help="after training, write a test sequence's predicted and true 40-frame rollouts as .npy and "
                         "draw them as a GIF (matplotlib)")


def _have_matplotlib() -> bool:
    try:
        return importlib.util.find_spec("matplotlib") is not None
    except ImportError:  # an import hook that refuses it
        return False


def refuse_unported(args) -> None:
    """Raise where matplotlib, which ``--dump-rollout``'s GIF needs, is
    missing (at the start, where the JAX trainer would fail after
    training), and with the JAX trainer's messages on the multi-device flags
    it refuses."""
    if args.dump_rollout is not None and not _have_matplotlib():
        raise SystemExit("train_arap: --dump-rollout draws its GIF with matplotlib, which is not installed here "
                         "(train_arap.dump_rollout writes the .npy rollouts without it)")
    n_dp, n_gp = mesh_setup.axis_ranks(args.data_parallel), mesh_setup.axis_ranks(args.graph_parallel)
    if n_gp > 1:
        if args.model not in ("lap", "dir"):
            raise SystemExit("--graph-parallel supports the lap and dir models")
        if args.dense:
            raise SystemExit("--graph-parallel partitions sparse operators; drop --dense")
        if n_dp > 1:
            raise SystemExit("--graph-parallel and --data-parallel are mutually exclusive here")
    if n_dp > 1 and args.batch_size % n_dp:
        raise SystemExit(f"batch size {args.batch_size} not divisible by --data-parallel {n_dp}")


def gp_order(sequences: list[list[dict]], kind: str) -> list[list[dict]]:
    """The sequences as ``--graph-parallel`` reads them (JAX's order): each
    RCM-ordered by its first frame's permutation and, for Dirac data, every
    frame's faces sorted by the first frame's smallest vertex (the
    coefficients, which bake in the order, dropped)."""
    out = [rcm_reorder_sequence(s) for s in sequences]
    if kind == "dirac":
        for seq in out:
            fperm = dirac_partition.sort_faces_for_partition(seq[0]["F"])
            for f in seq:
                f["F"] = np.asarray(f["F"])[fperm]
                f.pop("dirac", None)
    return out


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


def masked_loss(model, batch, batch_size: int | None = None) -> torch.Tensor:
    """The smooth-L1 sum of the masked outputs over ``batch_size`` (default:
    the batch's own; a rank's shard divides by the global batch)."""
    out = model(batch.operator, batch.mask, batch.inputs) * batch.mask
    return losses.smooth_l1_sum(out, batch.targets, batch_size or batch.inputs.shape[0])


def train_step(model, opt, batch, schedule=None, mesh: mesh_setup.Mesh | None = None) -> torch.Tensor:
    """One update on a batch on the model's device: the loss, its
    gradients, the scheduled LR and the optimizer step.  Returns the loss
    (on the device); the gradients stay in ``.grad`` until the next step.
    With ``mesh`` the batch is this rank's slice of the global batch (of its
    items over the data axis, or of its rows over the graph axis): the body
    runs sharded, the gradients are summed over the ranks and the global
    loss is returned."""
    n = mesh.n_data * batch.inputs.shape[0] if mesh is not None else None
    (loss,) = loop.update(model, opt, lambda: (masked_loss(model, batch, n),), schedule, mesh,
                          vertex=mesh is not None and mesh.n_graph > 1)
    return loss


@torch.no_grad()
def eval_step(model, batch, mesh: mesh_setup.Mesh | None = None) -> torch.Tensor:
    """The test loss of a batch; with a graph-parallel ``mesh`` on this
    rank's rows (the global loss)."""
    if mesh is None or mesh.n_graph == 1:
        return masked_loss(model, batch)
    with mesh.context(vertex=True):
        loss = masked_loss(model, batch)
    return parallel_context.total(loss, [mesh.graph])


class ArapTrainer:
    """Sequences, model, optimizer, pick draws and the device store of one
    run; ``sequences`` (lists of frame dicts) replace the ones the flags
    name."""

    def __init__(self, args, sequences: list[list[dict]] | None = None, log=print,
                 mesh: mesh_setup.Mesh | None = None):
        refuse_unported(args)
        self.args, self.log = args, log
        n_dp, self.n_gp = mesh_setup.axis_ranks(args.data_parallel), mesh_setup.axis_ranks(args.graph_parallel)
        if n_dp * self.n_gp > 1 and (mesh is None or (mesh.n_data, mesh.n_graph) != (n_dp, self.n_gp)):
            raise ValueError(f"a run on a ({n_dp}, {self.n_gp}) grid of ranks needs that grid's mesh "
                             "(train_arap.main makes it)")
        self.mesh = mesh if n_dp * self.n_gp > 1 else None
        self.device = self.mesh.device if self.mesh is not None else resolve_device(args.device)
        log_environment(log, self.device)
        # fp32 matmuls and convolutions in full fp32 (no TF32), and bf16 ones
        # (--bf16) summed in fp32 throughout, as XLA sums them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.sequences = load_sequences(args) if sequences is None else sequences
        kind = "dirac" if args.model == "dir" else "lap"
        if self.n_gp > 1:
            self.sequences = gp_order(self.sequences, kind)
        self.n_train = max(len(self.sequences) * 8 // 10, 1)
        self.buckets = Buckets.for_samples([{"V": s[0]["V"], "F": s[0]["F"]} for s in self.sequences],
                                           multiple=8 * self.n_gp)
        self.fmt = "dense" if args.dense else "ell"
        if self.n_gp > 1:
            op_of = self._prepartition(kind)

            def pack(pick):
                host = arap_batch(self.sequences, [pick], self.buckets, model=kind, operator=op_of(pick))
                return graph_parallel.shard_batch_rows(host, self.n_gp, self.mesh.graph_index)
            self.packed = PackedSamples(pack, value_keys=True)
        else:
            self.packed = PackedSamples(
                lambda pick: arap_batch(self.sequences, [pick], self.buckets, model=kind, fmt=self.fmt),
                value_keys=True)
        self.rng = np.random.default_rng(args.seed)
        self.test_counter = 0
        self.model = MODELS[args.model](layers=args.layer, dtype=torch.bfloat16 if args.bf16 else None)
        init_weights(self.model, torch.Generator().manual_seed(0))
        self.model.to(self.device)
        if self.mesh is not None:
            data_parallel.replicate(self.mesh, self.model)
        # the JAX trainer initialises from one batch of train picks (on one device; under --graph-parallel
        # from a fixed batch): its draws are used up here too
        if self.n_gp == 1:
            self.sample_train_picks()
        log(f"Num parameters {count_params(self.model)}")
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

    def _prepartition(self, kind: str):
        """Every operator frame (the first 10 of each sequence) row-partitioned
        once with dataset-wide halos and floors, as the JAX trainer does;
        returns ``op_of(pick)``, the stacked partitioned operator of a
        pick's last input frame."""
        b, n = self.buckets, self.n_gp
        frames = [(si, fi) for si, seq in enumerate(self.sequences) for fi in range(min(10, len(seq)))
                  if kind == "dirac" or "L" in seq[fi]]
        if kind == "dirac":
            ops, floors = graph_parallel.prepartition_dirac(
                [native.dirac_coeffs(self.sequences[si][fi]["V"], self.sequences[si][fi]["F"]) for si, fi in frames],
                n, b.n_vertices, b.n_faces, max_valence=b.max_valence)
            stack = dirac_partition.stack_partitioned_dirac
            self.log(f"graph parallel: {b.n_vertices} rows and {b.n_faces} faces in {n} partitions, halos "
                     f"{ops[0].halo_v} vertex and {ops[0].halo_f} face rows")
        else:
            ops, floors = graph_parallel.prepartition_ell([self.sequences[si][fi]["L"] for si, fi in frames], n,
                                                          n_rows=b.n_vertices, k=b.ell_k)
            stack = edge_partition.stack_partitioned
            self.log(f"graph parallel: {b.n_vertices} rows in {n} partitions, halo {ops[0].fwd.halo}")
        parts = dict(zip(frames, ops))
        return lambda pick: stack([parts[(pick[0], pick[1] + IN_FRAMES - 1)]], **floors)

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

    def _shard(self, picks: list) -> list:
        """This rank's slice of a global batch's picks (all of them on a
        graph axis, whose ranks hold rows)."""
        return data_parallel.shard_batch(self.mesh, picks) if self.mesh is not None else picks

    def batch(self, picks: list[tuple[int, int]], shard: bool = False):
        """The batch of ``picks`` on the device (this rank's slice of them
        with ``shard``)."""
        if shard:
            picks = self._shard(picks)
        if self.store is None:
            return to_device(self.packed.batch(picks), self.device)
        return self.store.batch(picks).gather()

    def train_batches(self, n: int):
        """The next ``n`` train batches on the device: gathered from the
        device store, or on the host route built and pinned on a worker
        thread (the picks drawn there, in the same order) and uploaded
        without blocking."""
        if self.store is None:
            return host_route(lambda: self._shard(self.sample_train_picks()), self.packed, n, self.device)
        return (self.batch(self.sample_train_picks(), shard=True) for _ in range(n))

    def update(self, batch) -> torch.Tensor:
        loss = train_step(self.model, self.opt, batch, self.schedule, self.mesh)
        self.step += 1
        return loss

    def train_epoch(self, epoch: int, metrics_log: MetricsLogger | None = None) -> float:
        """``--num-updates`` updates; logs and returns the mean loss."""
        n = self.args.num_updates
        meter = Throughput()
        loss_sum = torch.zeros((), device=self.device)
        for batch in self.train_batches(n):
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
            loss_sum += float(eval_step(self.model, self.batch(self.sample_test_picks()),
                                        self.mesh if self.n_gp > 1 else None))
        self.log(f"Test epoch {epoch}, loss {loss_sum / trials}")
        if metrics_log is not None:
            metrics_log.write(epoch, "test", loss=loss_sum / trials)
        return loss_sum / trials

    def save(self, path: str, epoch: int) -> None:
        checkpoint.save_checkpoint(path, self.model, self.opt, epoch, self.step)

    @torch.no_grad()
    def rollout(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``--dump-rollout``'s frames, as the JAX trainer takes them: the
        test counter reset, the first test batch's masked prediction and
        targets, item 0's first test sequence's vertices, as ``(pred, gt)``
        ``[OUT_FRAMES, n, 3]`` and that sequence's faces; under
        ``--graph-parallel`` every rank's rows gathered (every rank must
        call it)."""
        self.test_counter = 0
        batch = self.batch(self.sample_test_picks())
        gp = self.mesh is not None and self.n_gp > 1
        with self.mesh.context(vertex=True) if gp else contextlib.nullcontext():
            out = self.model(batch.operator, batch.mask, batch.inputs) * batch.mask
        targets = batch.targets
        if gp:
            out = mesh_setup.all_gather(out, self.mesh.graph, -2)
            targets = mesh_setup.all_gather(targets, self.mesh.graph, -2)
        seq = self.sequences[self.n_train if len(self.sequences) > self.n_train else 0]
        n = seq[0]["V"].shape[0]
        out, targets = out[0, :n].cpu().numpy(), targets[0, :n].cpu().numpy()
        frames = range(OUT_FRAMES)
        return (np.stack([out[:, 3 * i:3 * (i + 1)] for i in frames]),
                np.stack([targets[:, 3 * i:3 * (i + 1)] for i in frames]), np.asarray(seq[0]["F"], np.int32))


def dump_rollout(trainer: ArapTrainer, out_dir: str | None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``trainer.rollout()`` written to ``out_dir/rollout_pred.npy`` and
    ``out_dir/rollout_gt.npy`` (the JAX trainer's files; nothing with
    ``out_dir`` None); returns ``(pred, gt, faces)``."""
    pred, gt, faces = trainer.rollout()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "rollout_pred.npy"), pred)
        np.save(os.path.join(out_dir, "rollout_gt.npy"), gt)
    return pred, gt, faces


def run_rank(mesh: mesh_setup.Mesh | None, args) -> dict:
    """Train on one rank (or alone, ``mesh`` None); rank 0 writes the log,
    the metrics and the checkpoints.  Returns each epoch's train and test
    loss."""
    rank0 = mesh is None or mesh.rank == 0
    log = make_logger(args.result_prefix, os.path.join(args.result_dir, "log")) if rank0 else (lambda _: None)
    log(args)
    trainer = ArapTrainer(args, log=log, mesh=mesh)
    metrics_log = MetricsLogger(args.result_prefix, os.path.join(args.result_dir, "log")) if rank0 else None
    ckpt = os.path.join(args.result_dir, "pts", f"{args.result_prefix}_{args.layer}_{args.model}.pt")
    history: dict = {"train": [], "test": []}
    for epoch in range(args.num_epoch):
        history["train"].append(trainer.train_epoch(epoch, metrics_log))
        history["test"].append(trainer.test_pass(epoch, metrics_log))
        if rank0:
            metrics_log.plot()
            trainer.save(ckpt, epoch)
    if args.dump_rollout:
        pred, gt, faces = dump_rollout(trainer, args.dump_rollout if rank0 else None)
        if rank0:
            from surfacenetworks_tpu_torch import viz

            gif = viz.animate_sequence(list(gt), faces, os.path.join(args.dump_rollout, "rollout.gif"),
                                       pred_frames=list(pred))
            log(f"rollout dumped to {gif}")
    return history


def main(argv=None) -> dict:
    """Train; returns each epoch's train and test loss (rank 0's under
    ``--data-parallel`` or ``--graph-parallel``, whose ranks ``main``
    starts)."""
    args = config.parse_with_config(parser, argv)
    refuse_unported(args)
    return mesh_setup.run_ranks(run_rank, mesh_setup.axis_ranks(args.data_parallel),
                                mesh_setup.axis_ranks(args.graph_parallel), args.device, args)


if __name__ == "__main__":
    main(sys.argv[1:])
