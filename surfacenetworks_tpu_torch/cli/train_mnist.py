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
epoch ...`` in ``log/<prefix>.log``, ``log/<prefix>.metrics.jsonl``, its
curves redrawn after each test epoch into ``log/<prefix>_curves.png``
(``MetricsLogger.plot``; nothing where matplotlib is missing, as on the
machine with the card) and a checkpoint each epoch, here ``pts/<prefix>.pt`` in the port's format.  Every sample is
packed alone with ``fmt='auto'`` (dense at mesh-MNIST sizes) and the
dataset uploaded once; a batch is an index gather on the device (past the
6 GiB budget each train batch is built and pinned on a prefetch thread and
uploaded without blocking, ``data.pipeline.host_route``).
``--config``/``--preset`` layer a JSON file or a named preset under the
flags (``config.py``).  The
dropout masks come from a ``torch.Generator`` seeded with ``--seed`` on the
device, so they differ from flax's draws.  ``MnistTrainer`` also takes
samples and an operator format from code.  ``--bf16`` trains in mixed
precision as the JAX trainer does (``dtype=torch.bfloat16``: bf16
activations and matmuls; the pooled features, ``fc1``, the loss, the
parameters and the optimizer state fp32).  ``--data-parallel N`` (N > 1; 0
and 1 mean off) starts N ranks (``dist.mesh_setup.launch``): every rank
draws the same batches and the dropout masks for the whole batch, and
trains on its slice; batch norm, the loss and the accuracy are the global
batch's and the gradients are summed over the ranks, as the JAX trainer's
data-parallel step computes them; rank 0 writes the log, the metrics and the
checkpoints; the test batches run whole on every rank.  ``--graph-parallel
G`` (G > 1, ``lap`` and ``dirac``, not with ``--data-parallel``, as in the
JAX trainer) starts G ranks that row-partition every mesh: the samples
RCM-ordered (Dirac: the faces sorted by their smallest vertex and the
coefficients recomputed), the bucket rounded to ``8 G`` rows, each
sample's operator partitioned once with dataset-wide halos and floors and
each rank holding its rows of every sample (the device dataset, or the host
route, of its shards).  The pooled head, summed over the ranks, is the same
on every rank, and so is its dropout mask, drawn from ``trainer.gen`` in
the same order everywhere; its loss and accuracy enter each rank's share
once (``parallel_context.replicated_share``); the test batches run on the
ranks' rows too.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from surfacenetworks_tpu_torch import config, parallel_context
from surfacenetworks_tpu_torch.cli.common import EpochSampler, MetricsLogger, count_params, log_environment, make_logger
from surfacenetworks_tpu_torch.data import Buckets, datasets, mnist_batch, rcm_reorder_sample, vae_batch
from surfacenetworks_tpu_torch.data.batching import _dirac_coeffs_of
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples, host_route, to_device
from surfacenetworks_tpu_torch.dist import data_parallel, dirac_partition, edge_partition, graph_parallel, mesh_setup
from surfacenetworks_tpu_torch.models import init_weights
from surfacenetworks_tpu_torch.models.mnist_models import MODELS, WIDTH, dropout_keep
from surfacenetworks_tpu_torch.serve import resolve_device
from surfacenetworks_tpu_torch.train import checkpoint, loop, losses, optim

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
config.add_config_flags(parser)
parser.add_argument("--data-parallel", type=int, default=0,
                    help="shard each batch over this many ranks (0 or 1: off); the batch size must be divisible by it")
parser.add_argument("--graph-parallel", type=int, default=0,
                    help="row-partition every mesh over this many ranks (lap, dirac; 0 or 1: off)")


def refuse_unported(args, trainer: str) -> None:
    """The multi-device flags' refusals the classifier and the VAE share,
    the JAX trainers' own: ``--graph-parallel`` with ``--data-parallel``
    (and, for the classifier, with a model other than lap or dirac), and a
    batch the data-parallel ranks cannot split.  The port runs every path
    of these trainers; ``trainer`` names the one asking."""
    n_dp, n_gp = mesh_setup.axis_ranks(args.data_parallel), mesh_setup.axis_ranks(args.graph_parallel)
    if n_gp > 1 and trainer == "train_mnist" and not (args.model.startswith("dir") or args.model == "lap"):
        raise SystemExit("--graph-parallel supports the lap and dirac models")
    if n_gp > 1 and n_dp > 1:
        raise SystemExit("--graph-parallel and --data-parallel are mutually exclusive here")
    if n_dp > 1 and args.batch_size % n_dp:
        raise SystemExit(f"batch size {args.batch_size} not divisible by --data-parallel {n_dp}")


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
                 model: torch.nn.Module, log, mesh: mesh_setup.Mesh | None = None):
        self.args, self.log = args, log
        n_dp, self.n_gp = mesh_setup.axis_ranks(args.data_parallel), mesh_setup.axis_ranks(args.graph_parallel)
        if n_dp * self.n_gp > 1 and (mesh is None or (mesh.n_data, mesh.n_graph) != (n_dp, self.n_gp)):
            raise ValueError(f"a run on a ({n_dp}, {self.n_gp}) grid of ranks needs that grid's mesh (the trainer's "
                             "main makes it)")
        self.mesh = mesh if n_dp * self.n_gp > 1 else None
        self.device = self.mesh.device if self.mesh is not None else resolve_device(args.device)
        log_environment(log, self.device)
        # fp32 matmuls and convolutions in full fp32 (no TF32), and bf16 ones
        # (--bf16) summed in fp32 throughout, as XLA sums them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        if self.n_gp > 1:
            samples = gp_order(samples, kind)
        sep = max(1, int(len(samples) * 0.8))
        self.train_samples, self.test_samples = samples[:sep], samples[sep:]
        self.kind, self.fmt = kind, fmt  # under --graph-parallel the plain format of the VAE's decoded samples
        self.buckets = Buckets.for_samples(samples, multiple=8 * self.n_gp)
        if self.n_gp > 1:
            operators = self._prepartition(samples, batch_fn is vae_batch)

            def pack(s):
                host = batch_fn([s], self.buckets, model=kind, **operators(s))
                return graph_parallel.shard_batch_rows(host, self.n_gp, self.mesh.graph_index)
            self.packed = PackedSamples(pack)
        else:
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
        if self.mesh is not None:
            data_parallel.replicate(self.mesh, self.model)
        log(f"Num parameters {count_params(self.model)}")
        self.opt = optim.adam(self.model.parameters(), args.lr, weight_decay=1e-5)

    def _prepartition(self, samples: list[dict], flat: bool):
        """Each sample's operator (and, for the VAE, ``flat``, its flat
        operator) row-partitioned once with dataset-wide halos and floors,
        as the JAX trainers partition them; returns ``operators(sample) ->
        kwargs`` of the batch function for one sample."""
        N, M, n = self.buckets.n_vertices, self.buckets.n_faces, self.n_gp
        keys = ["L", "flat_L"] if self.kind != "dirac" else ["dirac", "flat_dirac"]
        parts = []
        for key in keys[: 2 if flat else 1]:
            if self.kind == "dirac":
                ops, floors = graph_parallel.prepartition_dirac([_dirac_coeffs_of(s, key) for s in samples], n, N, M,
                                                                max_valence=self.buckets.max_valence)
                stack = dirac_partition.stack_partitioned_dirac
                self.log(f"graph parallel ({key}): {N} rows and {M} faces in {n} partitions, halos {ops[0].halo_v} "
                         f"vertex and {ops[0].halo_f} face rows")
            else:
                ops, floors = graph_parallel.prepartition_ell([s[key] for s in samples], n, n_rows=N,
                                                              k=self.buckets.ell_k)
                stack = edge_partition.stack_partitioned
                self.log(f"graph parallel ({key}): {N} rows in {n} partitions, halo {ops[0].fwd.halo}")
            parts.append(({id(s): o for s, o in zip(samples, ops)}, floors, stack))

        def operators(s):
            built = [stack([by_id[id(s)]], **floors) for by_id, floors, stack in parts]
            return {"operator": built[0], "flat_operator": built[1]} if flat else {"operator": built[0]}

        return operators

    def shard(self, rows):
        """This rank's slice of a global batch's samples (or of a tensor's
        leading axis); everything on one device."""
        return data_parallel.shard_batch(self.mesh, rows) if self.mesh is not None else rows

    def batch(self, samples: list[dict], shard: bool = False):
        """The batch of ``samples`` on the device (this rank's slice of them
        with ``shard``)."""
        if shard:
            samples = self.shard(samples)
        if self.store is None:
            return to_device(self.packed.batch(samples), self.device)
        return self.store.batch(samples).gather()

    def train_batches(self, n: int):
        """The next ``n`` train batches on the device: gathered from the
        device store, or on the host route built and pinned on a worker
        thread (the sampler's draws too, in the same order) and uploaded
        without blocking."""
        if self.store is None:
            return host_route(lambda: self.shard(self.train_sampler.next_batch()), self.packed, n, self.device)
        return (self.batch(self.train_sampler.next_batch(), shard=True) for _ in range(n))

    @property
    def gp_mesh(self) -> mesh_setup.Mesh | None:
        """The grid when the meshes are row-partitioned, else None."""
        return self.mesh if self.n_gp > 1 else None

    def global_batch(self, batch) -> int:
        """The global batch size of a rank's (or the only) batch."""
        return batch.inputs.shape[0] * (self.mesh.n_data if self.mesh is not None else 1)

    def save(self, path: str, epoch: int) -> None:
        checkpoint.save_checkpoint(path, self.model, self.opt, epoch, self.step)


def gp_order(samples: list[dict], kind: str) -> list[dict]:
    """The samples as ``--graph-parallel`` reads them (JAX's order): RCM
    vertex order and, for Dirac data, the faces sorted by their smallest
    vertex, the coefficients (which bake in the order) recomputed from
    them."""
    out = [rcm_reorder_sample(s) for s in samples]
    if kind == "dirac":
        for s in out:
            s["F"] = np.asarray(s["F"])[dirac_partition.sort_faces_for_partition(s["F"])]
            s["dirac"] = s["flat_dirac"] = None
    return out


def classify(model, batch, deterministic: bool, keep=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(NLL loss, accuracy) of the model's log-probabilities on a batch."""
    logp = model(batch.operator, batch.mask, batch.inputs, deterministic=deterministic, keep=keep)
    return losses.nll_loss(logp, batch.targets), losses.accuracy(logp, batch.targets)


def train_step(model, opt, batch, keep, mesh: mesh_setup.Mesh | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One update with the dropout keep mask ``keep [B, 64]``: the loss, its
    gradients and the Adam step.  Returns the loss and the accuracy (on the
    device); the gradients stay in ``.grad`` until the next step.  With
    ``mesh`` the batch and ``keep`` are this rank's slices: the body runs
    batch-sharded, the gradients are summed over the ranks, and the global
    loss and accuracy are returned; on a graph axis (``--graph-parallel``)
    the batch is this rank's rows, the body runs graph-sharded and ``keep``
    is the whole batch's."""
    return loop.update(model, opt, lambda: classify(model, batch, False, keep), mesh=mesh,
                       vertex=mesh is not None and mesh.n_graph > 1)


@torch.no_grad()
def eval_step(model, batch, mesh: mesh_setup.Mesh | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Loss and accuracy of a test batch; with a graph-parallel ``mesh``
    on this rank's rows (the global values)."""
    return sharded_eval(lambda: classify(model, batch, True), mesh)


def sharded_eval(body, mesh: mesh_setup.Mesh | None) -> tuple[torch.Tensor, ...]:
    """``body()``'s metrics: alone, or on a graph axis each rank's shares
    in the graph-sharded context, summed over the ranks."""
    if mesh is None or mesh.n_graph == 1:
        return body()
    with mesh.context(vertex=True):
        values = body()
    return tuple(parallel_context.total(torch.stack(values), [mesh.graph]).unbind(0))


class MnistTrainer(MeshMnistRun):
    """Data, model, optimizer, samplers, dropout generator and the device
    dataset of one run; ``samples`` (sample dicts) replace the ones the
    flags name, and ``fmt`` is the Laplacian's operator format."""

    def __init__(self, args, samples: list[dict] | None = None, fmt: str = "auto", log=print,
                 mesh: mesh_setup.Mesh | None = None):
        refuse_unported(args, "train_mnist")
        key = model_key(args.model, MODELS)
        super().__init__(args, load_data(args) if samples is None else samples, mnist_batch,
                         "dirac" if key == "dirac" else "lap", fmt, True, MODELS[key](layers=args.layer, dtype=dtype(args)),
                         log, mesh)
        self.last_keep = None

    def update(self, batch, keep=None) -> tuple[torch.Tensor, torch.Tensor]:
        """One update; the keep mask (of the global batch) is drawn from the
        run's generator unless given, and kept as ``last_keep``; a rank
        takes its slice."""
        if keep is None:
            keep = dropout_keep((self.global_batch(batch), WIDTH), self.gen, self.device)
        self.last_keep = keep
        out = train_step(self.model, self.opt, batch, self.shard(keep), self.mesh)
        self.step += 1
        return out

    def train_epoch(self, epoch: int, metrics_log: MetricsLogger | None = None) -> tuple[float, float]:
        """An epoch of updates; logs and returns the mean loss and accuracy."""
        n = self.steps_per_epoch
        sums = torch.zeros(2, device=self.device)
        for batch in self.train_batches(n):
            sums += torch.stack(self.update(batch))
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
            loss, acc = eval_step(self.model, self.batch(self.test_sampler.next_batch()), self.gp_mesh)
            loss_sum += float(loss)
            acc_sum += float(acc)
        loss, acc = loss_sum / self.test_steps, acc_sum / self.test_steps
        self.log(f"Test epoch {epoch}, loss {loss}, acc {acc}")
        if metrics_log is not None:
            metrics_log.write(epoch, "test", loss=loss, acc=acc)
        return loss, acc


def run_rank(mesh: mesh_setup.Mesh | None, args) -> dict:
    """Train on one rank (or alone, ``mesh`` None); rank 0 writes the log,
    the metrics and the checkpoints.  Returns each epoch's train and test
    (loss, accuracy)."""
    rank0 = mesh is None or mesh.rank == 0
    log = make_logger(args.result_prefix, os.path.join(args.result_dir, "log")) if rank0 else (lambda _: None)
    log(args)
    trainer = MnistTrainer(args, log=log, mesh=mesh)
    metrics_log = MetricsLogger(args.result_prefix, os.path.join(args.result_dir, "log")) if rank0 else None
    ckpt = os.path.join(args.result_dir, "pts", f"{args.result_prefix}.pt")
    history: dict = {"train": [], "test": []}
    for epoch in range(args.num_epoch):
        history["train"].append(trainer.train_epoch(epoch, metrics_log))
        history["test"].append(trainer.test_pass(epoch, metrics_log))
        if rank0:
            metrics_log.plot()
            trainer.save(ckpt, epoch)
    return history


def main(argv=None) -> dict:
    """Train; returns each epoch's train and test (loss, accuracy)."""
    args = config.parse_with_config(parser, argv)
    refuse_unported(args, "train_mnist")
    return mesh_setup.run_ranks(run_rank, mesh_setup.axis_ranks(args.data_parallel),
                                mesh_setup.axis_ranks(args.graph_parallel), args.device, args)


if __name__ == "__main__":
    main(sys.argv[1:])
