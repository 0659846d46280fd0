"""Surface-Networks VAE trainer on one device (counterpart of
``surfacenetworks_tpu/cli/train_vae.py``: its single-device path).

Models ``lap`` and ``dirac`` (any name starting with ``dir``).  The loss is
the ELBO: the masked Gaussian reconstruction NLL plus the KLD weighted by
``min(epoch / 10, 1)`` (the 10-epoch warm-up).  Data: ``--synthetic N``
height fields or a ``--data-path`` pickle in the reference's
``train_plus.np`` layout; anything else exits.  Runs on ``cuda`` unless
given ``--device cpu``::

    python -m surfacenetworks_tpu_torch.cli.train_vae --synthetic 320 --num-epoch 2
    python -m surfacenetworks_tpu_torch.cli.train_vae --device cpu \\
        --data-path tests/fixtures/mnist_plus.np --num-layers 2 --num-epoch 1 --batch-size 4 --dump-ply 2

As in the JAX trainer: the split, bucket, samplers, steps per epoch and
optimizer are the classifier's (``cli/train_mnist.py``); the test pass
takes the ELBO with KLD weight 1 and sampled noise, without an update (and,
here, without a gradient); the log lines ``Train epoch ...`` and ``Test
epoch ...`` (loss, bce, kld) in ``log/<prefix>.log``,
``log/<prefix>.metrics.jsonl`` (no plot) and a checkpoint each epoch at
``pts/<prefix>.pt`` in the port's format.  With ``--dump-ply N`` each epoch
decodes a fixed noise ``[B, 1, 100]``, repeated over the vertices, on the
flat meshes of the next test batch and writes the first N as
``results_<model>/samples_epoch_{k:03d}_{epoch:03d}.ply``.  The fixed noise
comes from ``torch.Generator().manual_seed(999)`` and the reparametrisation
noise from a ``torch.Generator`` seeded with ``--seed`` on the device, so
both differ from the JAX package's draws.  Every sample is packed once and
the dataset uploaded once unless ``--no-device-store``.  ``VaeTrainer`` also
takes samples and an operator format from code.  ``--bf16`` trains in mixed
precision as the JAX trainer does (bf16 blocks and convolutions; the latent
heads, the noise, the reconstruction mean and the ELBO fp32).  Flags of the
JAX trainer that later slices bring are refused when given.
"""

from __future__ import annotations

import argparse
import os
import platform
import sys

import numpy as np
import torch

from surfacenetworks_tpu_torch import geometry as geo
from surfacenetworks_tpu_torch.cli.common import MetricsLogger, make_logger
from surfacenetworks_tpu_torch.cli.train_mnist import MeshMnistRun, dtype, refuse_unported
from surfacenetworks_tpu_torch.data import datasets, vae_batch
from surfacenetworks_tpu_torch.data.pipeline import to_device
from surfacenetworks_tpu_torch.models.vae import LATENT, MODELS
from surfacenetworks_tpu_torch.train import losses

parser = argparse.ArgumentParser(description="Mesh VAE (PyTorch, one device)")
parser.add_argument("--batch-size", type=int, default=64)
parser.add_argument("--num-epoch", type=int, default=1000)
parser.add_argument("--model", default="lap", help="lap | dirac")
parser.add_argument("--num-layers", type=int, default=5)
parser.add_argument("--synthetic", type=int, default=0)
parser.add_argument("--data-path", default=None)
parser.add_argument("--lr", type=float, default=1e-3)
parser.add_argument("--dump-ply", type=int, default=0, help="dump N sample PLYs per epoch")
parser.add_argument("--result-prefix", default="vae")
parser.add_argument("--result-dir", default="results/mesh_mnist_vae_torch")
parser.add_argument("--seed", type=int, default=17)
parser.add_argument("--no-device-store", action="store_true",
                    help="assemble every batch on the host and upload it")
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
parser.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: bf16 activations and matmuls, fp32 parameters, "
                         "optimizer state and losses")
# flags of the JAX trainer that later slices bring: refused when given
parser.add_argument("--data-parallel", type=int, default=0)
parser.add_argument("--graph-parallel", type=int, default=0)
parser.add_argument("--config", default=None)
parser.add_argument("--preset", default=None)

FIXED_NOISE_SEED = 999


def load_data(args) -> list[dict]:
    if args.synthetic:
        return datasets.synthetic_mnist_dataset(args.synthetic, seed=args.seed)
    if args.data_path:
        return datasets.load_mnist_mesh_pickle(args.data_path)
    raise SystemExit("provide --synthetic N or --data-path train_plus.np")


def kld_weight(epoch: int) -> float:
    """The KLD's weight in the train loss: the 10-epoch linear warm-up."""
    return min(epoch / 10.0, 1.0)


def elbo(model, batch, eps, kw: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(bce + kw * kld, bce, kld) of the model on a batch with the
    reparametrisation noise ``eps [B, LATENT]``."""
    recon_mu, recon_logvar, z, mu, logvar = model(batch.inputs, batch.aux["flat_inputs"], batch.operator,
                                                  batch.aux["flat_operator"], batch.mask, eps=eps)
    bce, kld = losses.vae_elbo_terms(recon_mu, recon_logvar, batch.mask, batch.inputs, z, mu, logvar)
    return bce + kld * kw, bce, kld


def train_step(model, opt, batch, eps, kw: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update: the ELBO, its gradients and the Adam step.  Returns the
    loss, bce and kld (on the device); the gradients stay in ``.grad``."""
    opt.zero_grad(set_to_none=True)
    loss, bce, kld = elbo(model, batch, eps, kw)
    loss.backward()
    opt.step()
    return loss.detach(), bce.detach(), kld.detach()


@torch.no_grad()
def eval_step(model, batch, eps) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return elbo(model, batch, eps, 1.0)


class VaeTrainer(MeshMnistRun):
    """Data, model, optimizer, samplers, noise generators and the device
    dataset of one run; ``samples`` replace the ones the flags name, and
    ``fmt`` is the Laplacians' operator format."""

    def __init__(self, args, samples: list[dict] | None = None, fmt: str = "auto", log=print):
        refuse_unported(args, "train_vae")
        key = "dirac" if args.model.startswith("dir") else "lap"  # any other name is lap, as in JAX
        super().__init__(args, load_data(args) if samples is None else samples, vae_batch, key, fmt,
                         not args.no_device_store, MODELS[key](num_layers=args.num_layers, dtype=dtype(args)), log)
        gen = torch.Generator().manual_seed(FIXED_NOISE_SEED)
        self.fixed_noise = torch.randn(args.batch_size, 1, LATENT, generator=gen).to(self.device)
        self.last_eps = None

    def draw_eps(self, batch) -> torch.Tensor:
        return torch.randn(batch.inputs.shape[0], LATENT, generator=self.gen, device=self.device)

    def update(self, batch, kw: float, eps=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One update at KLD weight ``kw``; ``eps`` is drawn from the run's
        generator unless given, and kept as ``last_eps``."""
        self.last_eps = self.draw_eps(batch) if eps is None else eps
        out = train_step(self.model, self.opt, batch, self.last_eps, kw)
        self.step += 1
        return out

    def train_epoch(self, epoch: int, metrics_log: MetricsLogger | None = None) -> tuple[float, ...]:
        """An epoch of updates at ``kld_weight(epoch)``; logs and returns the
        mean loss, bce and kld."""
        n, kw = self.steps_per_epoch, kld_weight(epoch)
        sums = torch.zeros(3, device=self.device)
        for _ in range(n):
            sums += torch.stack(self.update(self.batch(self.train_sampler.next_batch()), kw))
        loss, bce, kld = (v / n for v in sums.tolist())
        self.log(f"Train epoch {epoch}, loss {loss}, bce {bce}, kld {kld}")
        if metrics_log is not None:
            metrics_log.write(epoch, "train", loss=loss, bce=bce, kld=kld)
        return loss, bce, kld

    def test_pass(self, epoch: int, metrics_log: MetricsLogger | None = None) -> tuple[float, ...]:
        """The ELBO at KLD weight 1 over the test batches (the sampler goes
        on where the last pass ended); logs and returns the mean loss, bce
        and kld."""
        sums = torch.zeros(3, device=self.device)
        for _ in range(self.test_steps):
            batch = self.batch(self.test_sampler.next_batch())
            sums += torch.stack(eval_step(self.model, batch, self.draw_eps(batch)))
        loss, bce, kld = (v / self.test_steps for v in sums.tolist())
        self.log(f"Test epoch {epoch}, loss {loss}, bce {bce}, kld {kld}")
        if metrics_log is not None:
            metrics_log.write(epoch, "test", loss=loss, bce=bce, kld=kld)
        return loss, bce, kld

    @torch.no_grad()
    def dump_samples(self, epoch: int, n: int, out_dir: str) -> list[str]:
        """Decode the fixed noise on the next test batch's flat meshes and
        write the first ``n`` as PLYs (padded rows and faces, as the JAX
        trainer writes them); returns their paths."""
        host = vae_batch(self.test_sampler.next_batch(), self.buckets, model=self.kind, fmt=self.fmt)
        b = to_device(host, self.device)
        B, N = b.inputs.shape[:2]
        noise = self.fixed_noise[:B].expand(-1, N, -1)
        fake, _ = self.model.decode(b.aux["flat_inputs"], noise, b.aux["flat_operator"], b.mask)
        fake = fake.cpu().numpy()
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for k in range(min(n, B)):
            path = os.path.join(out_dir, f"samples_epoch_{k:03d}_{epoch:03d}.ply")
            faces = host.faces[k].numpy() if host.faces is not None else np.zeros((0, 3), np.int32)
            geo.save_ply(path, fake[k], faces)
            paths.append(path)
        return paths


def main(argv=None) -> dict:
    """Train; returns each epoch's train and test (loss, bce, kld)."""
    args = parser.parse_args(argv)
    log = make_logger(args.result_prefix, os.path.join(args.result_dir, "log"))
    log(args)
    log(f"hostname {platform.node()}")
    trainer = VaeTrainer(args, log=log)
    metrics_log = MetricsLogger(args.result_prefix, os.path.join(args.result_dir, "log"))
    ckpt = os.path.join(args.result_dir, "pts", f"{args.result_prefix}.pt")
    history: dict = {"train": [], "test": []}
    for epoch in range(args.num_epoch):
        history["train"].append(trainer.train_epoch(epoch, metrics_log))
        history["test"].append(trainer.test_pass(epoch, metrics_log))
        if args.dump_ply:
            trainer.dump_samples(epoch, args.dump_ply, os.path.join(args.result_dir, f"results_{args.model}"))
        trainer.save(ckpt, epoch)
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
