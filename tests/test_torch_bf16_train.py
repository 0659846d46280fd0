"""The port's five trainers with ``--bf16`` on the CPU against the JAX
package's, step 0: the FAUST siamese trainer in ELL (full logits) and in BSR
(bf16 blocks, the streaming head), with ``--smooth-reg 0.1`` so the SDDMM
runs on bf16 features; the normal trainer in BSR; the ARAP trainer in ELL;
the mesh-MNIST classifier and the VAE (dense, their default at these
sizes).  For each: the first batch as the JAX trainer packs it (BSR blocks
bf16, bit for bit), flax parameters moved off init by seeded noise and
converted in, then the trainer's own ``update`` against the JAX trainer's
objective at ``dtype=bf16`` on the same batch (its dropout mask or noise
handed on):

* the loss within ``LOSS_RTOL`` = 8U (U = 2^-8) of JAX's bf16 loss (its
  sums in fp32, ``fp32_sums``: the same roundings at the same places, fp32
  sums in another order; measured at most 8.6e-3 against JAX's own bf16
  sums, the ARAP step), and fp32;
* the step held unit by unit (``torch_parity.hold_bf16_units``: each layer
  and block of the trainer's model on the arguments and output cotangent of
  its update, against the flax module at the same path);
* the parameters after the update equal optax's update of the port's own
  gradients (3e-7 absolute: two fp32 ulps), the update count 1.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfacenetworks_tpu.cli.common import EpochSampler as JEpochSampler
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.models import SiameseModel as JSiameseModel
from surfacenetworks_tpu.models import mnist_models as jmnist
from surfacenetworks_tpu.models import normal_models as jnormal
from surfacenetworks_tpu.models import vae as jvae
from surfacenetworks_tpu.sparse import stack_operators as jstack_operators
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.cli import train_arap as tarap_cli
from surfacenetworks_tpu_torch.cli import train_correspondence as tcorr_cli
from surfacenetworks_tpu_torch.cli import train_mnist as tmnist_cli
from surfacenetworks_tpu_torch.cli import train_normal as tnormal_cli
from surfacenetworks_tpu_torch.cli import train_vae as tvae_cli
from surfacenetworks_tpu_torch.convert import params_from_flax

from torch_parity import (BF16, BF16_U, f64, fp32_sums, hold_bf16_units, perturbed_params, random_params, to_jax,
                          unit_calls)

LOSS_RTOL = 8 * BF16_U
ADAM_ATOL = 3e-7
FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _jax_loss(obj, params) -> tuple:
    """The JAX bf16 objective at ``params`` (with fp32 sums, as the units
    are held): its loss and whatever else it returns."""
    with fp32_sums():
        out = jax.jit(obj)(to_jax(params))
    return (float(out[0]), out[1]) if isinstance(out, tuple) else (float(out), None)


def _hold_step(what: str, model, state: dict, loss, jloss: float, recorded, obj, params, tx) -> None:
    """The port's step (``loss``, ``model``'s gradients and its parameters
    after the update from ``state``; ``recorded`` the ``unit_calls`` of its
    update) against the JAX bf16 objective ``obj`` at ``params`` (its loss
    ``jloss``); ``tx`` the trainer's optax optimizer."""
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    rel = abs(float(loss) - jloss) / abs(jloss)
    assert rel <= LOSS_RTOL, f"{what}: loss {float(loss)} vs JAX's bf16 {jloss}: rel {rel:.3e}"
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads.items():
        assert g is not None and g.dtype == torch.float32 and torch.isfinite(g).all(), f"{what} {k}"
    hold_bf16_units(what, *recorded, obj, to_jax(params))
    tg = {k: g.numpy() for k, g in grads.items()}
    upd, _ = tx.update(to_jax(tg), tx.init(to_jax(state)), to_jax(state))
    new = optax.apply_updates(to_jax(state), upd)
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32
        err = float(np.abs(p.detach().numpy() - np.asarray(new[k])).max())
        assert err <= ADAM_ATOL, f"{what} {k}: after one Adam update max|err|={err:.3e}"


def _same_blocks(op, jop) -> None:
    for part in ("fwd", "bwd"):
        got, ref = getattr(op, part).block_vals, getattr(jop, part).block_vals
        assert got.dtype == torch.bfloat16 and ref.dtype == BF16, part
        np.testing.assert_array_equal(f64(got), np.asarray(ref, np.float64), err_msg=part)


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_faust_bf16_step_matches_jax(fmt, tmp_path):
    """The FAUST trainer (Lap-2 trunk, dcel + 0.1 x smoothness) on scans 0
    and 1 of the committed fixtures; ELL with the full-logits head, BSR with
    the streaming head."""
    argv = ["--datapath", str(FIXTURES / "faust"), "--device", "cpu", "--layer", "2", "--operator-format", fmt,
            "--smooth-reg", "0.1", "--num-updates", "1", "--num-epoch", "1", "--bf16", "--result-dir", str(tmp_path),
            "--streaming-head" if fmt == "bsr" else "--no-streaming-head"]
    trainer = tcorr_cli.CorrespondenceTrainer(tcorr_cli.parser.parse_args(argv), log=lambda _: None)
    data = [jdatasets.load_faust_npz(str(p)) for p in sorted((FIXTURES / "faust").glob("*.npz"))]
    if fmt == "bsr":
        data = [jbat.rcm_reorder_sample(s) for s in data]
    buckets = jbat.Buckets.for_samples(data, multiple=128 if fmt == "bsr" else 8)
    if fmt == "bsr":
        jbat.fit_bsr_k([s["L"] for s in data], buckets)
    N = buckets.n_vertices
    batches = {dt: [jbat.correspondence_batch(s, buckets, fmt=fmt, op_dtype=dt) for s in data[:2]]
               for dt in (None, BF16)}
    regs = [jax.tree_util.tree_map(jnp.asarray, jstack_operators([jbat._fixed_k_operator(s["L"], buckets, N)]))
            for s in data[:2]]
    if fmt == "bsr":
        _same_blocks(trainer.dev_sample(0)["op"], batches[BF16][0].operator)
    tgt = jnp.asarray(trainer.pair_target(0, 1).numpy())
    rots = (0.7, 0.0, 2.3, 0.0)
    xs = [jnp.asarray(np.asarray(b.inputs) @ tcorr_cli.rot_matrix(rots[2 * i], rots[2 * i + 1], "cpu").numpy())
          for i, b in enumerate(batches[None])]

    def objective(model, bs):
        ops = [(jax.tree_util.tree_map(jnp.asarray, b.operator), jnp.asarray(b.mask)) for b in bs]

        def obj(p):
            fa, fb = model.apply({"params": p}, ops[0], ops[1], *xs, method=JSiameseModel.features)
            if fmt == "bsr":  # as the JAX trainer: the head in fp32 on the (bf16) features
                loss = jlosses.corr_dcel_streaming(fa[0].astype(jnp.float32), fb[0].astype(jnp.float32), tgt)
            else:
                loss = jlosses.corr_delta_cross_entropy_from_target(
                    jnp.einsum("bnc,bmc->bnm", fa, fb, preferred_element_type=jnp.float32)[0], tgt)
            return loss + 0.1 * (jlosses.corr_feature_smoothness(regs[0], fa)
                                 + jlosses.corr_feature_smoothness(regs[1], fb))
        return obj

    j16 = JSiameseModel(model="lap", layers=2, dtype=BF16)
    op0 = (jax.tree_util.tree_map(jnp.asarray, batches[BF16][0].operator), jnp.asarray(batches[BF16][0].mask))
    params = perturbed_params(j16.init(jax.random.key(0), op0, op0, xs[0], xs[0])["params"], 15)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    obj = objective(j16, batches[BF16])
    jloss, _ = _jax_loss(obj, params)
    with unit_calls(trainer.model) as recorded:
        loss = trainer.update(0, 1, rots)
    assert trainer.step == 1
    _hold_step(f"FAUST {fmt}", trainer.model, state, loss, jloss, recorded, obj, params,
               joptim.adam(1e-3, weight_decay=1e-5))


def test_normal_bsr_bf16_step_matches_jax(tmp_path):
    """The normal trainer (LapDeepModel-2, batch 2) in BSR on the fixture
    meshes: bf16 blocks, the cosine loss."""
    from test_torch_normal_train import _argv, _jax_run

    trainer = tnormal_cli.NormalTrainer(tnormal_cli.parser.parse_args(
        _argv("bsr", tmp_path, "--device", "cpu", "--bf16")), log=lambda _: None)
    train, _, jbuckets = _jax_run("bsr", tmp_path)
    samples = trainer.train_sampler.next_batch()
    batch = trainer.batch(samples)
    by_name = {s["name"]: s for s in train}
    jsamples = [by_name[s["name"]] for s in samples]
    jb = {dt: jbat.laplacian_batch(jsamples, jbuckets, fmt="bsr", op_dtype=dt) for dt in (None, BF16)}
    _same_blocks(batch.operator, jb[BF16].operator)
    np.testing.assert_array_equal(batch.inputs.numpy(), np.asarray(jb[None].inputs))

    def objective(model, b):
        op, mask = jax.tree_util.tree_map(jnp.asarray, b.operator), jnp.asarray(b.mask)

        def obj(p):
            out = model.apply({"params": p}, op, mask, jnp.asarray(b.inputs))
            return jlosses.normal_cosine_loss(out, mask, jnp.asarray(b.targets))
        return obj

    j16 = jnormal.LapDeepModel(3, 3, layers=2, dtype=BF16)
    b0 = jb[BF16]
    params = perturbed_params(j16.init(jax.random.key(0), jax.tree_util.tree_map(jnp.asarray, b0.operator),
                                       jnp.asarray(b0.mask), jnp.asarray(b0.inputs))["params"], 31)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    obj = objective(j16, jb[BF16])
    jloss, _ = _jax_loss(obj, params)
    with unit_calls(trainer.model) as recorded:
        loss, mad = trainer.update(batch)
    assert trainer.step == 1 and np.isfinite(float(mad))
    _hold_step("normal bsr", trainer.model, state, loss, jloss, recorded, obj, params, joptim.adam(1e-3))


def test_arap_bf16_step_matches_jax(tmp_path):
    """The ARAP trainer (Model-2, batch 4) in ELL on the fixture sequences:
    bf16 x into the ELL applies, the masked smooth-L1 loss."""
    from surfacenetworks_tpu.cli import train_arap as jarap_cli

    argv = ["--data-path", str(FIXTURES / "arap"), "--layer", "2", "--batch-size", "4", "--num-epoch", "1",
            "--num-updates", "6", "--result-dir", str(tmp_path), "--device", "cpu", "--bf16"]
    trainer = tarap_cli.ArapTrainer(tarap_cli.parser.parse_args(argv), log=lambda _: None)
    picks = trainer.sample_train_picks()
    batch = trainer.batch(picks)
    files = sorted(str(p) for p in (FIXTURES / "arap").glob("*.npy"))
    jseqs = [jdatasets.load_arap_sequence(f) for f in files]
    jbk = jbat.Buckets.for_samples([{"V": s[0]["V"], "F": s[0]["F"]} for s in jseqs])
    jb = jbat.arap_batch(jseqs, picks, jbk, model="lap", fmt="ell")
    np.testing.assert_array_equal(batch.inputs.numpy(), np.asarray(jb.inputs))
    op, mask = jax.tree_util.tree_map(jnp.asarray, jb.operator), jnp.asarray(jb.mask)

    def objective(model):
        def obj(p):
            out = model.apply({"params": p}, op, mask, jnp.asarray(jb.inputs))
            return jlosses.smooth_l1_sum(out * jnp.broadcast_to(mask, out.shape), jnp.asarray(jb.targets), 4)
        return obj

    j16 = jarap_cli.MODELS["lap"](layers=2, dtype=BF16)
    params = perturbed_params(j16.init(jax.random.key(0), op, mask, jnp.asarray(jb.inputs))["params"], 31)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    obj = objective(j16)
    jloss, _ = _jax_loss(obj, params)
    with unit_calls(trainer.model) as recorded:
        loss = trainer.update(batch)
    assert trainer.step == 1
    _hold_step("ARAP ell", trainer.model, state, loss, jloss, recorded, obj, params,
               joptim.adam(joptim.epoch_halving_schedule(1e-3, 6, 50, 10), weight_decay=1e-5))


def _mesh_mnist(family: str, tmp_path):
    """The mesh-MNIST trainer of ``family`` (2 layers, batch 4, the default
    format: dense here) with ``--bf16`` on the fixture, its first batch, and
    the JAX trainer's first batch (the same samples)."""
    cli = tmnist_cli if family == "mnist" else tvae_cli
    argv = ["--device", "cpu", "--data-path", str(FIXTURES / "mnist_plus.np"), "--batch-size", "4", "--num-epoch", "1",
            "--result-dir", str(tmp_path), "--bf16", "--layer" if family == "mnist" else "--num-layers", "2"]
    trainer = (cli.MnistTrainer if family == "mnist" else cli.VaeTrainer)(cli.parser.parse_args(argv),
                                                                         log=lambda _: None)
    batch = trainer.batch(trainer.train_sampler.next_batch())
    j = jdatasets.load_mnist_mesh_pickle(str(FIXTURES / "mnist_plus.np"))
    jbk = jbat.Buckets.for_samples(j, multiple=8)
    sep = max(1, int(len(j) * 0.8))
    first = JEpochSampler(j[:sep], 4, seed=17).next_batch()
    jb = (jbat.mnist_batch if family == "mnist" else jbat.vae_batch)(first, jbk, model="lap")
    np.testing.assert_array_equal(batch.inputs.numpy(), np.asarray(jb.inputs))
    return trainer, batch, jb


def test_mnist_bf16_step_matches_jax(tmp_path):
    """The classifier (Model-2) with dropout: JAX's bf16 mask (read from its
    Dropout output) handed to the port's update; the NLL loss."""
    trainer, batch, jb = _mesh_mnist("mnist", tmp_path)
    op, mask, x = jnp.asarray(jb.operator), jnp.asarray(jb.mask), jnp.asarray(jb.inputs)

    def objective(model):
        def obj(p):
            logp, st = model.apply({"params": p}, x, op, mask, deterministic=False,
                                   rngs={"dropout": jax.random.key(9)}, capture_intermediates=True,
                                   mutable=["intermediates"])
            dropped = st["intermediates"]["head"]["Dropout_0"]["__call__"][0]
            return jlosses.nll_loss(logp, jnp.asarray(jb.targets)), dropped
        return obj

    j16 = jmnist.Model(layers=2, dtype=BF16)
    shapes = jax.eval_shape(lambda: j16.init(jax.random.key(0), x, op, mask, deterministic=True))["params"]
    params = random_params(shapes, 5)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    obj = objective(j16)
    jloss, dropped = _jax_loss(obj, params)
    keep = torch.from_numpy(np.asarray(dropped.astype(jnp.float32)) != 0).float()
    with unit_calls(trainer.model) as recorded:
        loss, acc = trainer.update(batch, keep=keep)
    assert trainer.step == 1 and 0.0 <= float(acc) <= 1.0
    _hold_step("mnist dense", trainer.model, state, loss, jloss, recorded, obj, params,
               joptim.adam(1e-3, weight_decay=1e-5))


def test_vae_bf16_step_matches_jax(tmp_path):
    """The VAE (LapVAE-2) at KLD weight 0.3: JAX's noise (fp32, drawn in the
    latent's dtype and read back as ``(z - mu) / exp(logvar / 2)``) handed to
    the port's update; the ELBO."""
    trainer, batch, jb = _mesh_mnist("vae", tmp_path)
    arrays = (jnp.asarray(jb.inputs), jnp.asarray(jb.aux["flat_inputs"]), jnp.asarray(jb.operator),
              jnp.asarray(jb.aux["flat_operator"]), jnp.asarray(jb.mask))

    def objective(model):
        def obj(p):
            res = model.apply({"params": p}, *arrays, rngs={"sample": jax.random.key(9)})
            bce, kld = jlosses.vae_elbo_terms(res[0], res[1], arrays[-1], arrays[0], *res[2:])
            return bce + kld * 0.3, res
        return obj

    j16 = jvae.LapVAE(num_layers=2, dtype=BF16)
    shapes = jax.eval_shape(lambda: j16.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                                             *arrays))["params"]
    params = random_params(shapes, 6)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    obj = objective(j16)
    jloss, res = _jax_loss(obj, params)
    z, mu, logvar = (np.asarray(r, np.float64) for r in res[2:])
    assert res[0].dtype == res[2].dtype == jnp.float32
    eps = torch.from_numpy((z - mu) / np.exp(logvar / 2)).float()
    with unit_calls(trainer.model) as recorded:
        loss, bce, kld = trainer.update(batch, 0.3, eps=eps)
    assert trainer.step == 1 and np.isfinite([float(bce), float(kld)]).all()
    _hold_step("VAE dense", trainer.model, state, loss, jloss, recorded, obj, params,
               joptim.adam(1e-3, weight_decay=1e-5))
