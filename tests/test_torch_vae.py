"""The port's Surface-Networks VAE slice against the JAX package on the CPU:
``vae_batch`` (dense, ELL, Dirac, with ``aux``) and the device dataset,
``log_normal_diag`` and ``vae_elbo_terms``, ``LapVAE`` and ``DirVAE`` (the
forward, the gradients of the ELBO and ``decode``), one update of the
trainer per model on ``tests/fixtures/mnist_plus.np``, the device store
against the host path, and ``main`` on the CPU (with ``--dump-ply``) and its
refused flags.

Randomness is handed in on both sides: JAX's reparametrisation noise is
``(z - mu) / exp(logvar / 2)`` from its returned tuple, given to the port
as ``eps``; ``decode`` takes the same noise in both packages.  The JAX
package draws other noise under ``enable_x64`` than without it, so each
dtype's run hands its own on.

Tolerances, stated per case: batches exact (the same NumPy code); losses
1e-6 of ``max|ref|``; models, ``decode`` and the step in fp64 (JAX under
``enable_x64``) 1e-6 of ``max|ref|``; in fp32 each gradient no farther
(relative Frobenius) from the port's fp64 result on the same noise than
FP32_RATIO x the JAX package's own fp32 distance, plus 1e-6; the fp32 loss
within 1e-4 of JAX's; the parameters after one Adam update in fp64 within
1e-6 of JAX's wherever Adam's first step is well conditioned
(``torch_parity.hold_adam_update``), in fp32 within 3e-7 of optax's update
of the port's gradients."""

import copy
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.cli.common import EpochSampler as JEpochSampler
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.models import vae as jvae
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu_torch import geometry as tgeo
from surfacenetworks_tpu_torch.cli import train_vae as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import batching as tbat
from surfacenetworks_tpu_torch.data import datasets as tdatasets
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples
from surfacenetworks_tpu_torch.models import vae as tvae
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as toptim

from torch_parity import (assert_close, batch_as, config_flag_taken, hold_adam_update, hold_grads, jax_adam_step,
                          random_params, rel_fro, same_operator, same_tensors, state64, to_jax)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "mnist_plus.np"
LOSS_RTOL = 1e-6
FP64_RTOL = 1e-6
STEP_FP32_RTOL = 1e-4
ADAM_ATOL = 3e-7  # two fp32 ulps at |p| < 2: the update's arithmetic in another order
FP32_RATIO = 10  # as in tests/test_torch_arap.py: rounding noise whose ratio is a matter of summation order
LAYERS = {"lap": 2, "dirac": 1}  # the JAX package's Dirac VAE takes 10 s per compile on the CPU at 2
BATCH = 4
KW = 0.3  # the KLD weight of epoch 3: both ELBO terms reach the gradients
JMODELS = {"lap": jvae.LapVAE, "dirac": jvae.DirVAE}
OUTPUTS = ("recon_mu", "recon_logvar", "z", "mu", "logvar")


@pytest.fixture(scope="module")
def data():
    t, j = tdatasets.load_mnist_mesh_pickle(str(FIXTURE)), jdatasets.load_mnist_mesh_pickle(str(FIXTURE))
    return t, j, tbat.Buckets.for_samples(t, multiple=8), jbat.Buckets.for_samples(j, multiple=8)


@pytest.mark.parametrize("case", ["dense", "ell", "dirac"])
def test_vae_batch_and_device_store_match_jax(case, data):
    """``vae_batch`` of five samples (``fmt='auto'`` resolves to dense):
    inputs, targets (the inputs), mask, faces, both operators and the flat
    inputs in ``aux`` equal the JAX package's bit for bit; a device dataset
    of single-sample packings gathers the same batch, ``aux`` included."""
    t, j, tbk, jbk = data
    model, fmt = ("dirac", "ell") if case == "dirac" else ("lap", "auto" if case == "dense" else "ell")
    pick = [2, 7, 0, 0, 4]
    tb = tbat.vae_batch([t[i] for i in pick], tbk, model=model, fmt=fmt)
    jb = jbat.vae_batch([j[i] for i in pick], jbk, model=model, fmt=fmt)
    for k in ("inputs", "targets", "mask", "faces"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    assert sorted(tb.aux) == sorted(jb.aux) == ["flat_inputs", "flat_operator"]
    np.testing.assert_array_equal(tb.aux["flat_inputs"].numpy(), jb.aux["flat_inputs"])
    assert (tb.aux["flat_inputs"][..., 2] == 0).all()
    same_operator(tb.operator, jb.operator, case)
    same_operator(tb.aux["flat_operator"], jb.aux["flat_operator"], case)
    store = DeviceDataset.build(t, PackedSamples(lambda s: tbat.vae_batch([s], tbk, model=model, fmt=fmt)), "cpu")
    same_tensors(store.batch([t[i] for i in pick]).gather(), tb)


def test_vae_elbo_terms_match_jax():
    """``log_normal_diag`` and both ELBO terms, and their gradients in every
    input, on a batch of 3 whose mask pads 5 of 20 rows."""
    rng = np.random.default_rng(4)
    arr = lambda *shape: rng.normal(size=shape).astype(np.float32)
    x, rm, rl = arr(3, 20, 3), arr(3, 20, 3), 0.3 * arr(3, 20, 3)
    z, mu, lv = arr(3, 100), arr(3, 100), 0.5 * arr(3, 100)
    mask = np.ones((3, 20, 1), np.float32)
    mask[:, 15:] = 0.0
    assert_close(tlosses.log_normal_diag(*map(torch.from_numpy, (z, mu, lv))).numpy(),
                 jlosses.log_normal_diag(*map(jnp.asarray, (z, mu, lv))), LOSS_RTOL, "log density")
    args = (rm, rl, mask, x, z, mu, lv)

    def jterms(rm, rl, x, z, mu, lv):
        bce, kld = jlosses.vae_elbo_terms(rm, rl, jnp.asarray(mask), x, z, mu, lv)
        return bce + 0.7 * kld, (bce, kld)

    (_, (jbce, jkld)), jg = jax.value_and_grad(jterms, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, (rm, rl, x, z, mu, lv)))
    ts = [torch.tensor(a, requires_grad=True) for a in (rm, rl, x, z, mu, lv)]
    bce, kld = tlosses.vae_elbo_terms(ts[0], ts[1], torch.from_numpy(mask), *ts[2:])
    (bce + 0.7 * kld).backward()
    assert_close(bce.detach().numpy(), jbce, LOSS_RTOL, "bce")
    assert_close(kld.detach().numpy(), jkld, LOSS_RTOL, "kld")
    for name, t, g in zip(("recon_mu", "recon_logvar", "x", "z", "mu", "logvar"), ts, jg):
        assert_close(t.grad.numpy(), g, LOSS_RTOL, f"gradient in {name}")
    assert (ts[0].grad[:, 15:] == 0).all()
    assert ttrain.kld_weight(0) == 0.0 and ttrain.kld_weight(3) == 0.3 and ttrain.kld_weight(12) == 1.0


def _argv(tmp_path, *extra, model: str = "lap"):
    return ["--device", "cpu", "--data-path", str(FIXTURE), "--model", model, "--num-layers", str(LAYERS[model]),
            "--batch-size", str(BATCH), "--num-epoch", "1", "--result-dir", str(tmp_path), *extra]


def _trainer(tmp_path, *extra, model: str = "lap"):
    return ttrain.VaeTrainer(ttrain.parser.parse_args(_argv(tmp_path, *extra, model=model)), log=lambda _: None)


def _jax_arrays(jb, dtype):
    ops = jax.tree_util.tree_map(jnp.asarray, (jb.operator, jb.aux["flat_operator"]))
    return (jnp.asarray(jb.inputs, dtype), jnp.asarray(jb.aux["flat_inputs"], dtype), *ops, jnp.asarray(jb.mask, dtype))


@pytest.fixture(scope="module")
def jax_steps(data):
    """``run(model)``: the JAX package's step on its trainer's first batch
    (``model.apply`` with the sample rng, ``vae_elbo_terms`` at KLD weight
    KW and ``optim.adam(1e-3, weight_decay=1e-5)`` as its trainer builds
    them) with seeded params, in fp64 (under ``enable_x64``) and fp32: each
    run's loss, outputs, gradients, parameters after the update and its
    noise ``eps``; and for ``lap`` ``decode`` in fp64 on a seeded noise.
    Cached per model."""
    _, j, _, jbk = data
    cache = {}

    def run(name):
        if name in cache:
            return cache[name]
        kind = "dirac" if name == "dirac" else "lap"
        sep = max(1, int(len(j) * 0.8))
        jb = jbat.vae_batch(JEpochSampler(j[:sep], BATCH, seed=17).next_batch(), jbk, model=kind)
        jmod = JMODELS[name](num_layers=LAYERS[name])
        shapes = jax.eval_shape(lambda: jmod.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                                                  *_jax_arrays(jb, jnp.float32)))["params"]
        params = random_params(shapes, 6)
        out = {"params": params, "batch": jb}
        for dtype in (jnp.float64, jnp.float32):
            def objective(p, arrays):
                res = jmod.apply({"params": p}, *arrays, rngs={"sample": jax.random.key(9)})
                bce, kld = jlosses.vae_elbo_terms(res[0], res[1], arrays[-1], arrays[0], *res[2:])
                return bce + kld * KW, res

            def step(p, arrays):
                (loss, res), g = jax.value_and_grad(objective, has_aux=True)(p, arrays)
                return loss, res, g, jax_adam_step(g, p)

            with jax.enable_x64(dtype == jnp.float64):
                p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
                arrays = _jax_arrays(jb, dtype)
                loss, res, g, new = jax.jit(step)(p, arrays)
                res = dict(zip(OUTPUTS, (np.asarray(r, np.float64) for r in res)))
                out[np.dtype(dtype).name] = {
                    "loss": float(loss), "outputs": res, "grads": state64(g), "new": state64(new),
                    "eps": (res["z"] - res["mu"]) / np.exp(res["logvar"] / 2)}
                if dtype == jnp.float64 and name == "lap":  # a Dirac decode would take another 8 s to compile
                    noise = np.random.default_rng(2).normal(size=(BATCH, 1, tvae.LATENT))
                    noise = np.repeat(noise, jb.inputs.shape[1], axis=1)
                    fake = jax.jit(lambda p, fx, n, fop, m: jmod.apply({"params": p}, fx, n, fop, m,
                                                                        method=type(jmod).decode))(
                        p, arrays[1], jnp.asarray(noise), arrays[3], arrays[4])
                    out["decode"] = {"noise": noise, "mu": np.asarray(fake[0]), "logvar": np.asarray(fake[1])}
        cache[name] = out
        return out

    return run


def _port_run(model, batch, eps, dtype):
    """The port's outputs, ELBO at KLD weight KW and its gradients on
    ``batch`` with the noise ``eps``, in ``dtype``."""
    m = copy.deepcopy(model).to(dtype)
    b = batch_as(batch, dtype)
    res = m(b.inputs, b.aux["flat_inputs"], b.operator, b.aux["flat_operator"], b.mask,
            eps=torch.from_numpy(eps).to(dtype))
    bce, kld = tlosses.vae_elbo_terms(res[0], res[1], b.mask, b.inputs, *res[2:])
    (bce + kld * KW).backward()
    return ({k: r.detach().numpy() for k, r in zip(OUTPUTS, res)},
            {k: p.grad.numpy() for k, p in m.named_parameters()})


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_vae_matches_jax(name, jax_steps, tmp_path):
    """``LapVAE`` (2 layers) and ``DirVAE`` (1) on the trainer's first fixture
    batch (dense; Dirac tables for ``dirac``) with seeded flax params
    converted by ``params_from_flax(like=)`` (the decoder's bare
    ``fc_logvar`` and the encoder's Dense of the same name included), JAX's
    noise handed in: in fp64 the five outputs and every parameter gradient
    of the ELBO within 1e-6 of ``max|ref|``; in fp32 (JAX's fp32 noise) each
    gradient within FP32_RATIO x JAX's own distance of the port's fp64
    result, plus 1e-6."""
    ref = jax_steps(name)
    trainer = _trainer(tmp_path, model=name)
    state = params_from_flax(ref["params"], like=trainer.model)
    assert state["decoder.fc_logvar"].shape == (1, 1, 1) and state["encoder.fc_logvar.weight"].shape == (100, 128)
    trainer.model.load_state_dict(state, strict=True)
    batch = trainer.batch(trainer.train_sampler.next_batch())
    r64, r32 = ref["float64"], ref["float32"]
    out64, g64 = _port_run(trainer.model, batch, r64["eps"], torch.float64)
    for k in OUTPUTS:
        assert_close(out64[k], r64["outputs"][k], FP64_RTOL, f"{name} {k}")
    hold_grads(g64, r64["grads"], FP64_RTOL, set(), f"{name} fp64 gradient")
    _, arbiter = _port_run(trainer.model, batch, r32["eps"], torch.float64)
    _, g32 = _port_run(trainer.model, batch, r32["eps"], torch.float32)
    for k, a in arbiter.items():
        bound = FP32_RATIO * rel_fro(r32["grads"][k], a) + 1e-6
        assert rel_fro(g32[k], a) <= bound, f"{name} fp32 grad {k}: {rel_fro(g32[k], a):.3e} > {bound:.3e}"


def test_vae_decode_matches_jax(jax_steps, tmp_path):
    """``LapVAE.decode`` (the generative path; ``DirVAE`` shares it) on the
    first batch's flat meshes with the same noise ``[B, N, 100]`` in both
    packages: the mean and the broadcast log-variance within 1e-6 in
    fp64."""
    name = "lap"
    ref = jax_steps(name)
    trainer = _trainer(tmp_path, model=name)
    trainer.model.load_state_dict(params_from_flax(ref["params"], like=trainer.model), strict=True)
    b = batch_as(trainer.batch(trainer.train_sampler.next_batch()), torch.float64)
    m = copy.deepcopy(trainer.model).double()
    with torch.no_grad():
        mu, logvar = m.decode(b.aux["flat_inputs"], torch.from_numpy(ref["decode"]["noise"]), b.aux["flat_operator"],
                              b.mask)
    assert_close(mu.numpy(), ref["decode"]["mu"], FP64_RTOL, "decoded mean")
    assert_close(logvar.detach().numpy(), ref["decode"]["logvar"], FP64_RTOL, "decoded log-variance")


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_vae_step_matches_jax(name, jax_steps, tmp_path):
    """One update of the trainer (as above, batch 4) at KLD weight KW: its
    first batch equals the JAX trainer's, ``aux`` included; in fp64, with
    JAX's noise, the loss and the parameters after one coupled-L2 Adam
    update within 1e-6 of the JAX package's (against optax); in fp32 the
    trainer's own ``update`` with JAX's fp32 noise: the first loss within
    1e-4 of JAX's and the parameters equal optax's update of the port's
    gradients (3e-7 absolute)."""
    ref = jax_steps(name)
    trainer = _trainer(tmp_path, model=name)
    assert trainer.store is not None
    batch = trainer.batch(trainer.train_sampler.next_batch())
    jb, case = ref["batch"], "dirac" if name == "dirac" else "dense"
    for k in ("inputs", "targets", "mask"):
        np.testing.assert_array_equal(getattr(batch, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    np.testing.assert_array_equal(batch.aux["flat_inputs"].numpy(), jb.aux["flat_inputs"])
    same_operator(batch.operator, jb.operator, case)
    same_operator(batch.aux["flat_operator"], jb.aux["flat_operator"], case)
    state = params_from_flax(ref["params"], like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)

    r64 = ref["float64"]
    model64 = copy.deepcopy(trainer.model).double()
    loss64, _, _ = ttrain.train_step(model64, toptim.adam(model64.parameters(), 1e-3, weight_decay=1e-5),
                                     batch_as(batch, torch.float64), torch.from_numpy(r64["eps"]), KW)
    assert_close(loss64.numpy(), r64["loss"], FP64_RTOL, "fp64 loss")
    hold_adam_update(model64, r64["new"], r64["grads"], state, FP64_RTOL)

    r32 = ref["float32"]
    eps = torch.from_numpy(r32["eps"]).float()
    loss, bce, kld = trainer.update(batch, KW, eps=eps)
    assert trainer.step == 1 and trainer.last_eps is eps
    assert_close(loss.numpy(), r32["loss"], STEP_FP32_RTOL, "fp32 loss")
    assert abs(float(loss) - float(bce + KW * kld)) <= 1e-5 * abs(float(loss))
    tg = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()}
    new = jax_adam_step(to_jax(tg), to_jax(state))
    for k, p in trainer.model.named_parameters():
        err = float(np.abs(p.detach().numpy() - np.asarray(new[k])).max())
        assert err <= ADAM_ATOL, f"{k}: after one Adam update max|err|={err:.3e}"


GAP_SEED, GAP_KW = 31, 0.5  # the graph-parallel VAE test's weights seed and KLD weight
CAST_RTOL = 1e-10  # the fp64 sums in another order, where JAX's fp32 casts are replayed (measured 6e-12)


def _jax_casts(model, name: str):
    """``model`` (the port's fp64 VAE) with the JAX package's fp32 casts
    inside its fp64 step replayed, value and cotangent: the encoder's pooled
    features rounded to fp32 before the latent heads (the Lap encoder casts
    once per head, ``x.astype(jnp.float32)`` in each call; the Dirac encoder
    once for both, so both heads' cotangents are summed in fp32) and the
    decoder's ``fc_mu`` output rounded to fp32 before the flat inputs are
    added (``mu.astype(jnp.float32) + inputs``)."""
    enc = model.encoder
    if name == "lap":
        for head in (enc.fc_mu, enc.fc_logvar):
            head.register_forward_pre_hook(lambda mod, args: (args[0].float().double(),))
    else:
        shared = {}

        def first(mod, args):
            shared["x32"] = args[0].float()
            return (shared["x32"].double(),)

        enc.fc_mu.register_forward_pre_hook(first)
        enc.fc_logvar.register_forward_pre_hook(lambda mod, args: (shared["x32"].double(),))
    model.decoder.fc_mu.register_forward_hook(lambda mod, args, out: out.float().double())
    return model


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_vae_fp64_step_leaf_by_leaf(name, data, tmp_path):
    """The fp64 step's gradients, leaf by leaf, against the JAX package's
    single-device step under ``enable_x64``, on the trainer's first batch,
    the graph-parallel test's weights (seed 31) and KLD weight 0.5, JAX's
    noise recorded as drawn.  Every leaf is within JAX_RTOL (1e-6) of
    JAX's; the largest gap, measured 7.2e-7 on the Lap VAE's
    ``encoder.rn1.bn_fc0.fc.weight`` (1.5e-7 on the Dirac VAE's
    ``encoder.rn0.bn_fc0.fc.weight``), is the JAX package's own: its fp64
    step casts to fp32 inside (``_jax_casts``).  With those casts replayed
    in the port, every leaf agrees within 1e-10 (6e-12 measured) and the
    loss to 1e-15: the port's fp64 step is the exact one, and the
    graph-parallel check's VAE bound (``tests/torch_dist_gp.py``) widens
    by this gap for this reason."""
    from unittest import mock

    _, j, _, jbk = data
    sep = max(1, int(len(j) * 0.8))
    jb = jbat.vae_batch(JEpochSampler(j[:sep], BATCH, seed=17).next_batch(), jbk, model=name)
    jmod = JMODELS[name](num_layers=LAYERS[name])
    shapes = jax.eval_shape(lambda: jmod.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                                              *_jax_arrays(jb, jnp.float32)))["params"]
    params = random_params(shapes, GAP_SEED)
    normal = jax.random.normal
    with jax.enable_x64(True):
        arrays = _jax_arrays(jb, jnp.float64)

        def objective(p):
            drawn = []

            def recorded(*a, **k):  # the noise itself, not (z - mu) / std, which loses digits
                drawn.append(normal(*a, **k))
                return drawn[-1]

            with mock.patch.object(jax.random, "normal", recorded):
                res = jmod.apply({"params": p}, *arrays, rngs={"sample": jax.random.key(9)})
            bce, kld = jlosses.vae_elbo_terms(res[0], res[1], arrays[-1], arrays[0], *res[2:])
            return bce + kld * GAP_KW, drawn[0]

        (jloss, eps), jg = jax.jit(jax.value_and_grad(objective, has_aux=True))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params))
        jg, eps = state64(jg), np.asarray(eps)
    trainer = _trainer(tmp_path, model=name)
    trainer.model.load_state_dict(params_from_flax(params, like=trainer.model), strict=True)
    batch = batch_as(trainer.batch(trainer.train_sampler.next_batch()), torch.float64)

    def step(model):
        res = model(batch.inputs, batch.aux["flat_inputs"], batch.operator, batch.aux["flat_operator"], batch.mask,
                    eps=torch.from_numpy(eps))
        bce, kld = tlosses.vae_elbo_terms(res[0], res[1], batch.mask, batch.inputs, *res[2:])
        loss = bce + kld * GAP_KW
        loss.backward()
        return float(loss), {k: p.grad.numpy() for k, p in model.named_parameters()}

    def gaps(g):
        return {k: float(np.abs(g[k] - jg[k]).max() / max(np.abs(jg[k]).max(), 1e-300)) for k in g}

    loss, g = step(copy.deepcopy(trainer.model).double())
    plain = gaps(g)
    leaf = max(plain, key=plain.get)
    assert_close(loss, float(jloss), LOSS_RTOL, "fp64 loss")
    hold_grads(g, jg, FP64_RTOL, set(), f"fp64 gradient (largest gap {plain[leaf]:.2e} at {leaf})")
    assert plain[leaf] > 100 * CAST_RTOL, (leaf, plain[leaf])  # a real gap, which the casts below account for
    loss, g = step(_jax_casts(copy.deepcopy(trainer.model).double(), name))
    cast = gaps(g)
    assert abs(loss - float(jloss)) <= 1e-15 * abs(float(jloss)), (loss, float(jloss))
    assert max(cast.values()) <= CAST_RTOL, (max(cast, key=cast.get), max(cast.values()))


@pytest.mark.parametrize("model", sorted(JMODELS))
def test_device_store_and_host_path_give_the_same_batches(model, data, tmp_path):
    """The device store's index gather and ``--no-device-store``'s host
    batch hold the same tensors, operators and ``aux``, train and test
    batches alike, and both draw the same noise from the same seed."""
    on, off = _trainer(tmp_path, model=model), _trainer(tmp_path, "--no-device-store", model=model)
    assert on.store is not None and off.store is None
    for sampler in ("train_sampler", "train_sampler", "test_sampler"):
        a, b = (t.batch(getattr(t, sampler).next_batch()) for t in (on, off))
        same_tensors(a, b)
        assert torch.equal(on.draw_eps(a), off.draw_eps(b))


@pytest.mark.parametrize("model", sorted(JMODELS))
def test_train_vae_main_cpu(model, tmp_path):
    """The acceptance run for each model with ``--dump-ply 2``: one epoch
    on the fixture writes the JAX trainer's log lines, the metrics file, the
    checkpoint (with ``fc_logvar``) and two PLYs that ``load_ply`` reads
    back: the decoded padded vertices and the test sample's padded faces."""
    hist = ttrain.main(_argv(tmp_path, "--dump-ply", "2", "--result-prefix", "v", model=model))
    ((loss, bce, kld),), ((tl, tb, tk),) = hist["train"], hist["test"]
    assert np.isfinite([loss, bce, kld, tl, tb, tk]).all() and loss == bce  # epoch 0: KLD weight 0
    assert abs(tl - (tb + tk)) <= 1e-5 * abs(tl)
    log = (tmp_path / "log" / "v.log").read_text()
    assert f"Train epoch 0, loss {loss}, bce {bce}, kld {kld}" in log
    assert f"Test epoch 0, loss {tl}, bce {tb}, kld {tk}" in log and "Num parameters" in log
    records = [json.loads(x) for x in (tmp_path / "log" / "v.metrics.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["split"]) for r in records] == [(0, "train"), (0, "test")]
    ckpt = torch.load(tmp_path / "pts" / "v.pt", weights_only=True)
    assert ckpt["epoch"] == 0 and ckpt["step"] == 1 and "decoder.fc_logvar" in ckpt["params"]
    samples = tdatasets.load_mnist_mesh_pickle(str(FIXTURE))
    bk = tbat.Buckets.for_samples(samples, multiple=8)
    plys = sorted((tmp_path / f"results_{model}").glob("*.ply"))
    assert [p.name for p in plys] == ["samples_epoch_000_000.ply", "samples_epoch_001_000.ply"]
    for k, path in enumerate(plys):
        V, F = tgeo.load_ply(str(path))
        assert V.shape == (bk.n_vertices, 3) and np.isfinite(V).all() and F.shape == (bk.n_faces, 3)
        test = samples[6 + k]  # the 80/20 split's test samples, in order
        np.testing.assert_array_equal(F[: test["F"].shape[0]], test["F"])


@pytest.mark.parametrize("flag", [["--data-parallel", "2"], ["--graph-parallel", "2", "--data-parallel", "2"],
                                  ["--config", "c.json"], ["--preset", "vae"]])
def test_train_vae_refuses_unported_flags(flag, tmp_path):
    """``--data-parallel`` and ``--graph-parallel``, refused before they were
    ported, run (``tests/test_torch_dist_train.py``,
    ``tests/test_torch_dist_gp_mesh.py``) and refuse what the JAX trainer
    refuses with its messages: a batch the data ranks cannot split, both
    flags together; ``--config`` and ``--preset``, refused before they were
    ported, are taken (``tests/test_torch_config.py`` holds each preset to
    the JAX package's resolution)."""
    if flag[0] in ("--config", "--preset"):
        config_flag_taken(ttrain.parser, flag, tmp_path, lambda a: ttrain.refuse_unported(a, "train_vae"))
        return
    if flag[0] == "--data-parallel":
        with pytest.raises(SystemExit, match="batch size 3 not divisible by --data-parallel 2"):
            ttrain.main(_argv(tmp_path, *flag, "--batch-size", "3"))
        return
    with pytest.raises(SystemExit, match="--graph-parallel and --data-parallel are mutually exclusive here"):
        ttrain.main(_argv(tmp_path, *flag))


def test_train_vae_needs_a_card_unless_told(monkeypatch, tmp_path):
    """Without ``--device cpu`` it runs on ``cuda`` and raises with no card;
    with neither ``--synthetic`` nor ``--data-path`` it exits as JAX's
    does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(argv)
    with pytest.raises(SystemExit, match="--synthetic N or --data-path"):
        ttrain.main(["--device", "cpu", "--result-dir", str(tmp_path)])
