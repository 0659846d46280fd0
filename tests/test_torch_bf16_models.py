"""The port's models at ``dtype=torch.bfloat16`` against the JAX package's at
``dtype=jnp.bfloat16``, with flax parameters (moved off init by seeded
noise) converted by ``convert.py``: LapDeepModel and DirDeepModel (normal
prediction), the FAUST trunk and SiameseModel, the five ARAP models, the
four mesh-MNIST classifiers and the VAE's encoders and decoder.  Each is
held by ``torch_parity.hold_bf16_model``: its output within BF16_OUT_RTOL
(4U, U = 2^-8) of JAX's; every parameter's gradient finite and fp32; and
the step unit by unit (each layer or block the port's ``nn`` package
defines, ``torch_parity.hold_bf16_units``): each call of each unit rerun on
the port's own arguments and output cotangent against the flax module at
the same path on the same ones, its outputs, each parameter's gradient and
each argument's gradient held one at a time.  (The whole model's bf16
gradient cannot be held so: at these inputs JAX's own moves by up to 1.9,
relative Frobenius per parameter, when its fp32 parameters move by 2^-20,
so two correct implementations differ as much.)  Then the dtype invariants
of ``tests/test_bf16.py`` in the port (parameters, gradients, losses and
outputs fp32; bf16 BSR storage), its convergence check, and converted
weights loading into an fp32 and a bf16 model alike (the parameters stay
fp32, so ``convert.py`` needs nothing of its own for bf16).  Inputs are
seeded numpy arrays; 2-3 layers, meshes of 60-150 vertices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.models import arap_models as jarap
from surfacenetworks_tpu.models import correspondence as jcorr
from surfacenetworks_tpu.models import mnist_models as jmnist
from surfacenetworks_tpu.models import normal_models as jnormal
from surfacenetworks_tpu.models import vae as jvae
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import Buckets, datasets, dirac_batch, laplacian_batch
from surfacenetworks_tpu_torch.data.batching import rcm_reorder_sample
from surfacenetworks_tpu_torch.models import arap_models as tarap
from surfacenetworks_tpu_torch.models import correspondence as tcorr
from surfacenetworks_tpu_torch.models import init_weights
from surfacenetworks_tpu_torch.models import mnist_models as tmnist
from surfacenetworks_tpu_torch.models import normal_models as tnormal
from surfacenetworks_tpu_torch.models import vae as tvae
from surfacenetworks_tpu_torch.sparse import bsr_spmm
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as toptim

from torch_parity import (BF16, bf16_mesh, bf16_operators, dirac_operators, f64, hold_bf16_model, operators,
                          perturbed_params, rel_fro)

BFT = torch.bfloat16
N = 256
JARAP = {"lap": jarap.Model, "avg": jarap.AvgModel, "mlp": jarap.MlpModel, "dir": jarap.DirModel, "gcn": jarap.GCNModel}


def _projection(shape, seed: int):
    """A loss for outputs without one of their own: ``<out, W>`` with a
    seeded ``W``, in both packages."""
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (lambda o: jnp.sum(o * jnp.asarray(w))), (lambda o: (o * torch.from_numpy(w)).sum())


def _lap_inputs(c_in: int, fmt: str, seed: int = 3):
    L, mask, rng = bf16_mesh(N=N, seed=seed)
    x = (rng.normal(size=(2, N, c_in)) * mask).astype(np.float32)
    jop, top = bf16_operators(L, N, fmt)
    jop32 = operators(L, N, "ell" if fmt == "bsr" else fmt, 2)[0]  # JAX's fp32 twin on fp32 values
    return jop, jop32, top, mask, x


@pytest.mark.parametrize("fmt", ["ell", "bsr", "dense"])
def test_lapdeep_bf16_matches_flax(fmt):
    """LapDeepModel-3 in each operator format (BSR blocks in bf16), under
    the normal trainer's cosine loss."""
    jop, jop32, top, mask, x = _lap_inputs(3, fmt)
    tgt = np.random.default_rng(4).normal(size=(2, N, 3)).astype(np.float32)
    jm, jt, tm, tt = jnp.asarray(mask), jnp.asarray(tgt), torch.from_numpy(mask), torch.from_numpy(tgt)
    hold_bf16_model(f"LapDeepModel {fmt}", jnormal.LapDeepModel(3, 3, layers=3, dtype=BF16),
                    tnormal.LapDeepModel(3, 3, layers=3, dtype=BFT), (jop, jm, jnp.asarray(x)),
                    (top, tm, torch.from_numpy(x)), lambda o: tlosses.normal_cosine_loss(o, tm, tt), 5)


def test_dirdeep_bf16_matches_flax():
    """DirDeepModel-2 on the structured Dirac tables: the applies promote
    to fp32, the output is fp32."""
    jop, top, mask = dirac_operators()
    x = (np.random.default_rng(6).normal(size=mask.shape[:2] + (3,)) * mask).astype(np.float32)
    tgt = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    jm, jt, tm, tt = jnp.asarray(mask), jnp.asarray(tgt), torch.from_numpy(mask), torch.from_numpy(tgt)
    hold_bf16_model("DirDeepModel", jnormal.DirDeepModel(3, 3, layers=2, dtype=BF16),
                    tnormal.DirDeepModel(3, 3, layers=2, dtype=BFT), (jop, jm, jnp.asarray(x)),
                    (top, tm, torch.from_numpy(x)), lambda o: tlosses.normal_cosine_loss(o, tm, tt), 8)


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_siamese_bf16_matches_flax(fmt):
    """SiameseModel(lap, 2 layers): the features are cast to bf16, the
    logits summed in fp32; under the dcel loss against a seeded target."""
    jop, jop32, top, mask, x = _lap_inputs(3, fmt)
    jop, jop32, top, mask, x = jax.tree_util.tree_map(lambda a: a[:1], jop), jax.tree_util.tree_map(
        lambda a: a[:1], jop32), _first(top), mask[:1], x[:1]
    tgt = np.random.default_rng(9).integers(0, 150, size=N)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    ja, ta = (jop, jm), (top, tm)
    hold_bf16_model(f"SiameseModel {fmt}", jcorr.SiameseModel("lap", 2, dtype=BF16),
                    tcorr.SiameseModel("lap", 2, dtype=BFT), (ja, ja, jnp.asarray(x), jnp.asarray(x[:, ::-1])),
                    (ta, ta, torch.from_numpy(x), torch.from_numpy(x[:, ::-1].copy())),
                    lambda o: tlosses.corr_delta_cross_entropy_from_target(o[0], torch.from_numpy(tgt)), 10)


def _first(op):
    """Batch item 0 of a port operator, keeping the batch axis."""
    import dataclasses

    def take(m):
        return dataclasses.replace(m, **{f.name: getattr(m, f.name)[:1] for f in dataclasses.fields(m)
                                        if isinstance(getattr(m, f.name), torch.Tensor)})
    return type(op)(fwd=take(op.fwd), bwd=take(op.bwd))


@pytest.mark.parametrize("name", ["lap", "avg", "mlp", "dir", "gcn"])
def test_arap_model_bf16_matches_flax(name):
    """The five ARAP models at 2 layers (2 frames in, 40 out) in ELL (Dirac
    tables for ``dir``), under the trainer's masked smooth-L1 loss."""
    if name == "dir":
        jop, top, mask = dirac_operators()
        jop32 = jop
        n = mask.shape[1]
        x = (np.random.default_rng(11).normal(size=(2, n, 6)) * mask).astype(np.float32)
    else:
        jop, jop32, top, mask, x = _lap_inputs(6, "ell", seed=5)
    tgt = np.random.default_rng(12).normal(size=x.shape[:2] + (120,)).astype(np.float32)
    jm, jt, tm, tt = jnp.asarray(mask), jnp.asarray(tgt), torch.from_numpy(mask), torch.from_numpy(tgt)
    hold_bf16_model(f"ARAP {name}", JARAP[name](layers=2, dtype=BF16), tarap.MODELS[name](layers=2, dtype=BFT),
                    (jop, jm, jnp.asarray(x)), (top, tm, torch.from_numpy(x)),
                    lambda o: tlosses.smooth_l1_sum(o * tm, tt, 2), 13)


@pytest.mark.parametrize("name", ["lap", "avg", "mlp", "dirac"])
def test_mnist_classifier_bf16_matches_flax(name):
    """The mesh-MNIST classifiers (2 layers, ``dirac`` 1) in ELL (Dirac
    tables for ``dirac``), deterministic, under the NLL loss: the pooled
    features reach ``fc1`` in fp32."""
    layers = 1 if name == "dirac" else 2
    if name == "dirac":
        jop, top, mask = dirac_operators()
        jop32 = jop
        x = (np.random.default_rng(14).normal(size=mask.shape[:2] + (3,)) * mask).astype(np.float32)
    else:
        jop, jop32, top, mask, x = _lap_inputs(3, "ell", seed=6)
    y = np.array([3, 7])
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    jmodels = {"lap": jmnist.Model, "avg": jmnist.AvgModel, "mlp": jmnist.MlpModel, "dirac": jmnist.DirModel}

    class _J:
        def __init__(self, dtype):
            self.m = jmodels[name](layers=layers, dtype=dtype)

        def init(self, key, *a):
            return self.m.init(key, *a, deterministic=True)

        def apply(self, v, *a):
            return self.m.apply(v, *a, True)

    hold_bf16_model(f"mnist {name}", _J(BF16), tmnist.MODELS[name](layers=layers, dtype=BFT),
                    (jnp.asarray(x), jop, jm), (torch.from_numpy(x), top, tm),
                    lambda o: tlosses.nll_loss(o, torch.from_numpy(y)), 15,
                    tcall=lambda m, xx, op, mk: m(op, mk, xx, deterministic=True))


@pytest.mark.parametrize("part", ["lap encoder", "lap decoder", "dirac encoder"])
def test_vae_parts_bf16_match_flax(part):
    """The VAE's encoders (2 layers, Dirac 1) and the Lap decoder: the
    latent heads and the reconstruction mean are fp32.  (The whole VAE's
    step, noise included, is held in ``test_torch_bf16_train.py``.)"""
    kind, which = part.split()
    layers = 1 if kind == "dirac" else 2
    if kind == "dirac":
        jop, top, mask = dirac_operators()
        jop32 = jop
        x = (np.random.default_rng(16).normal(size=mask.shape[:2] + (3,)) * mask).astype(np.float32)
    else:
        jop, jop32, top, mask, x = _lap_inputs(3, "ell", seed=7)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    name = {"lap": "Lap", "dirac": "Dir"}[kind] + which.capitalize()
    jcls, tcls = getattr(jvae, name), getattr(tvae, name)
    noise = np.random.default_rng(17).normal(size=x.shape[:2] + (tvae.LATENT,)).astype(np.float32)

    def args(op, m, xx, torch_side=False):
        if which == "encoder":
            return xx, op, m
        return xx, torch.from_numpy(noise) if torch_side else jnp.asarray(noise), op, m

    shape = (2, tvae.LATENT) if which == "encoder" else x.shape
    (lj0, lt0), (lj1, lt1) = _projection(shape, 18), _projection(shape, 19)
    hold_bf16_model(f"VAE {part}", jcls(layers, dtype=BF16), tcls(layers, dtype=BFT), args(jop, jm, jnp.asarray(x)),
                    args(top, tm, torch.from_numpy(x), True), lambda o: lt0(o[0]) + lt1(o[1]), 20)


# ---------------------------------------------------------------------------
# the dtype invariants of tests/test_bf16.py, in the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lap_batch():
    samples = datasets.synthetic_normal_dataset(2, 80, seed=0, operator="lap")
    return laplacian_batch(samples, Buckets.for_samples(samples), fmt="ell")


def _seeded(model):
    return init_weights(model, torch.Generator().manual_seed(0))


def test_params_and_grads_stay_fp32(lap_batch):
    b = lap_batch
    model = _seeded(tnormal.LapDeepModel(3, 3, layers=3, dtype=BFT))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = model(b.operator, b.mask, b.inputs)
    assert out.dtype == torch.float32  # the residual head promotes
    loss = tlosses.normal_cosine_loss(out, b.mask, b.targets)
    loss.backward()
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


def test_bf16_training_converges(lap_batch):
    """The decisive mixed-precision check of ``tests/test_bf16.py``: from
    the same init and data, 40 Adam steps each; both losses fall below half
    their first, and the bf16 loss ends below 3x the fp32 loss + 1e-3."""
    b = lap_batch
    m32 = _seeded(tnormal.LapDeepModel(3, 3, layers=3))
    m16 = tnormal.LapDeepModel(3, 3, layers=3, dtype=BFT)
    m16.load_state_dict(m32.state_dict())
    finals = {}
    for name, model in (("fp32", m32), ("bf16", m16)):
        opt = toptim.adam(model.parameters(), 1e-3)
        first = None
        for _ in range(40):
            opt.zero_grad(set_to_none=True)
            loss = tlosses.normal_cosine_loss(model(b.operator, b.mask, b.inputs), b.mask, b.targets)
            loss.backward()
            opt.step()
            first = float(loss) if first is None else first
        finals[name] = float(loss)
        assert finals[name] < 0.5 * first, (name, first, finals[name])
    assert finals["bf16"] < 3.0 * finals["fp32"] + 1e-3, finals


def test_bf16_bsr_forward_backward():
    samples = [rcm_reorder_sample(s) for s in datasets.synthetic_normal_dataset(1, 100, seed=1, operator="lap")]
    buckets = Buckets.for_samples(samples, multiple=128)
    b = laplacian_batch(samples, buckets, fmt="bsr", op_dtype=BFT)
    assert b.operator.fwd.block_vals.dtype == BFT and b.operator.bwd.block_vals.dtype == BFT
    model = _seeded(tnormal.LapDeepModel(3, 3, layers=2, dtype=BFT))
    loss = tlosses.normal_cosine_loss(model(b.operator, b.mask, b.inputs), b.mask, b.targets)
    loss.backward()
    assert np.isfinite(float(loss)) and all(p.grad.dtype == torch.float32 for p in model.parameters())


def test_bf16_dirac_model():
    samples = datasets.synthetic_normal_dataset(2, 60, seed=2, operator="dirac")
    b = dirac_batch(samples, Buckets.for_samples(samples))
    model = _seeded(tnormal.DirDeepModel(3, 3, layers=2, dtype=BFT))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    loss = tlosses.normal_cosine_loss(model(b.operator, b.mask, b.inputs), b.mask, b.targets)
    loss.backward()
    assert np.isfinite(float(loss)) and all(p.grad.dtype == torch.float32 for p in model.parameters())


def test_bf16_siamese_logits_fp32(lap_batch):
    b = lap_batch
    model = _seeded(tcorr.SiameseModel("lap", 2, dtype=BFT))
    opx = (b.operator, b.mask)
    fa, _ = model.features(opx, opx, b.inputs, b.inputs)
    logits = model(opx, opx, b.inputs, b.inputs)
    assert fa.dtype == BFT and logits.dtype == torch.float32  # the loss's softmax in full precision
    assert torch.isfinite(logits).all()


def test_bf16_bsr_operator_storage():
    """bf16 blocks (the JAX package's bits) halve the block stream; the
    apply stays within bf16's input rounding of the fp32 operator's."""
    from surfacenetworks_tpu.data import Buckets as JBuckets
    from surfacenetworks_tpu.data import datasets as jdatasets
    from surfacenetworks_tpu.data import laplacian_batch as jlaplacian_batch
    from surfacenetworks_tpu.data.batching import rcm_reorder_sequence

    jsamples = rcm_reorder_sequence(jdatasets.synthetic_normal_dataset(1, 100, seed=1, operator="lap"))
    samples = [rcm_reorder_sample(s) for s in datasets.synthetic_normal_dataset(1, 100, seed=1, operator="lap")]
    buckets = Buckets.for_samples(samples, multiple=128)
    b32 = laplacian_batch(samples, buckets, fmt="bsr")
    b16 = laplacian_batch(samples, buckets, fmt="bsr", op_dtype=BFT)
    j16 = jlaplacian_batch(jsamples, JBuckets.for_samples(jsamples, multiple=128), fmt="bsr", op_dtype=BF16)
    for part in ("fwd", "bwd"):
        got, ref = getattr(b16.operator, part).block_vals, getattr(j16.operator, part).block_vals
        assert got.dtype == BFT and ref.dtype == BF16
        np.testing.assert_array_equal(f64(got), np.asarray(ref, np.float64), err_msg=part)
        assert got.element_size() * 2 == getattr(b32.operator, part).block_vals.element_size()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, buckets.n_vertices, 64)).astype(np.float32))
    y32, y16 = bsr_spmm(b32.operator, x), bsr_spmm(b16.operator, x)
    assert y16.dtype == torch.float32
    assert float((y32 - y16).abs().max() / y32.abs().max()) < 2e-2


@pytest.mark.parametrize("family", ["mnist", "vae", "arap"])
def test_bf16_other_families_construct_and_run(family, lap_batch):
    b = lap_batch
    if family == "mnist":
        model = _seeded(tmnist.Model(layers=1, dtype=BFT))
        out = model(b.operator, b.mask, b.inputs, deterministic=True)
    elif family == "vae":
        model = _seeded(tvae.LapVAE(num_layers=1, dtype=BFT))
        recon_mu, _, z, mu, _ = model(b.inputs, b.inputs, b.operator, b.operator, b.mask,
                                      generator=torch.Generator().manual_seed(2))
        assert recon_mu.dtype == mu.dtype == z.dtype == torch.float32
        out = recon_mu
    else:
        model = _seeded(tarap.Model(layers=2, dtype=BFT))
        out = model(b.operator, b.mask, torch.cat([b.inputs, b.inputs], dim=-1))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_converted_weights_load_into_fp32_and_bf16_models():
    """``params_from_flax`` gives one ``state_dict`` for both dtypes: the
    parameters stay fp32, and both models load it unchanged."""
    jop, _, top, mask, x = _lap_inputs(3, "ell")
    jmod = jnormal.LapDeepModel(3, 3, layers=2, dtype=BF16)
    params = perturbed_params(jmod.init(jax.random.key(0), jop, jnp.asarray(mask), jnp.asarray(x))["params"], 20)
    m32, m16 = tnormal.LapDeepModel(3, 3, layers=2), tnormal.LapDeepModel(3, 3, layers=2, dtype=BFT)
    state = params_from_flax(params, like=m16)
    for m in (m32, m16):
        m.load_state_dict(state, strict=True)
    for (k, a), (_, b16) in zip(m32.state_dict().items(), m16.state_dict().items()):
        assert a.dtype == b16.dtype == torch.float32 and torch.equal(a, b16), k
    o32, o16 = (m(top, torch.from_numpy(mask), torch.from_numpy(x)) for m in (m32, m16))
    j32 = jnormal.LapDeepModel(3, 3, layers=2).apply({"params": jax.tree_util.tree_map(jnp.asarray, params)}, jop,
                                                      jnp.asarray(mask), jnp.asarray(x))
    assert o16.dtype == o32.dtype == torch.float32
    assert rel_fro(f64(o32), j32) <= 1e-4
