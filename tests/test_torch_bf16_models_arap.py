"""The five ARAP models at ``dtype=torch.bfloat16`` against the JAX
package's at ``dtype=jnp.bfloat16``, and the dtype invariants of
``tests/test_bf16.py`` in the port (parameters, gradients, losses and
outputs fp32; bf16 BSR storage; converted weights loading into an fp32 and
a bf16 model alike).  Moved from ``tests/test_torch_bf16_models.py``, whose
module docstring states the method and the bounds and whose helpers and
fixture these tests share, so the suite's files balance across workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.models import normal_models as jnormal
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import Buckets, datasets, dirac_batch, laplacian_batch
from surfacenetworks_tpu_torch.data.batching import rcm_reorder_sample
from surfacenetworks_tpu_torch.models import arap_models as tarap
from surfacenetworks_tpu_torch.models import correspondence as tcorr
from surfacenetworks_tpu_torch.models import mnist_models as tmnist
from surfacenetworks_tpu_torch.models import normal_models as tnormal
from surfacenetworks_tpu_torch.models import vae as tvae
from surfacenetworks_tpu_torch.sparse import bsr_spmm
from surfacenetworks_tpu_torch.train import losses as tlosses

from test_torch_bf16_models import BFT, JARAP, _lap_inputs, _seeded, lap_batch  # noqa: F401  (lap_batch: the shared fixture)
from torch_parity import BF16, dirac_operators, f64, hold_bf16_model, perturbed_params, rel_fro


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
