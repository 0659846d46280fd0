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
seeded numpy arrays; 2-3 layers, meshes of 60-150 vertices.

This file holds the normal-prediction and FAUST models and the helpers and
fixture the others share; the ARAP models and the dtype invariants are in
``test_torch_bf16_models_arap.py``, the mesh-MNIST classifiers and the VAE
in ``test_torch_bf16_models_mnist.py`` and the convergence check in
``test_torch_bf16_convergence.py`` (split so that ``--dist loadfile``
balances them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.models import arap_models as jarap
from surfacenetworks_tpu.models import correspondence as jcorr
from surfacenetworks_tpu.models import normal_models as jnormal
from surfacenetworks_tpu_torch.data import Buckets, datasets, laplacian_batch
from surfacenetworks_tpu_torch.models import correspondence as tcorr
from surfacenetworks_tpu_torch.models import init_weights
from surfacenetworks_tpu_torch.models import normal_models as tnormal
from surfacenetworks_tpu_torch.train import losses as tlosses

from torch_parity import BF16, bf16_mesh, bf16_operators, dirac_operators, hold_bf16_model, operators

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


# ---------------------------------------------------------------------------
# the dtype invariants of tests/test_bf16.py, in the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lap_batch():
    samples = datasets.synthetic_normal_dataset(2, 80, seed=0, operator="lap")
    return laplacian_batch(samples, Buckets.for_samples(samples), fmt="ell")


def _seeded(model):
    return init_weights(model, torch.Generator().manual_seed(0))
