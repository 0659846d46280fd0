"""The four mesh-MNIST classifiers and the VAE's encoders and decoder at
``dtype=torch.bfloat16`` against the JAX package's at
``dtype=jnp.bfloat16``.  Moved from ``tests/test_torch_bf16_models.py``,
whose module docstring states the method and the bounds and whose helpers
these tests share, so the suite's files balance across workers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.models import mnist_models as jmnist
from surfacenetworks_tpu.models import vae as jvae
from surfacenetworks_tpu_torch.models import mnist_models as tmnist
from surfacenetworks_tpu_torch.models import vae as tvae
from surfacenetworks_tpu_torch.train import losses as tlosses

from test_torch_bf16_models import BFT, _lap_inputs, _projection
from torch_parity import BF16, dirac_operators, hold_bf16_model


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
