"""The port's public names against the JAX package's.

* ``data.padded_vertex_fraction`` and ``sparse.quaternion_mul``,
  ``to_quaternion_layout`` and ``from_quaternion_layout`` equal the JAX
  package's on the same inputs, in fp32 and fp64 (bit for bit: the same
  elementwise products in the same order; the layouts are reshapes).
* Every name in the ``__all__`` list of a JAX package ``__init__`` has a
  counterpart of the same name in the port's module, except the XLA-only
  names below, each with why PyTorch has no counterpart.
"""

import importlib
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfacenetworks_tpu
from surfacenetworks_tpu import data as jdata
from surfacenetworks_tpu import sparse as jsparse
from surfacenetworks_tpu_torch import data as tdata
from surfacenetworks_tpu_torch import sparse as tsparse

# name -> why it has no PyTorch counterpart
XLA_ONLY = {
    "surfacenetworks_tpu.data": {
        "stack_device_trees": "stacks device pytrees into the store a jit-compiled epoch scan indexes with traced "
                              "ints; the port's steps run eagerly, one update a dispatch",
    },
    "surfacenetworks_tpu.sparse": {
        "get_default_implementation": "reads the switch between XLA's gather formulation and the Pallas kernels; "
                                      "the port has one implementation a device (the plain version on the CPU, "
                                      "the hand kernel on the card)",
        "set_default_implementation": "sets that XLA-or-Pallas switch",
    },
}


def _jax_init_modules() -> list[str]:
    names = ["surfacenetworks_tpu"] + [m.name for m in pkgutil.walk_packages(surfacenetworks_tpu.__path__,
                                                                             "surfacenetworks_tpu.") if m.ispkg]
    return [n for n in names if hasattr(importlib.import_module(n), "__all__")]


@pytest.mark.parametrize("module", _jax_init_modules())
def test_every_public_name_has_a_counterpart(module):
    jmod = importlib.import_module(module)
    tmod = importlib.import_module(module.replace("surfacenetworks_tpu", "surfacenetworks_tpu_torch", 1))
    exempt = XLA_ONLY.get(module, {})
    missing = [n for n in jmod.__all__ if n not in exempt and not hasattr(tmod, n)]
    assert not missing, f"{module}: no counterpart of {missing}"
    assert all(n in jmod.__all__ and not hasattr(tmod, n) for n in exempt), f"{module}: stale XLA-only names"
    exported = set(getattr(tmod, "__all__", []))
    assert not [n for n in jmod.__all__ if n not in exempt and exported and n not in exported], module


def test_padded_vertex_fraction_matches_jax():
    rng = np.random.default_rng(0)
    samples = [{"V": np.zeros((int(n), 3))} for n in rng.integers(20, 400, size=12)]
    for s in samples:
        s["F"] = np.zeros((2 * s["V"].shape[0], 3), np.int32)
    tb, jb = tdata.BucketSet.for_samples(samples, n_tiers=3), jdata.BucketSet.for_samples(samples, n_tiers=3)
    got = tdata.padded_vertex_fraction(samples, lambda s: tb.select([s]))
    ref = jdata.padded_vertex_fraction(samples, lambda s: jb.select([s]))
    assert got == ref and 0 < got < 1
    one_t, one_j = tdata.Buckets.for_samples(samples), jdata.Buckets.for_samples(samples)
    assert (tdata.padded_vertex_fraction(samples, lambda s: one_t)
            == jdata.padded_vertex_fraction(samples, lambda s: one_j) > got)
    assert tdata.padded_vertex_fraction([], lambda s: one_t) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quaternion_helpers_match_jax(dtype):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 7, 4)).astype(dtype)
    x = rng.normal(size=(5, 7, 4, 6)).astype(dtype)
    flat = rng.normal(size=(2, 9, 24)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        jq = np.asarray(jsparse.quaternion_mul(jnp.asarray(q), jnp.asarray(x)))
        jl = np.asarray(jsparse.to_quaternion_layout(jnp.asarray(flat)))
        jback = np.asarray(jsparse.from_quaternion_layout(jnp.asarray(jl)))
    tq = tsparse.quaternion_mul(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    tl = tsparse.to_quaternion_layout(torch.from_numpy(flat))
    assert tq.dtype == jq.dtype == np.dtype(dtype) and tl.shape == jl.shape == (2, 9, 4, 6)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tsparse.from_quaternion_layout(tl).numpy(), jback)
    np.testing.assert_array_equal(jback, flat)
    # Hamilton product: (1, 0, 0, 0) is the identity, i * i = -1
    ident = np.zeros((1, 4), dtype)
    ident[0, 0] = 1
    np.testing.assert_array_equal(tsparse.quaternion_mul(torch.from_numpy(ident), torch.from_numpy(x[0, :1])).numpy(),
                                  x[0, :1])
    with pytest.raises(ValueError, match="not divisible by 4"):
        tsparse.to_quaternion_layout(torch.zeros(3, 6))
