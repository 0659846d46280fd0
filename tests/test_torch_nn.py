"""The port's layers, blocks and LapDeepModel against the JAX package's flax
modules, with the flax parameters (moved off their init values by seeded
noise) converted by ``params_from_flax``.  Inputs are seeded numpy arrays.
Tolerances, relative to ``max|ref|``: 1e-5 for single layers (fp32, another
summation order); 1e-4 for blocks and models, where batch norm divides by
statistics that carry that rounding from layer to layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.models import normal_models as jmodels
from surfacenetworks_tpu.nn import blocks as jblocks
from surfacenetworks_tpu.nn import layers as jlayers
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.models import normal_models as tmodels
from surfacenetworks_tpu_torch.nn import blocks as tblocks
from surfacenetworks_tpu_torch.nn import layers as tlayers

from torch_parity import assert_close, blob_laplacian, operators, perturbed_params, rcm, to_jax

LAYER_RTOL = 1e-5
BLOCK_RTOL = 1e-4


def _inputs(shape, seed=0, n_valid=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    mask = np.ones(shape[:-1] + (1,), np.float32)
    if n_valid is not None:
        mask[:, n_valid:] = 0.0
        x[:, n_valid:] = 0.0
    return x, mask


def _pair(jmod, tmod, *jargs, seed=1):
    """Init the flax module, perturb its params, load them into the torch
    module; returns (jax apply fn, torch module)."""
    params = perturbed_params(jmod.init(jax.random.key(0), *jargs)["params"], seed)
    tmod.load_state_dict(params_from_flax(params, like=tmod), strict=True)
    jp = to_jax(params)
    return (lambda *a: np.asarray(jmod.apply({"params": jp}, *a))), tmod.eval()


@pytest.mark.parametrize("masked", [False, True])
def test_graph_batch_norm(masked):
    x, mask = _inputs((2, 40, 8), n_valid=30)
    x = x * 3.0 + 1.5
    japply, tmod = _pair(jlayers.GraphBatchNorm(8, masked=masked), tlayers.GraphBatchNorm(8, masked=masked),
                         jnp.asarray(x), jnp.asarray(mask))
    got = tmod(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    assert_close(got, japply(jnp.asarray(x), jnp.asarray(mask)), LAYER_RTOL, f"masked={masked}")


@pytest.mark.parametrize("bn", ["pre", "post", "grouppre", "", None])
def test_graph_conv1x1(bn):
    x, mask = _inputs((2, 24, 6), seed=2)
    japply, tmod = _pair(jlayers.GraphConv1x1(6, 10, bn), tlayers.GraphConv1x1(6, 10, bn),
                         jnp.asarray(x), jnp.asarray(mask))
    assert hasattr(tmod, "bn") == (bn in ("pre", "post"))
    got = tmod(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    assert_close(got, japply(jnp.asarray(x), jnp.asarray(mask)), LAYER_RTOL, f"bn={bn!r}")


def test_global_average_with_padding():
    x, mask = _inputs((3, 50, 5), seed=3, n_valid=37)
    x[:, 37:] = 7.0  # padding rows must not enter the mean
    got = tlayers.global_average(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == (3, 1, 5)
    assert_close(got, jlayers.global_average(jnp.asarray(x), jnp.asarray(mask)), LAYER_RTOL)


@pytest.mark.parametrize("widths", [(3, 128), (3, 8), (4, 4), (6, 3)])
def test_repeating_expand(widths):
    cin, cout = widths
    x, _ = _inputs((2, 5, cin), seed=4)
    got = tlayers.repeating_expand(torch.from_numpy(x), cout).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlayers.repeating_expand(jnp.asarray(x), cout)))


BLOCKS = [
    ("WideLapResNet2", 16, 16),
    ("WideLapResNet2", 16, 8),
    ("WideLapResNet2", 8, 16),
    ("WideAvgResNet2", 16, 16),
    ("WideAvgResNet2", 16, 8),
    ("WideAvgResNet2", 8, 16),
    ("LapResNet2", 12, 12),
    ("AvgResNet2", 12, 12),
]


@pytest.mark.parametrize("name,cin,cout", BLOCKS)
def test_blocks(name, cin, cout):
    N = 256
    _, _, L = blob_laplacian(5, 200)
    jop, top = operators(L, N, "ell", batch=2)
    x, mask = _inputs((2, N, cin), seed=6, n_valid=200)
    if name.startswith("Wide"):
        jmod, tmod = getattr(jblocks, name)(cin, cout), getattr(tblocks, name)(cin, cout)
    else:
        jmod, tmod = getattr(jblocks, name)(cin), getattr(tblocks, name)(cin)
    jm, jx = jnp.asarray(mask), jnp.asarray(x)
    japply, tmod = _pair(jmod, tmod, jop, jm, jx)
    got = tmod(top, torch.from_numpy(mask), torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, N, cout)
    assert_close(got, japply(jop, jm, jx), BLOCK_RTOL, f"{name} {cin}->{cout}")


@pytest.mark.parametrize(
    "fmt,layers,bottleneck",
    [("dense", 3, False), ("ell", 3, False), ("bsr", 3, False), ("ell", 16, True)],
)
def test_lap_deep_model(fmt, layers, bottleneck):
    n_points, N = 200, 256
    _, _, L = blob_laplacian(7, n_points)
    L = rcm(L) if fmt == "bsr" else L
    jop, top = operators(L, N, fmt, batch=2)
    x, mask = _inputs((2, N, 3), seed=8, n_valid=n_points)
    jmod = jmodels.LapDeepModel(3, 3, layers=layers, bottleneck=bottleneck)
    tmod = tmodels.LapDeepModel(3, 3, layers=layers, bottleneck=bottleneck)
    jm, jx = jnp.asarray(mask), jnp.asarray(x)
    japply, tmod = _pair(jmod, tmod, jop, jm, jx, seed=9)
    with torch.inference_mode():
        got = tmod(top, torch.from_numpy(mask), torch.from_numpy(x)).numpy()
    assert got.shape == (2, N, 3)
    assert_close(got, japply(jop, jm, jx), BLOCK_RTOL, f"{fmt} layers={layers} bottleneck={bottleneck}")
