"""The whole serving slice against the JAX package, with the committed
trained LapDeepModel-15 weights (``diag_lap1000_r05``).

The port's ``NormalServer(device="cpu")`` answers one seeded ~1,000-vertex
blob mesh in the ELL and the BSR format; the JAX package exports its forward
(``serve.export_forward`` + ``serve.load``) on the batch its own packing
builds for the same mesh.  Tolerance, as a relative Frobenius error: 2e-4
on mesh seed 1, whose fp32 answer lies 8e-5 from an fp64 forward of the same
weights.  Mesh seed 0 has sliver triangles (|L| up to 4e4 against L x of
order 1), where fp32 rounding alone moves the answer 2e-2 from fp64 in both
packages, so its bound is 5e-2.  The fp64 forward (dense operator, no
packing) is asserted too, so a tolerance cannot hide a port fault.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu import models as jzoo
from surfacenetworks_tpu import serve as jserve
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import Buckets, laplacian_batch
from surfacenetworks_tpu_torch.geometry import igl_style_laplacian
from surfacenetworks_tpu_torch.models import LapDeepModel, init_weights
from surfacenetworks_tpu_torch.serve import NormalServer

CHECKPOINT = "results/normal_predict/pts/diag_lap1000_r05_normal_state.msgpack"
# mesh seed -> (port vs JAX, port vs fp64) relative Frobenius bounds
TOLERANCE = {1: (2e-4, 5e-4), 0: (5e-2, 1e-1)}


@pytest.fixture(scope="module")
def trained():
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), CHECKPOINT)
    with open(path, "rb") as fh:
        params = flax.serialization.msgpack_restore(fh.read())["params"]
    return params, params_from_flax(params, like=LapDeepModel(3, 3, layers=15))


def _jax_answer(params, V, F, fmt):
    n = V.shape[0]
    sample = {"V": V.astype(np.float32), "F": F, "input": V.astype(np.float32),
              "target": np.zeros((n, 3), np.float32), "L": jgeo.igl_style_laplacian(V, F, hack=1.0)}
    buckets = jbat.Buckets(n_vertices=jbat.round_up(n, 128))
    if fmt == "bsr":
        sample = jbat.rcm_reorder_sample(sample)
        jbat.fit_bsr_k([sample], buckets)
    batch = jbat.laplacian_batch([sample], buckets, fmt=fmt)
    blob = jserve.export_forward(jzoo.LapDeepModel(3, 3, layers=15), jax.tree_util.tree_map(jnp.asarray, params),
                                 batch.operator, batch.mask, batch.inputs, platforms=("cpu",))
    out = np.asarray(jserve.load(blob)(jnp.asarray(batch.inputs)))[0, :n]
    if fmt == "bsr":
        restored = np.empty_like(out)
        restored[sample["rcm_perm"]] = out
        out = restored
    return out


def _fp64_answer(state_dict, V, F):
    n = V.shape[0]
    model = LapDeepModel(3, 3, layers=15)
    model.load_state_dict(state_dict)
    model = model.double()
    sample = {"V": V, "F": F, "input": V, "L": igl_style_laplacian(V, F, hack=1.0)}
    batch = laplacian_batch([sample], Buckets(n_vertices=-(-n // 128) * 128), target_key="input", fmt="dense")
    with torch.inference_mode():
        return model(batch.operator.double(), batch.mask.double(), batch.inputs.double())[0, :n].numpy()


@pytest.mark.parametrize("seed", [1, 0])
def test_normal_server_matches_jax_export(trained, seed):
    params, state_dict = trained
    V, F = jdatasets.random_blob_mesh(np.random.default_rng(seed), 1000)
    ref64 = _fp64_answer(state_dict, V, F)
    tol_jax, tol_64 = TOLERANCE[seed]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for fmt in ("ell", "bsr"):
        got = NormalServer(LapDeepModel(3, 3, layers=15), state_dict, device="cpu", fmt=fmt).serve([(V, F)])[0]
        assert got.shape == (V.shape[0], 3) and np.isfinite(got).all()
        ref = _jax_answer(params, V, F, fmt)
        assert rel(got, ref) <= tol_jax, (fmt, rel(got, ref))
        assert rel(got, ref64) <= tol_64, (fmt, rel(got, ref64))


def test_normal_server_bucket_and_order():
    """A fixed bucket pads without changing the answer's vertex order, and
    BSR answers come back in the request's own order."""
    V, F = jdatasets.random_blob_mesh(np.random.default_rng(2), 150)
    model = init_weights(LapDeepModel(3, 3, layers=15), torch.Generator().manual_seed(3))
    server = NormalServer(model, device="cpu", fmt="bsr", bucket=256)
    req = server.prepare(V, F)
    assert req.inputs.shape == (1, 256, 3) and req.mask.shape == (1, 256, 1)
    assert req.perm is not None and sorted(req.perm) == list(range(150))
    assert float(req.mask.sum()) == 150
    (out,) = server.serve([(V, F)])
    assert out.shape == (150, 3) and server.device_ms == []
    with pytest.raises(ValueError):
        NormalServer(model, device="cpu", bucket=100)
    with pytest.raises(ValueError):
        NormalServer(model, device="cpu", fmt="dense")


def test_params_from_flax_mapping_and_errors(trained):
    params, state_dict = trained
    k = np.asarray(params["rn0"]["bn_fc0"]["fc"]["kernel"])
    np.testing.assert_array_equal(state_dict["rn0.bn_fc0.fc.weight"].numpy(), k.T)
    np.testing.assert_array_equal(state_dict["rn0.bn_fc0.bn.weight"].numpy(),
                                  np.asarray(params["rn0"]["bn_fc0"]["bn"]["scale"]))
    model = LapDeepModel(3, 3, layers=15)
    missing = {k: v for k, v in params.items() if k != "rn14"}
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(missing, like=model)
    surplus = dict(params, extra={"fc": {"bias": np.zeros(3, np.float32)}})
    with pytest.raises(KeyError, match="surplus"):
        params_from_flax(surplus, like=model)
    with pytest.raises(KeyError, match="unknown flax leaf"):
        params_from_flax({"conv1": {"fc": {"mean": np.zeros(3, np.float32)}}})
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(params, like=LapDeepModel(3, 4, layers=15))
