"""Serving from an exported artifact on the CPU: the port's ``serve.
export_forward`` / ``load`` / ``export_info`` against the JAX package's
(``platforms=("cpu",)``) on a 120-vertex synthetic mesh at 2 layers, the
port's weights converted from the flax ones (``convert.params_from_flax``):
the Lap model baked, with the operator at run time and in bf16, and the
Dirac model; the kernels recorded as ``snx::`` custom ops; ``export_info``'s
keys; the platforms a torch artifact refuses; and ``cli/export_model.py``
for ``--synthetic`` with both models, as ``tests/test_serve.py`` runs the
JAX package's.

Tolerances (relative Frobenius against JAX's artifact on the same inputs):
1e-5 for fp64 artifacts of both packages; fp32 artifacts against JAX's fp64
one, no farther than twice JAX's fp32 artifact plus 1e-6 (its rounding
where ``L x`` cancels puts JAX's own fp32 artifact 2.2e-4 from fp64 here,
so 1e-5 between two fp32 artifacts cannot hold); 2e-2 in bf16 (bf16
rounding of the same values, a few ulps of 2^-8 through two layers).
Against the port's own eager forward: bit for bit (the same kernels in the
same order)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu import models as jzoo
from surfacenetworks_tpu import serve as jserve
from surfacenetworks_tpu.data import Buckets as JBuckets
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.data import dirac_batch as jdirac_batch
from surfacenetworks_tpu.data import laplacian_batch as jlaplacian_batch
from surfacenetworks_tpu_torch import serve as tserve
from surfacenetworks_tpu_torch.cli import export_model
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import Buckets, datasets, dirac_batch, laplacian_batch
from surfacenetworks_tpu_torch.data.pipeline import _map_tensors
from surfacenetworks_tpu_torch.models import DirDeepModel, LapDeepModel

FP32_RTOL = 1e-5
BF16_RTOL = 2e-2
LAYERS = 2


def _double(t: torch.Tensor) -> torch.Tensor:
    return t.double() if t.is_floating_point() else t


def _fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _case(kind: str, bf16: bool = False):
    """The JAX model, params, batch and operator, and the port's model
    (with the converted params) and batch, on the same synthetic mesh."""
    jsamples = jdatasets.synthetic_normal_dataset(1, 120, seed=0, operator=kind)
    jbatch = (jdirac_batch if kind == "dirac" else jlaplacian_batch)(jsamples, JBuckets.for_samples(jsamples))
    jop = jax.device_put(jbatch.operator)
    jdt = jnp.bfloat16 if bf16 else None
    jmodel = (jzoo.DirDeepModel(3, 3, LAYERS, dtype=jdt) if kind == "dirac"
              else jzoo.LapDeepModel(3, 3, layers=LAYERS, dtype=jdt))
    params = jmodel.init(jax.random.key(0), jop, jnp.asarray(jbatch.mask), jnp.asarray(jbatch.inputs))["params"]
    samples = datasets.synthetic_normal_dataset(1, 120, seed=0, operator=kind)
    batch = (dirac_batch if kind == "dirac" else laplacian_batch)(samples, Buckets.for_samples(samples))
    dt = torch.bfloat16 if bf16 else None
    model = DirDeepModel(3, 3, LAYERS, dtype=dt) if kind == "dirac" else LapDeepModel(3, 3, layers=LAYERS, dtype=dt)
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, params), like=model)
    np.testing.assert_array_equal(batch.inputs.numpy(), jbatch.inputs)
    return jmodel, params, jop, jbatch, model, state, batch


def _f64(tree):
    """Floating leaves of a JAX tree (params, operator) in fp64."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _exported(jmodel, params, jop, jbatch, model, state, batch, bake: bool):
    """Each package's artifact run on the batch: (JAX's, the port's)."""
    jblob = jserve.export_forward(jmodel, params, jop, jbatch.mask, jbatch.inputs, bake_operator=bake,
                                  platforms=("cpu",))
    blob = tserve.export_forward(model, state, batch.operator, batch.mask, batch.inputs, bake_operator=bake,
                                 platforms=("cpu",))
    assert isinstance(blob, bytes) and len(blob) > 1000
    jfn, fn = jserve.load(jblob), tserve.load(blob)
    if bake:
        return np.asarray(jfn(jnp.asarray(jbatch.inputs))), fn(batch.inputs), blob
    jleaves = [jnp.asarray(a) for a in jax.tree_util.tree_leaves(jop)]
    leaves, _ = tserve.operator_leaves(batch.operator)
    # JAX's leaves in JAX's order; the port's own fields (the Dirac overflow map) after them
    assert len(leaves) >= len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = jfn(jnp.asarray(jbatch.inputs), jnp.asarray(jbatch.mask), *jleaves)
    return np.asarray(ref), fn(batch.inputs, batch.mask, *leaves), blob


@pytest.mark.parametrize("case", ["lap", "lap runtime operator", "lap bf16", "dirac", "dirac runtime operator"])
def test_artifact_matches_jax(case):
    """fp32 and bf16 artifacts against JAX's, and (fp32 cases) fp64
    artifacts of both packages against each other.  In fp32 the model's
    rounding where ``L x`` cancels puts JAX's own artifact 2.2e-4 (Lap) and
    1.4e-5 (Dirac) from its fp64 forward on this mesh, so the fp32 bound
    is the fast path's rule (``tests/test_torch_train.py``): the port's
    artifact no farther from JAX's fp64 forward than twice JAX's artifact,
    plus 1e-6; the fp64 artifacts agree to 1e-5 (in fact 2.6e-13 for Lap, and
2.5e-8 for Dirac, whose output both packages cast to fp32)."""
    kind = case.split()[0]
    bake = "runtime" not in case
    bf16 = "bf16" in case
    jmodel, params, jop, jbatch, model, state, batch = _case(kind, bf16)
    ref, got, blob = _exported(jmodel, params, jop, jbatch, model, state, batch, bake)
    assert got.shape == ref.shape and got.dtype == torch.float32 and torch.isfinite(got).all()
    with torch.no_grad():
        eager = model(batch.operator, batch.mask, batch.inputs)
    assert torch.equal(got, eager)
    program = torch.export.load(io.BytesIO(blob))
    ops = [str(n.target) for n in program.graph.nodes if "snx" in str(n.target)]
    want = 0 if kind == "dirac" else 2 * ((LAYERS + 1) // 2)  # two applies a WideLapResNet2 block
    assert len(ops) == want and all(o.startswith("snx.ell_matmul") for o in ops), ops
    if bf16:
        assert _fro(got.numpy(), ref) <= BF16_RTOL, _fro(got.numpy(), ref)
        return
    with jax.enable_x64(True):
        jbatch64 = jbatch.__class__(**{**jbatch.__dict__, "inputs": np.asarray(jbatch.inputs, np.float64),
                                       "mask": np.asarray(jbatch.mask, np.float64)})
        ref64, got64, _ = _exported(jmodel, _f64(params), _f64(jop), jbatch64, model.double(),
                                    {k: v.double() for k, v in state.items()},
                                    batch.__class__(**{**batch.__dict__, "inputs": batch.inputs.double(),
                                                       "mask": batch.mask.double(),
                                                       "operator": _map_tensors(batch.operator, _double)}), bake)
    # the Dirac model's output is cast to fp32 in both packages
    assert got64.dtype == (torch.float32 if kind == "dirac" else torch.float64)
    assert _fro(got64.numpy(), ref64) <= FP32_RTOL, _fro(got64.numpy(), ref64)
    bound = 2 * _fro(ref, ref64) + 1e-6
    assert _fro(got.numpy(), ref64) <= bound, (_fro(got.numpy(), ref64), bound)


def test_export_info_matches_jax():
    jmodel, params, jop, jbatch, model, state, batch = _case("lap")
    for bake in (True, False):
        jinfo = jserve.export_info(jserve.export_forward(jmodel, params, jop, jbatch.mask, jbatch.inputs,
                                                         bake_operator=bake, platforms=("cpu",)))
        info = tserve.export_info(tserve.export_forward(model, state, batch.operator, batch.mask, batch.inputs,
                                                        bake_operator=bake, platforms=("cpu",)))
        assert set(info) == set(jinfo) == {"platforms", "in_avals", "out_avals", "nr_devices"}
        assert info["platforms"] == ["cpu"] and info["nr_devices"] == jinfo["nr_devices"] == 1
        assert len(info["in_avals"]) == len(jinfo["in_avals"]) and len(info["out_avals"]) == 1
        for got, ref in zip(info["in_avals"] + info["out_avals"], jinfo["in_avals"] + jinfo["out_avals"]):
            assert got == ref.replace("f32", "float32").replace("i32", "int32"), (got, ref)


@pytest.mark.parametrize("platforms", [("tpu", "cpu"), ("tpu",), ("cuda", "cpu")])
def test_export_refuses_more_than_one_platform(platforms):
    _, _, _, _, model, state, batch = _case("lap")
    with pytest.raises(SystemExit, match="one device"):
        tserve.export_forward(model, state, batch.operator, batch.mask, batch.inputs, platforms=platforms)


@pytest.mark.parametrize("model", ["lap", "dirac"])
def test_export_cli(model, tmp_path):
    """``cli.export_model`` with ``--synthetic``: artifact -> load -> run,
    as ``tests/test_serve.py`` runs the JAX package's; the Lap model with a
    JAX checkpoint restored (``--deser``) equals the model it holds."""
    out = str(tmp_path / "m.snx")
    info = export_model.main(["--synthetic", "--model", model, "--layer", str(LAYERS), "--platforms", "cpu",
                              "--out", out])
    blob = open(out, "rb").read()
    assert info == tserve.export_info(blob)
    n = int(info["in_avals"][0].split(",")[1])
    res = tserve.load(blob)(torch.zeros((1, n, 3)))
    assert res.shape == (1, n, 3) and torch.isfinite(res).all()
    if model == "lap":
        from surfacenetworks_tpu.train import checkpoint as jckpt

        _, params, _, _, port_model, state, batch = _case("lap")
        jckpt.save_checkpoint(str(tmp_path / "j.msgpack"), params)
        export_model.main(["--synthetic", "--layer", str(LAYERS), "--platforms", "cpu", "--deser",
                           str(tmp_path / "j.msgpack"), "--out", out])
        port_model.load_state_dict(state)
        with torch.no_grad():
            want = port_model(batch.operator, batch.mask, batch.inputs)
        assert torch.equal(tserve.load(open(out, "rb").read())(batch.inputs), want)
