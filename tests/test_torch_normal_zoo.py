"""The rest of the normal zoo in the port against the JAX package on the CPU:
the edge-flip augmentation (``geometry.repair``, ``geometry.graph_ops``),
``IdResNet2``, ``gat_attend`` and ``GatResNet2``, the AvgModel, MlpModel,
IdDeepModel and GatDeepModel forwards and gradients, the trainer's
``--model avg|mlp|id|gat`` step and its ``--flip-variants`` samples, and the
``--bf16`` GAT and Id models unit by unit.

Inputs are seeded numpy arrays handed to both packages; flax parameters,
moved off init by seeded noise, are converted by ``convert.py``.
Tolerances, relative to ``max|ref|`` (``assert_close``): fp64 under
``jax.enable_x64`` to 1e-6 (the same sums in another order); a gradient
that is zero in exact arithmetic (a per-channel constant a later batch norm
removes) within 1e-12 of the largest gradient in both packages; the flips
and the packed batches exactly.  ``gat_attend`` is held against both of the
JAX package's formulations (banded, the RCM-ordered pattern's window > 0;
and the slot gather, ``force_gather=True``), which compute the same
function; under ``enable_x64`` the banded one does not trace (its
``dynamic_slice`` mixes int32 and int64 indices), so every fp64 comparison
hands JAX the pattern with ``window=0``, its slot gather, and the banded
formulation (the JAX trainer's own, on RCM order) is held in fp32, to
GAT_FP32_RTOL.  The bf16 models are held as
``tests/test_torch_bf16_models.py`` holds the others
(``torch_parity.hold_bf16_model``).  The trainer's steps and the bf16
models are in ``test_torch_normal_zoo_steps.py`` (split so that ``--dist
loadfile`` balances the files)."""

import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu.cli import train_normal as jtrain
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.geometry import graph_ops as jgraph
from surfacenetworks_tpu.geometry import repair as jrepair
from surfacenetworks_tpu.models import normal_models as jmodels
from surfacenetworks_tpu.nn import blocks as jblocks
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu_torch.cli import train_normal as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.geometry import graph_ops as tgraph
from surfacenetworks_tpu_torch.geometry import repair as trepair
from surfacenetworks_tpu_torch.models import normal_models as tmodels
from surfacenetworks_tpu_torch.nn import blocks as tblocks
from surfacenetworks_tpu_torch.train import losses as tlosses

from test_torch_normal_train import OBJS, _objs
from torch_parity import (assert_close, blob_laplacian, hold_grads, operators, perturbed_params, profile_flag_writes_trace,
                          rcm)

FP64_RTOL = 1e-6
STEP_RTOL = 1e-4  # the trainer's fp32 loss against JAX's fp32 loss
ADAM_ATOL = 3e-7  # two fp32 ulps at |p| < 2: the update's arithmetic in another order
NULL_FP32 = 1e-4  # an fp32 gradient that is zero in exact arithmetic, of the largest gradient
# as in tests/test_torch_arap.py and test_torch_mnist.py: fp32 rounding noise
# whose ratio is a matter of summation order (the Avg blocks' batch norms
# read a global-average channel that is nearly constant over the batch)
FP32_RATIO = 10
# The port in fp64 against JAX's banded attention in fp32: fp32 rounding of
# scores, softmax and sums of at most 16 slots, each a few ulps of the
# largest value.
GAT_FP32_RTOL = 1e-5
LAYERS = 2
N = 160  # a 150-vertex blob padded to 160 rows
JMODELS = {"avg": jmodels.AvgModel, "mlp": jmodels.MlpModel, "id": jmodels.IdDeepModel, "gat": jmodels.GatDeepModel}
TMODELS = {"avg": tmodels.AvgModel, "mlp": tmodels.MlpModel, "id": tmodels.IdDeepModel, "gat": tmodels.GatDeepModel}


def _gather_form(jop):
    """A JAX ELL operator with ``window=0``: its ``gat_attend`` takes the
    slot gather (the banded formulation does not trace under x64)."""
    return jop.replace(fwd=jop.fwd.replace(window=0))


def _null_grads(name: str, layers: int = LAYERS) -> set:
    """Zero in exact arithmetic.  MlpModel: a per-channel constant passes
    every Mlp block unchanged (its batch norms remove it, its residual
    carries it) and the final ``bn`` removes it, so conv1's bias and each
    block's fc biases are null.  IdDeepModel: the last block's output
    reaches only conv2's 'pre' batch norm, so its last conv's biases are."""
    if name == "mlp":
        return {"conv1.fc.bias"} | {f"rn{i}.fc{j}.fc.bias" for i in range(layers) for j in (0, 1)}
    if name == "id":
        return {f"rn{layers - 1}.bn_fc1.fc.bias", f"rn{layers - 1}.bn_fc1.bn.bias"}
    return set()


# ---------------------------------------------------------------------------
# edge flips
# ---------------------------------------------------------------------------


def _meshes():
    out = [jdatasets.random_blob_mesh(np.random.default_rng(s), n) for s, n in ((1, 150), (2, 400))]
    return out + [jgeo.load_obj(p) for p in _objs()[:3]]


def test_graph_ops_match_jax():
    """``vertex_adjacency`` and ``triangle_triangle_adjacency`` equal the JAX
    package's on blob meshes and fixture meshes."""
    for V, F in _meshes():
        np.testing.assert_array_equal(tgraph.vertex_adjacency(F, V.shape[0]).toarray(),
                                      jgraph.vertex_adjacency(F, V.shape[0]).toarray())
        for got, ref in zip(tgraph.triangle_triangle_adjacency(F), jgraph.triangle_triangle_adjacency(F)):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 5])
def test_constrained_edge_flip_matches_jax(seed):
    """The same ``default_rng`` seed flips the same edges: the flipped faces
    equal the JAX package's, on every mesh, with enough tries that many
    flips happen (and some are rejected)."""
    for V, F in _meshes():
        n = max(F.shape[0] // 4, 4)
        _, got = trepair.constrained_edge_flip(V, F, n, rng=np.random.default_rng(seed))
        _, ref = jrepair.constrained_edge_flip(V, F, n, rng=np.random.default_rng(seed))
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        assert (got != F).any(axis=1).sum() >= 2


def _jax_flip_variants(train, k, seed, hack=1.0):
    """The variants the JAX trainer's ``main`` appends for ``--flip-variants
    k`` (its inline loop, run here with the JAX package's functions)."""
    rng_f = np.random.default_rng(seed + 101)
    extra = []
    for s in train:
        for i in range(k):
            _, F2 = jrepair.constrained_edge_flip(s["V"], s["F"], num_flipped_edges=max(s["F"].shape[0] // 10, 4),
                                                  rng=rng_f)
            extra.append({"V": s["V"], "F": np.asarray(F2, dtype=np.asarray(s["F"]).dtype), "input": s["input"],
                          "target": jgeo.vertex_normals(s["V"], F2).astype(np.float32),
                          "name": f"{s.get('name', 'mesh')}_flip{i}",
                          "L": jgeo.igl_style_laplacian(s["V"], F2, hack=hack)})
    return extra


def _argv(model, tmp_path, *extra):
    return ["--data-path", str(OBJS), "--model", model, "--layer", str(LAYERS), "--batch-size", "2",
            "--num-updates", "1", "--num-epoch", "1", "--result-dir", str(tmp_path), *extra]


def _jax_run(model, tmp_path, flips=0):
    """The JAX trainer's split, flip variants, RCM order (gat) and bucket."""
    jargs = jtrain.parser.parse_args(_argv(model, tmp_path, "--flip-variants", str(flips)))
    random.seed(jargs.seed)
    train, test = jtrain.load_samples(jargs, lambda _: None)
    if flips:
        train = train + _jax_flip_variants(train, flips, jargs.seed)
    if model == "gat":
        train = [jbat.rcm_reorder_sample(s) for s in train]
        test = [jbat.rcm_reorder_sample(s) for s in test]
    return jargs, train, test, jbat.BucketSet.for_samples(train + test, n_tiers=1, multiple=8).tiers[-1]


@pytest.mark.parametrize("model", ["avg", "gat"])
def test_flip_variants_match_jax(model, tmp_path):
    """``--flip-variants 2``: the trainer's train samples (originals, then
    two variants of each, RCM-ordered for gat) equal the JAX trainer's name
    for name: faces, inputs and targets exactly, Laplacians to 1e-6."""
    trainer = ttrain.NormalTrainer(ttrain.parser.parse_args(
        _argv(model, tmp_path, "--device", "cpu", "--flip-variants", "2")), log=lambda _: None)
    _, jtrain_s, jtest_s, _ = _jax_run(model, tmp_path, flips=2)
    assert [s["name"] for s in trainer.train_samples] == [s["name"] for s in jtrain_s]
    assert len(trainer.train_samples) == 3 * 8 and any("_flip1" in s["name"] for s in jtrain_s)
    for got, ref in zip(trainer.train_samples + trainer.test_samples, jtrain_s + jtest_s):
        for k in ("F", "input", "target"):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{got['name']} {k}")
        assert_close(got["L"].toarray(), ref["L"].toarray(), FP64_RTOL, f"{got['name']} L")
    originals = {s["name"]: s for s in trainer.train_samples[:8]}
    assert all((v["F"] != originals[v["name"].rsplit("_flip", 1)[0]]["F"]).any() for v in trainer.train_samples[8:])


# ---------------------------------------------------------------------------
# blocks and the attention
# ---------------------------------------------------------------------------


def _mesh_case(seed=3, batch=2):
    """An RCM-ordered blob Laplacian in ELL as both packages pack it, a mask
    of its 150 rows in 160, and a seeded generator."""
    _, _, L = blob_laplacian(seed, 150)
    L = rcm(L)
    jop, top = operators(L, N, "ell", batch)
    mask = np.zeros((batch, N, 1), np.float32)
    mask[:, :150] = 1.0
    return jop, top, mask, np.random.default_rng(seed)


def _gat_args(rng, batch, heads=4, ch=5):
    xh = rng.normal(size=(batch, N, heads, ch))
    return xh, rng.normal(size=(batch, N, heads)), rng.normal(size=(batch, N, heads))


@pytest.mark.parametrize("form", ["banded", "gather"])
def test_gat_attend_matches_jax(form):
    """``gat_attend`` in fp64, batched (B=2), against the JAX package's
    banded formulation (the RCM pattern's window is 256; JAX in fp32, to
    GAT_FP32_RTOL) and, batched and on one operator, its slot gather
    (``force_gather``, fp64 under x64, to 1e-6): the output and the gradients of ``xh``,
    ``s_src`` and ``s_dst`` under a seeded cotangent; padded rows (no live
    slot) are zero.  A dead slot's column must not matter: pointing the
    padding slots at another row leaves every value as it was."""
    jop, top, _, rng = _mesh_case()
    assert 0 < int(jop.fwd.window) <= 2048
    xh, ss, sd = _gat_args(rng, 2)
    cot = rng.normal(size=xh.shape)

    def port(op, xh, ss, sd, cot):
        args = [torch.from_numpy(a).requires_grad_() for a in (xh, ss, sd)]
        out = tblocks.gat_attend(op, *args)
        (out * torch.from_numpy(cot)).sum().backward()
        return out.detach().numpy(), [a.grad.numpy() for a in args]

    def take(op, lead):
        return tblocks.EllOperator(**{part: tblocks.dataclasses.replace(
            getattr(op, part), cols=getattr(op, part).cols[lead], vals=getattr(op, part).vals[lead])
            for part in ("fwd", "bwd")})

    x64, rtol = (True, FP64_RTOL) if form == "gather" else (False, GAT_FP32_RTOL)
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        for lead in (slice(None), 0) if form == "gather" else (slice(None),):
            jo = jax.tree_util.tree_map(lambda a: a[lead], jop)
            a = (xh[lead], ss[lead], sd[lead])
            ref, vjp = jax.vjp(lambda *t: jblocks.gat_attend(jo, *t, force_gather=form == "gather"),
                               *(jnp.asarray(v, dt) for v in a))
            ref_g = vjp(jnp.asarray(cot[lead], dt))
            got, got_g = port(take(top, lead), *a, cot[lead])
            assert_close(got, ref, rtol, f"gat_attend out {lead}")
            for name, g, r in zip(("xh", "s_src", "s_dst"), got_g, ref_g):
                assert_close(g, r, rtol, f"gat_attend d{name} {lead}")
            assert (got[..., 150:, :, :] == 0).all()
    moved = copy.deepcopy(top)
    moved.fwd.cols[moved.fwd.vals == 0] = 7
    got, got_g = port(moved, xh, ss, sd, cot)
    ref, ref_g = port(top, xh, ss, sd, cot)
    np.testing.assert_array_equal(got, ref)
    for g, r in zip(got_g, ref_g):
        np.testing.assert_array_equal(g, r)


def _block_case(block: str):
    jop, top, mask, rng = _mesh_case(seed=4)
    x = (rng.normal(size=(2, N, 16)) * mask)
    jblock = {"id": lambda: jblocks.IdResNet2(16), "gat": lambda: jblocks.GatResNet2(16, heads=4)}[block]()
    tblock = {"id": lambda: tblocks.IdResNet2(16), "gat": lambda: tblocks.GatResNet2(16, heads=4)}[block]()
    return jblock, tblock, jop, top, mask, x, rng


@pytest.mark.parametrize("block", ["id", "gat"])
def test_block_matches_jax(block):
    """``IdResNet2`` and ``GatResNet2`` (16 channels, 4 heads) in fp64: the
    flax tree converts (GAT's bare ``att{0,1}_a_src``/``_a_dst`` ``[H, ch]``
    leaves included), and the output and every parameter's and the input's
    gradient under a seeded cotangent agree to 1e-6."""
    jblock, tblock, jop, top, mask, x, rng = _block_case(block)
    cot = rng.normal(size=x.shape)
    with jax.enable_x64(True):
        params = perturbed_params(jblock.init(jax.random.key(0), _gather_form(jop), jnp.asarray(mask),
                                              jnp.asarray(x, jnp.float32))["params"], 11)
        tblock.load_state_dict(params_from_flax(params, like=tblock), strict=True)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        ref, vjp = jax.vjp(lambda p, xx: jblock.apply({"params": p}, _gather_form(jop), jnp.asarray(mask, jnp.float64),
                                                      xx), p64, jnp.asarray(x))
        jp_g, jx_g = vjp(jnp.asarray(cot))
        jp_g = params_from_flax(jax.tree_util.tree_map(np.asarray, jp_g), like=tblock)
    t64 = tblock.double()
    xt = torch.from_numpy(x).requires_grad_()
    out = t64(top, torch.from_numpy(mask).double(), xt)
    (out * torch.from_numpy(cot)).sum().backward()
    assert_close(out.detach().numpy(), ref, FP64_RTOL, f"{block} out")
    assert_close(xt.grad.numpy(), jx_g, FP64_RTOL, f"{block} input gradient")
    for k, p in t64.named_parameters():
        assert_close(p.grad.numpy(), jp_g[k].double().numpy(), FP64_RTOL, f"{block} {k} gradient")


def _model_case(name: str, seed: int = 5):
    jop, top, mask, rng = _mesh_case(seed=seed)
    x = (rng.normal(size=(2, N, 3)) * mask).astype(np.float32)
    tgt = rng.normal(size=(2, N, 3)).astype(np.float32)
    return jop, top, mask, x, tgt


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_model_matches_jax(name):
    """Each model at 2 layers in fp64 under the cosine loss: the output, the
    loss and every parameter's gradient to 1e-6 (the null ones within 1e-12
    of the largest gradient in both packages); the port's submodule names
    take the flax tree as it is (Mlp's final ``bn`` included)."""
    jop, top, mask, x, tgt = _model_case(name)
    jm = JMODELS[name](3, 3, LAYERS)
    tm = TMODELS[name](3, 3, LAYERS)
    params = perturbed_params(jm.init(jax.random.key(0), jop, jnp.asarray(mask), jnp.asarray(x))["params"], 13)
    tm.load_state_dict(params_from_flax(params, like=tm), strict=True)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        m64, t64 = jnp.asarray(mask, jnp.float64), jnp.asarray(tgt, jnp.float64)

        def objective(p):
            out = jm.apply({"params": p}, _gather_form(jop), m64, jnp.asarray(x, jnp.float64))
            return jlosses.normal_cosine_loss(out, m64, t64), out

        (jloss, jout), jg = jax.value_and_grad(objective, has_aux=True)(p64)
        jg = {k: v.double().numpy() for k, v in params_from_flax(jax.tree_util.tree_map(np.asarray, jg),
                                                                 like=tm).items()}
    tm = tm.double()
    out = tm(top, torch.from_numpy(mask).double(), torch.from_numpy(x).double())
    loss = tlosses.normal_cosine_loss(out, torch.from_numpy(mask).double(), torch.from_numpy(tgt).double())
    loss.backward()
    assert_close(out.detach().numpy(), jout, FP64_RTOL, f"{name} output")
    assert_close(loss.detach().numpy(), jloss, FP64_RTOL, f"{name} loss")
    hold_grads({k: p.grad.numpy() for k, p in tm.named_parameters()}, jg, FP64_RTOL, _null_grads(name),
               f"{name} fp64 gradient")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _dense(cols, vals):
    """``[B, R, K]`` ELL slots as dense ``[B, R, R]`` matrices."""
    out = np.zeros(cols.shape[:2] + (cols.shape[1],), np.float64)
    b, r = np.indices(cols.shape[:2])
    np.add.at(out, (b[..., None], r[..., None], cols), vals)
    return out


def _fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def test_train_normal_zoo_main_cpu(tmp_path):
    """``main`` end to end on the fixtures with ``--flip-variants 1`` (gat,
    also with ``--bf16``, and mlp; the step of every model is held above):
    finite losses, the log's flip and format lines, and a checkpoint of the
    right model; ``--data-parallel`` with the cascade and
    ``--graph-parallel`` with mlp exit with the JAX trainer's messages
    (``--graph-parallel`` with gat, refused by name before it was ported,
    runs: ``tests/test_torch_dist_gp_train.py``), and ``--jax-profile``
    writes a trace of the first epoch (gat)."""
    for model, extra in (("mlp", []), ("gat", []), ("gat", ["--bf16"])):
        out = tmp_path / f"{model}{len(extra)}"
        hist = ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--model", model, "--layer", "2",
                            "--num-epoch", "1", "--num-updates", "2", "--batch-size", "2", "--flip-variants", "1",
                            "--result-dir", str(out), *extra])
        (loss, mad), = hist["train"]
        assert np.isfinite(loss) and np.isfinite(mad) and len(hist["test"]) == 1
        log = (out / "log" / "debug.log").read_text()
        assert "flip augmentation: +8 variants" in log and "Train size: 16 Test size: 2" in log
        if model == "gat":
            assert "operator format -> ell" in log
        keys = torch.load(out / "pts" / "debug_normal_state.pt", weights_only=True)["params"].keys()
        assert sorted(keys) == sorted(TMODELS[model](3, 3, 2).state_dict())
    with pytest.raises(SystemExit, match="--data-parallel does not support the cascade model"):
        ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--result-dir", str(tmp_path), "--data-parallel", "2",
                     "--model", "cas"])
    with pytest.raises(SystemExit, match="--graph-parallel supports the lap, dirac and gat models"):
        ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--result-dir", str(tmp_path), "--graph-parallel",
                     "2", "--model", "mlp"])
    trace = profile_flag_writes_trace(ttrain.main, ["--device", "cpu", "--data-path", str(OBJS), "--model", "gat",
                                                    "--layer", "2", "--num-epoch", "1", "--num-updates", "1",
                                                    "--batch-size", "2"], tmp_path)
    assert any("gather" in e.get("name", "") or "index" in e.get("name", "") for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------
