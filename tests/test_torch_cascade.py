"""The multiresolution cascade in the port against the JAX package on the
CPU: the Laplacian pyramid (``geometry.coarsening``, including the vertices
a tight bucket drops), ``cascade_batch``, ``max_pool2`` and ``upsample2``,
``EfficientCascade`` over its option grid, ``GlobalLocalModel`` and
``LapMATModel``, the bf16 cascade unit by unit, and ``train_normal --model
cas``'s first step.

Inputs are seeded numpy arrays and seeded synthetic meshes handed to both
packages; flax parameters, moved off init by seeded noise, are converted by
``convert.py``.  Tolerances, as the normal zoo's
(``tests/test_torch_normal_zoo.py``), relative to ``max|ref|``
(``assert_close``): the pyramid, the batches and the pooling exact; fp64
under ``jax.enable_x64`` to 1e-6 (the same sums in another order); the
trainer's fp32 loss within 1e-4 of JAX's fp32 loss, each fp32 gradient no
farther (relative Frobenius) from the fp64 step than FP32_RATIO x JAX's own
fp32 distance from it, plus 1e-6, and the parameters after one Adam update
within 3e-7 of optax's update of the port's gradients.  The bf16 cascade is
held as ``tests/test_torch_bf16_models.py`` holds the other models
(``torch_parity.hold_bf16_model``)."""

import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfacenetworks_tpu.cli import train_normal as jtrain
from surfacenetworks_tpu.cli.common import EpochSampler as JEpochSampler
from surfacenetworks_tpu.data import Buckets as JBuckets
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.geometry import coarsening as jcoarse
from surfacenetworks_tpu.models import cascade as jcascade
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.cli import train_normal as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import Buckets as TBuckets
from surfacenetworks_tpu_torch.data import batching as tbat
from surfacenetworks_tpu_torch.geometry import coarsening as tcoarse
from surfacenetworks_tpu_torch.models import cascade as tcascade
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as toptim

from torch_parity import BF16, assert_close, hold_bf16_model, hold_grads, perturbed_params, same_operator, to_jax

FP64_RTOL = 1e-6
STEP_RTOL = 1e-4
ADAM_ATOL = 3e-7
FP32_RATIO = 10
LEVELS = 3
NB = 64  # the finest bucket of the model tests, divisible by 2**(LEVELS-1)


def _samples(n=2, points=50, seed=0):
    return jdatasets.synthetic_normal_dataset(n, points, seed=seed, operator="lap")


# ---------------------------------------------------------------------------
# the pyramid and the batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels,points,bucket,seed", [(3, 50, 64, 0), (3, 150, None, 1), (4, 150, 160, 2),
                                                      (4, 400, 400, 3), (4, 2000, 2000, 0)])
def test_pyramid_matches_jax(levels, points, bucket, seed):
    """``build_pyramid`` on a synthetic mesh: the fine order (``perm``), each
    level's real count and Laplacian (values, pattern, dtype) equal the JAX
    package's; so do ``pyramid_mask`` and ``reorder_fine_data``.  Both drop
    the same vertices (mask 0), most in a tight bucket (``n_bucket`` = the
    vertex count rounded to ``2**(levels-1)``): at 2,000 vertices and 4
    levels, 217."""
    s = _samples(1, points, seed)[0]
    got = tcoarse.build_pyramid(s["V"], s["F"], levels, n_bucket=bucket)
    ref = jcoarse.build_pyramid(s["V"], s["F"], levels, n_bucket=bucket)
    np.testing.assert_array_equal(got.perm, ref.perm)
    assert [lv.n_real for lv in got.levels] == [lv.n_real for lv in ref.levels]
    for i, (g, r) in enumerate(zip(got.levels, ref.levels)):
        assert g.L.dtype == r.L.dtype == np.float32 and g.L.shape == r.L.shape, i
        np.testing.assert_array_equal(g.L.toarray(), r.L.toarray(), err_msg=f"level {i}")
        np.testing.assert_array_equal(g.L.indptr, r.L.indptr)
        np.testing.assert_array_equal(g.L.indices, r.L.indices)
    np.testing.assert_array_equal(tcoarse.pyramid_mask(got), jcoarse.pyramid_mask(ref))
    np.testing.assert_array_equal(tcoarse.reorder_fine_data(got, s["target"]),
                                  jcoarse.reorder_fine_data(ref, s["target"]))
    dropped = points - got.finest.n_real
    assert dropped == points - ref.finest.n_real
    if (points, bucket) == (2000, 2000):
        assert dropped == 217


@pytest.mark.parametrize("levels,bucket", [(3, 160), (4, 152)])
def test_cascade_batch_matches_jax(levels, bucket):
    """``cascade_batch`` of two meshes: inputs, targets, mask and every
    level's operator (forward and stored transpose at K=32, coarsest first)
    equal the JAX package's bit for bit; the operator is a tuple."""
    samples = _samples(2, 150, seed=4)
    got = tbat.cascade_batch(samples, levels, bucket)
    ref = jbat.cascade_batch(samples, levels, bucket)
    for k in ("inputs", "targets", "mask"):
        assert getattr(got, k).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)
    assert isinstance(got.operator, tuple) and len(got.operator) == len(ref.operator) == levels
    for lvl, (g, r) in enumerate(zip(got.operator, ref.operator)):
        assert g.fwd.cols.shape == (2, bucket >> (levels - 1 - lvl), 32)
        same_operator(g, r, "ell")
    assert got.names == ref.names


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


def test_pooling_matches_jax():
    """``max_pool2`` and ``upsample2`` forward and VJP equal JAX's on an
    input whose pairs tie in half the rows (``jnp.max`` splits a tie's
    gradient evenly, and so must the port); a pooling by ``max(dim)`` (the
    gradient to one of the tied pair) and an upsample by tiling differ."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 5))
    x[:, 1::4] = x[:, 0::4]  # rows 4j and 4j+1 tie
    cot_p, cot_u = rng.normal(size=(2, 8, 5)), rng.normal(size=(2, 32, 5))
    with jax.enable_x64(True):
        for tfn, jfn, cot in ((tcascade.max_pool2, jcascade.max_pool2, cot_p),
                              (tcascade.upsample2, jcascade.upsample2, cot_u)):
            ref, vjp = jax.vjp(jfn, jnp.asarray(x))
            (ref_g,) = vjp(jnp.asarray(cot))
            xt = torch.from_numpy(x).requires_grad_()
            out = tfn(xt)
            out.backward(torch.from_numpy(cot))
            np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
            np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_g))
    xt = torch.from_numpy(x).requires_grad_()
    xt.reshape(2, 8, 2, 5).max(dim=2).values.backward(torch.from_numpy(cot_p))
    assert not np.array_equal(xt.grad.numpy(), np.asarray(jax.vjp(jcascade.max_pool2, jnp.asarray(x))[1](
        jnp.asarray(cot_p))[0]))
    tiled = torch.from_numpy(x).repeat(1, 2, 1).numpy()
    assert not np.array_equal(tiled, tcascade.upsample2(torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _case(levels=LEVELS, bucket=NB, seed=5):
    """Two synthetic meshes packed by both packages (equal, as held above),
    seeded targets."""
    samples = _samples(2, 50, seed)
    tb = tbat.cascade_batch(samples, levels, bucket)
    jb = jbat.cascade_batch(samples, levels, bucket)
    tgt = np.random.default_rng(seed).normal(size=tb.inputs.shape).astype(np.float32)
    return samples, tb, jb, tgt


def _jit_init(jm, *args) -> dict:
    """Flax ``jm``'s initial parameters on ``args`` (compiled: faster than
    flax's op-by-op init at these widths)."""
    return jax.jit(lambda k: jm.init(k, *args))(jax.random.key(0))["params"]


def _fp64_model_check(what, jm, tm, jargs, targs, loss_j, loss_t, seed, null=frozenset()):
    """Flax ``jm`` and the port's ``tm`` at the same perturbed parameters in
    fp64: the output, the loss and every parameter's gradient to 1e-6."""
    params = perturbed_params(_jit_init(jm, *jargs), seed)
    tm.load_state_dict(params_from_flax(params, like=tm), strict=True)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        a64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64) if jnp.asarray(a).dtype == jnp.float32
                                     else jnp.asarray(a), jargs)

        def objective(p):
            out = jm.apply({"params": p}, *a64)
            return loss_j(out), out

        (jloss, jout), jg = jax.jit(jax.value_and_grad(objective, has_aux=True))(p64)
        jg = {k: v.double().numpy() for k, v in params_from_flax(jax.tree_util.tree_map(np.asarray, jg),
                                                                 like=tm).items()}
    tm = tm.double()
    out = tm(*targs)
    loss = loss_t(out)
    loss.backward()
    assert_close(out.detach().numpy(), jout, FP64_RTOL, f"{what} output")
    assert_close(loss.detach().numpy(), jloss, FP64_RTOL, f"{what} loss")
    hold_grads({k: p.grad.numpy() for k, p in tm.named_parameters()}, jg, FP64_RTOL, null, f"{what} fp64 gradient")


OPTIONS = {
    "default": (LEVELS, {}),
    "learned pooling": (LEVELS, {"naive_pool": False}),
    "with avg": (LEVELS, {"with_avg": True}),
    "bottleneck": (4, {"bottleneck": True}),
    "no batch norm": (LEVELS, {"bnmode": None}),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_efficient_cascade_matches_jax(option):
    """``EfficientCascade`` (2 inner layers) in fp64 under the cosine loss
    for each option: the output, the loss and every parameter's gradient to
    1e-6; the submodule names take the flax tree as it is (``down_pool{i}``
    and ``up_pool{i}``'s ``lap``, ``down_avg{i}``).  ``bottleneck`` runs
    at 4 levels, the depth its four widths are for."""
    levels, kw = OPTIONS[option]
    _, tb, jb, tgt = _case(levels)
    jm = jcascade.EfficientCascade(3, 3, cascade_levels=levels, **kw)
    tm = tcascade.EfficientCascade(3, 3, cascade_levels=levels, **kw)
    m64, t64 = torch.from_numpy(np.asarray(jb.mask)).double(), torch.from_numpy(tgt).double()
    _fp64_model_check(option, jm, tm, (jb.operator, jnp.asarray(jb.mask), jnp.asarray(jb.inputs)),
                      (tb.operator, m64, tb.inputs.double()),
                      lambda out: jlosses.normal_cosine_loss(out, jnp.asarray(jb.mask, jnp.float64),
                                                             jnp.asarray(tgt, jnp.float64)),
                      lambda out: tlosses.normal_cosine_loss(out, m64, t64), 13)


def test_global_local_model_matches_jax():
    """``GlobalLocalModel`` (a 3-level cascade and a LapDeepModel-2 over the
    same rows; outputs on the vertex axis, ``[B, 3N, 1]``) in fp64 under a
    seeded linear loss, with and without ``sigmoid``: the output and every
    gradient to 1e-6."""
    samples, tb, jb, _ = _case(seed=6)
    tl = tbat.laplacian_batch(samples, TBuckets(n_vertices=NB))
    jl = jbat.laplacian_batch(samples, JBuckets(n_vertices=NB))
    same_operator(tl.operator, jl.operator, "ell")
    w = np.random.default_rng(6).normal(size=(2, 3 * NB, 1))
    for sigmoid in (False, True):
        jm = jcascade.GlobalLocalModel(3, 1, cascade_levels=LEVELS, local_layers=2)
        tm = tcascade.GlobalLocalModel(3, 1, cascade_levels=LEVELS, local_layers=2)
        jargs = ((jb.operator, jl.operator), (jnp.asarray(jb.mask), jnp.asarray(jl.mask)), jnp.asarray(jb.inputs))
        targs = ((tb.operator, tl.operator), (tb.mask.double(), tl.mask.double()), tb.inputs.double())

        class Sig(torch.nn.Module):  # the port's model with ``sigmoid`` bound, so the check can call it
            def __init__(self, m):
                super().__init__()
                self.m = m

            def forward(self, *a):
                return self.m(*a, sigmoid=sigmoid)

        params = perturbed_params(_jit_init(jm, *jargs), 17)
        tm.load_state_dict(params_from_flax(params, like=tm), strict=True)
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)

            def objective(p):
                out = jm.apply({"params": p}, *jargs[:2], jnp.asarray(jb.inputs, jnp.float64), sigmoid=sigmoid)
                return jnp.sum(out * jnp.asarray(w)), out

            (jloss, jout), jg = jax.jit(jax.value_and_grad(objective, has_aux=True))(p64)
            jg = {k: v.double().numpy() for k, v in params_from_flax(jax.tree_util.tree_map(np.asarray, jg),
                                                                     like=tm).items()}
        t64 = Sig(tm).double()
        out = t64(*targs)
        assert out.shape == (2, 3 * NB, 1)
        loss = (out * torch.from_numpy(w)).sum()
        loss.backward()
        assert_close(out.detach().numpy(), jout, FP64_RTOL, f"global-local out sigmoid={sigmoid}")
        hold_grads({k: p.grad.numpy() for k, p in tm.named_parameters()}, jg, FP64_RTOL, set(),
                   f"global-local sigmoid={sigmoid}")


def test_lap_mat_model_matches_jax():
    """``LapMATModel`` (LapDeepModel-2, 2 outputs) in fp64 with a seeded
    mass that is negative on some rows (``max(mass, 0)``) and large enough
    elsewhere that some outputs clip at +-4: the output and every gradient
    to 1e-6 under a seeded linear loss."""
    samples, _, _, _ = _case(seed=7)
    tl = tbat.laplacian_batch(samples, TBuckets(n_vertices=NB))
    jl = jbat.laplacian_batch(samples, JBuckets(n_vertices=NB))
    rng = np.random.default_rng(7)
    mass = rng.uniform(-1.0, 400.0, size=(2, NB, 1)).astype(np.float32)
    w = rng.normal(size=(2, NB, 2))
    jm, tm = jcascade.LapMATModel(3, 2, layers=2), tcascade.LapMATModel(3, 2, layers=2)
    jargs = ((jl.operator, jnp.asarray(mass, jnp.float32)), jnp.asarray(jl.mask), jnp.asarray(jl.inputs))
    targs = ((tl.operator, torch.from_numpy(mass).double()), tl.mask.double(), tl.inputs.double())
    clipped = {}

    def loss_t(out):
        clipped["n"] = int((out[..., 1].abs() == 4.0).sum())
        return (out * torch.from_numpy(w)).sum()

    _fp64_model_check("LapMAT", jm, tm, jargs, targs, lambda out: jnp.sum(out * jnp.asarray(w)), loss_t, 19)
    assert 0 < clipped["n"] < 2 * NB


def test_efficient_cascade_bf16_matches_flax():
    """``EfficientCascade`` (3 levels, 2 inner layers) at ``dtype=bf16`` on
    two 150-vertex meshes in a 160-row bucket (its ELL applies take bf16 x,
    fp32 values): the output within BF16_OUT_RTOL and the step unit by unit
    (``hold_bf16_model``)."""
    samples = _samples(2, 150, seed=8)
    tb = tbat.cascade_batch(samples, LEVELS, 160)
    jb = jbat.cascade_batch(samples, LEVELS, 160)
    tgt = torch.from_numpy(np.random.default_rng(8).normal(size=tb.inputs.shape).astype(np.float32))
    worst = hold_bf16_model("cascade bf16", jcascade.EfficientCascade(3, 3, cascade_levels=LEVELS, dtype=BF16),
                            tcascade.EfficientCascade(3, 3, cascade_levels=LEVELS, dtype=torch.bfloat16),
                            (jb.operator, jnp.asarray(jb.mask), jnp.asarray(jb.inputs)),
                            (tb.operator, tb.mask, tb.inputs),
                            lambda o: tlosses.normal_cosine_loss(o, tb.mask, tgt), 23)
    assert worst["model_out"] > 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _argv(tmp_path, *extra):
    return ["--synthetic", "5", "--model", "cas", "--cascade-levels", str(LEVELS), "--batch-size", "2",
            "--num-updates", "1", "--num-epoch", "1", "--result-dir", str(tmp_path), *extra]


def _fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def test_cascade_step_matches_jax(tmp_path):
    """``train_normal --model cas --cascade-levels 3`` on five synthetic
    150-vertex meshes, batch 2:

    * the split and six batches' order equal the JAX trainer's, the bucket
      (152 rows: 150 rounded to 8, then to 4) and the first batch (inputs,
      targets, mask, every level's operator) equal JAX's ``cascade_batch``;
    * fp64, both packages (JAX under ``enable_x64``), the flax params moved
      off init and converted in: the loss, every gradient and the parameters
      after one Adam update (against optax) to 1e-6;
    * fp32, the trainer's own ``update``: the loss within 1e-4 of JAX's,
      each gradient no farther from the fp64 step than FP32_RATIO x JAX's
      own fp32 distance plus 1e-6, the parameters after the update equal
      optax's Adam applied to the port's gradients (3e-7)."""
    trainer = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv(tmp_path, "--device", "cpu")), log=lambda _: None)
    jargs = jtrain.parser.parse_args(_argv(tmp_path))
    random.seed(jargs.seed)
    jtrain_s, jtest_s = jtrain.load_samples(jargs, lambda _: None)
    names = lambda ss: [s["name"] for s in ss]  # noqa: E731
    assert names(trainer.train_samples) == names(jtrain_s) and names(trainer.test_samples) == names(jtest_s)
    jbuckets = jbat.BucketSet.for_samples(jtrain_s + jtest_s, n_tiers=1, multiple=8).tiers[-1]
    n_bucket = jbat.round_up(jbuckets.n_vertices, 2 ** (LEVELS - 1))
    assert (trainer.buckets.n_vertices, n_bucket) == (jbuckets.n_vertices, 152)
    jsampler = JEpochSampler(jtrain_s, 2, seed=17)
    assert [names(trainer.train_sampler.next_batch()) for _ in range(6)] == [names(jsampler.next_batch())
                                                                              for _ in range(6)]
    trainer.train_sampler = ttrain.EpochSampler(trainer.train_samples, 2, seed=17)
    samples = trainer.train_sampler.next_batch()
    batch = trainer.batch(samples)
    by_name = {s["name"]: s for s in jtrain_s}
    jb = jbat.cascade_batch([by_name[n] for n in names(samples)], LEVELS, n_bucket)
    for k in ("inputs", "targets", "mask"):
        np.testing.assert_array_equal(getattr(batch, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    for g, r in zip(batch.operator, jb.operator):
        same_operator(g, r, "ell")

    jmodel = jtrain.build_model(jargs)
    assert isinstance(jmodel, jcascade.EfficientCascade) and isinstance(trainer.model, tcascade.EfficientCascade)
    params = perturbed_params(_jit_init(jmodel, jb.operator, jnp.asarray(jb.mask), jnp.asarray(jb.inputs)), 31)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    model64 = copy.deepcopy(trainer.model).double()

    def jrun(p, dtype):
        def objective(q):
            out = jmodel.apply({"params": q}, jb.operator, jnp.asarray(jb.mask, dtype), jnp.asarray(jb.inputs, dtype))
            return jlosses.normal_cosine_loss(out, jnp.asarray(jb.mask, dtype), jnp.asarray(jb.targets, dtype))
        return jax.jit(jax.value_and_grad(objective))(p)

    def as_state(tree):
        return {k: v.double().numpy() for k, v in params_from_flax(jax.tree_util.tree_map(np.asarray, tree),
                                                                   like=trainer.model).items()}

    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jloss64, jg64 = jrun(jp64, jnp.float64)
        tx = joptim.adam(1e-3)
        upd, _ = tx.update(jg64, tx.init(jp64), jp64)
        jnew64 = as_state(optax.apply_updates(jp64, upd))
        jg64 = as_state(jg64)
    b64 = copy.copy(batch)
    b64.inputs, b64.targets, b64.mask = batch.inputs.double(), batch.targets.double(), batch.mask.double()
    loss64, _ = ttrain.train_step(model64, toptim.adam(model64.parameters(), 1e-3), b64)
    assert_close(loss64.numpy(), jloss64, FP64_RTOL, "fp64 loss")
    hold_grads({k: p.grad.numpy() for k, p in model64.named_parameters()}, jg64, FP64_RTOL, set(), "fp64 gradient")
    for k, p in model64.named_parameters():
        assert_close(p.detach().numpy(), jnew64[k], FP64_RTOL, f"fp64 after Adam {k}")

    jloss, jg = jrun(to_jax(params), jnp.float32)
    jg = as_state(jg)
    loss, mad = trainer.update(batch)
    assert trainer.step == 1 and np.isfinite(float(mad))
    assert_close(loss.numpy(), jloss, STEP_RTOL, "fp32 loss")
    tg = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()}
    tx = joptim.adam(1e-3)
    upd, _ = tx.update(to_jax(tg), tx.init(to_jax(state)), to_jax(state))
    new = optax.apply_updates(to_jax(state), upd)
    for k, p in trainer.model.named_parameters():
        g, ref = tg[k], jg64[k]
        assert np.isfinite(g).all() and (g != 0).any(), f"{k}: no gradient"
        bound = FP32_RATIO * _fro(jg[k], ref) + 1e-6
        assert _fro(g, ref) <= bound, f"fp32 grad {k}: {_fro(g, ref):.3e} from fp64 > {bound:.3e}"
        err = float(np.abs(p.detach().numpy() - np.asarray(new[k])).max())
        assert err <= ADAM_ATOL, f"{k}: after one Adam update max|err|={err:.3e}"


def test_train_normal_cascade_main_cpu(tmp_path):
    """``main`` with ``--model cas`` end to end, fp32 and ``--bf16`` (the
    device store and ``--no-device-store``): finite losses, the log's
    cascade line, a checkpoint of the cascade's parameters; ``--model cas
    --buckets 2`` exits with the JAX trainer's message."""
    for extra in ([], ["--bf16"], ["--no-device-store"]):
        out = tmp_path / f"run{len(extra)}{extra[0] if extra else ''}"
        hist = ttrain.main(["--device", "cpu", *_argv(out, "--num-updates", "2"), *extra])
        (loss, mad), = hist["train"]
        assert np.isfinite(loss) and np.isfinite(mad) and len(hist["test"]) == 1
        log = (out / "log" / "debug.log").read_text()
        assert "cascade: 3 pyramid levels of [38, 76, 152] rows, ELL at K=32" in log
        keys = torch.load(out / "pts" / "debug_normal_state.pt", weights_only=True)["params"].keys()
        assert sorted(keys) == sorted(tcascade.EfficientCascade(3, 3, cascade_levels=LEVELS).state_dict())
    with pytest.raises(SystemExit, match=r"^--buckets > 1 does not support the cascade model \(one pyramid bucket "
                                         r"chain per run\)$"):
        ttrain.main(["--device", "cpu", *_argv(tmp_path, "--buckets", "2")])
