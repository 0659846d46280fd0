"""``train_normal``'s ``--rotate-augment``, ``--buckets N`` and
``--additional-opt intrinsic`` in the port against the JAX package on the
CPU: JAX's uniform draws (``train.prng``) bit for bit, the rotations, the
first step with rotated inputs and targets, the key after a resume; the
size tiers (``BucketSet``), the tiered sampler's draws, the tiers' batches
and the first step on meshes of mixed sizes; and ``intrinsic``, which
changes nothing, as in the JAX trainer.

Inputs are seeded meshes and arrays handed to both packages; flax
parameters, moved off init by seeded noise, are converted by
``convert.py``.  Tolerances, as the normal zoo's
(``tests/test_torch_normal_zoo.py``), relative to ``max|ref|``: the draws,
tiers, samplers and batches exact; the rotations within 1e-6 absolute (fp32
cosines and sines of the same angles, JAX's on XLA and the port's on
PyTorch); fp64 under ``jax.enable_x64`` to 1e-6; the trainer's fp32 loss
within 1e-4 of JAX's fp32 loss, each fp32 gradient no farther (relative
Frobenius) from the fp64 step than FP32_RATIO x JAX's own fp32 distance
from it, plus 1e-6, and the parameters after one Adam update within 3e-7
of optax's update of the port's gradients."""

import copy
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu.cli import train_normal as jtrain
from surfacenetworks_tpu.cli.common import TieredSampler as JTieredSampler
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.cli import train_normal as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.train import optim as toptim
from surfacenetworks_tpu_torch.train import prng

from test_torch_normal_train import OBJS
from torch_parity import assert_close, hold_grads, perturbed_params, same_operator, to_jax

FP64_RTOL = 1e-6
STEP_RTOL = 1e-4
ADAM_ATOL = 3e-7
FP32_RATIO = 10
ROT_ATOL = 1e-6


# ---------------------------------------------------------------------------
# --rotate-augment
# ---------------------------------------------------------------------------


def _jax_rotations(seed: int, step: int, B: int):
    """The JAX trainer's ``_maybe_rotate`` rotations (its ``main`` closure
    ``_rand_rotations``, verbatim) at ``step``."""
    key = jax.random.fold_in(jax.random.key(seed), step)
    ang = jax.random.uniform(key, (B, 3), maxval=2 * np.pi)
    c, s = jnp.cos(ang), jnp.sin(ang)
    z = jnp.zeros_like(c[:, 0])
    one = jnp.ones_like(z)

    def rows(r0, r1, r2):
        return jnp.stack([jnp.stack(r0, -1), jnp.stack(r1, -1), jnp.stack(r2, -1)], -2)

    Rx = rows([one, z, z], [z, c[:, 0], -s[:, 0]], [z, s[:, 0], c[:, 0]])
    Ry = rows([c[:, 1], z, s[:, 1]], [z, one, z], [-s[:, 1], z, c[:, 1]])
    Rz = rows([c[:, 2], -s[:, 2], z], [s[:, 2], c[:, 2], z], [z, z, one])
    return np.asarray(Rz @ Ry @ Rx)


@pytest.mark.parametrize("seed", [0, 17, 2**31 - 1, -3])
def test_uniform_draws_match_jax(seed):
    """``prng.uniform(fold_in(key(seed), step), (B, 3), maxval=2 pi)``
    equals ``jax.random.uniform`` of the same key bit for bit, for steps
    past 2**16 and 2**31 and several batch sizes; other steps draw other
    angles."""
    seen = set()
    for step in (0, 1, 9, 65_537, 2**31 - 1, 2**32 - 1):
        for B in (1, 3, 8):
            ref = np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.key(seed), step), (B, 3),
                                                maxval=2 * np.pi))
            got = prng.uniform(prng.fold_in(prng.key(seed), step), (B, 3), maxval=2 * np.pi)
            assert got.dtype == ref.dtype == np.float32 and got.shape == (B, 3)
            np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32), err_msg=f"step {step} B {B}")
            assert ((0 <= got) & (got < 2 * np.pi)).all()
        seen.add(got.tobytes())
    assert len(seen) == 6
    with pytest.raises(ValueError, match="outside int32"):
        prng.key(2**31)


def test_rotations_match_jax():
    """``step_rotations`` at several seeds, steps and batch sizes: within
    ROT_ATOL of the JAX trainer's rotations, orthonormal with determinant 1
    within 1e-6."""
    for seed, step, B in ((17, 0, 2), (0, 12, 5), (3, 70_000, 1)):
        got = ttrain.step_rotations(seed, step, B, "cpu")
        assert got.dtype == torch.float32 and got.shape == (B, 3, 3)
        np.testing.assert_allclose(got.numpy(), _jax_rotations(seed, step, B), rtol=0, atol=ROT_ATOL)
        r = got.double().numpy()
        np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape), rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.linalg.det(r), 1.0, rtol=0, atol=1e-6)


def _argv(tmp_path, data, *extra):
    return ["--data-path", str(data), "--layer", "2", "--batch-size", "2", "--num-updates", "1", "--num-epoch", "1",
            "--result-dir", str(tmp_path), *extra]


def _fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _hold_first_step(trainer, jargs, jb, rot=None):
    """The trainer's first update on the port batch of ``jb`` (the JAX
    package's batch of the same samples) against the JAX trainer's
    ``train_step``, the inputs and targets rotated by ``rot(dtype)`` (JAX's
    rotations) where given: fp64 loss, gradients and Adam update to 1e-6;
    fp32 loss within 1e-4, gradients by FP32_RATIO, the update within 3e-7
    of optax's update of the port's gradients."""
    jmodel = jtrain.build_model(jargs)
    jop = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    params = perturbed_params(jax.jit(lambda k: jmodel.init(k, jop, jnp.asarray(jb.mask), jnp.asarray(jb.inputs)))(
        jax.random.key(0))["params"], 31)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    model64 = copy.deepcopy(trainer.model).double()

    def jrun(p, dtype):
        def objective(q):
            x, t = jnp.asarray(jb.inputs, dtype), jnp.asarray(jb.targets, dtype)
            if rot is not None:
                R = jnp.asarray(rot, dtype)
                x, t = jnp.einsum("bnc,bcd->bnd", x, R), jnp.einsum("bnc,bcd->bnd", t, R)
            out = jmodel.apply({"params": q}, jop, jnp.asarray(jb.mask, dtype), x)
            return jlosses.normal_cosine_loss(out, jnp.asarray(jb.mask, dtype), t)
        return jax.jit(jax.value_and_grad(objective))(p)

    def as_state(tree):
        return {k: v.double().numpy() for k, v in params_from_flax(jax.tree_util.tree_map(np.asarray, tree),
                                                                   like=trainer.model).items()}

    batch = trainer.batch(trainer.train_sampler.next_batch())
    assert batch.names == jb.names
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jloss64, jg64 = jrun(jp64, jnp.float64)
        tx = joptim.adam(1e-3)
        upd, _ = tx.update(jg64, tx.init(jp64), jp64)
        jnew64 = as_state(optax.apply_updates(jp64, upd))
        jg64 = as_state(jg64)
    b64 = copy.copy(batch)
    b64.inputs, b64.targets, b64.mask = batch.inputs.double(), batch.targets.double(), batch.mask.double()
    if isinstance(batch.operator, torch.Tensor):
        b64.operator = batch.operator.double()
    R64 = None if rot is None else torch.from_numpy(np.asarray(rot, np.float64))
    loss64, _ = ttrain.train_step(model64, toptim.adam(model64.parameters(), 1e-3), b64, rotation=R64)
    assert_close(loss64.numpy(), jloss64, FP64_RTOL, "fp64 loss")
    hold_grads({k: p.grad.numpy() for k, p in model64.named_parameters()}, jg64, FP64_RTOL, set(), "fp64 gradient")
    for k, p in model64.named_parameters():
        assert_close(p.detach().numpy(), jnew64[k], FP64_RTOL, f"fp64 after Adam {k}")

    jloss, jg = jrun(to_jax(params), jnp.float32)
    jg = as_state(jg)
    step = trainer.step
    loss, mad = trainer.update(batch)
    assert trainer.step == step + 1 and np.isfinite(float(mad))
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
    return float(loss)


def _jax_split(argv):
    jargs = jtrain.parser.parse_args(argv)
    random.seed(jargs.seed)
    train, test = jtrain.load_samples(jargs, lambda _: None)
    return jargs, train, test


def test_rotate_augment_step_matches_jax(tmp_path):
    """``--rotate-augment`` on the fixture meshes (LapDeepModel-2, batch 2,
    dense): the first update, its inputs and targets rotated by JAX's
    rotations of step 0, against the JAX trainer's step; the same step
    unrotated reads another loss; a test pass is not rotated (the same loss
    with and without the flag)."""
    argv = _argv(tmp_path, OBJS, "--rotate-augment")
    trainer = ttrain.NormalTrainer(ttrain.parser.parse_args(argv + ["--device", "cpu"]), log=lambda _: None)
    jargs, jtrain_s, jtest_s = _jax_split(argv)
    probe = copy.deepcopy(trainer.train_sampler)
    by_name = {s["name"]: s for s in jtrain_s}
    samples = [by_name[s["name"]] for s in probe.next_batch()]
    jbuckets = jbat.BucketSet.for_samples(jtrain_s + jtest_s, n_tiers=1).tiers[-1]
    jb = jbat.laplacian_batch(samples, jbuckets, fmt=trainer.fmt)
    plain = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv(tmp_path, OBJS, "--device", "cpu")), log=lambda _: None)
    rotated = _hold_first_step(trainer, jargs, jb, _jax_rotations(jargs.seed, 0, 2))
    unrotated = _hold_first_step(plain, jtrain.parser.parse_args(_argv(tmp_path, OBJS)), jb)
    assert rotated != unrotated
    plain.model.load_state_dict(trainer.model.state_dict())
    assert trainer.test_pass(0) == plain.test_pass(0)


def test_rotate_augment_key_follows_the_step(tmp_path, monkeypatch):
    """The rotations are keyed by the updates taken: a run of two updates
    draws steps 0 and 1; resumed from its checkpoint (``--deser``), the
    next updates draw steps 2 and 3 (JAX's ``TrainState.step``, restored);
    a test pass draws none."""
    drawn = []
    real = ttrain.step_rotations

    def spy(seed, step, B, device):
        drawn.append((seed, step, B))
        return real(seed, step, B, device)

    monkeypatch.setattr(ttrain, "step_rotations", spy)
    argv = ["--device", "cpu", "--data-path", str(OBJS), "--layer", "2", "--batch-size", "2", "--num-updates", "2",
            "--num-epoch", "1", "--rotate-augment", "--result-dir", str(tmp_path)]
    ttrain.main(argv)
    assert drawn == [(17, 0, 2), (17, 1, 2)]
    drawn.clear()
    ttrain.main(argv + ["--deser", str(tmp_path / "pts" / "debug_normal_state.pt")])
    assert drawn == [(17, 2, 2), (17, 3, 2)]


# ---------------------------------------------------------------------------
# --buckets N
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_meshes(tmp_path_factory):
    """Ten blob meshes of 40-220 vertices written as .obj files (two
    categories), the JAX package's generator."""
    root = tmp_path_factory.mktemp("mixed")
    for i, n in enumerate(range(40, 240, 20)):
        V, F = jdatasets.random_blob_mesh(np.random.default_rng(100 + i), n)
        (root / f"cat{i % 2}").mkdir(exist_ok=True)
        jgeo.save_obj(str(root / f"cat{i % 2}" / f"mesh_{i:02d}.obj"), V, F)
    return root


def _tier_case(tmp_path, data, extra):
    argv = _argv(tmp_path, data, "--buckets", "3", *extra)
    trainer = ttrain.NormalTrainer(ttrain.parser.parse_args(argv + ["--device", "cpu"]), log=lambda _: None)
    jargs, jtrain_s, jtest_s = _jax_split(argv)
    fmt = jargs.operator_format
    dirac = jargs.model.startswith("dirac")
    if fmt == "auto" and jargs.model == "lap":
        fmt = jbat.choose_operator_format(2, jbat.round_up(max(s["V"].shape[0] for s in jtrain_s + jtest_s), 8),
                                          rcm_ok=True)
    jset = jbat.BucketSet.for_samples(jtrain_s + jtest_s, n_tiers=3, multiple=128 if fmt == "bsr" else 8)
    return trainer, jargs, jtrain_s, jtest_s, jset, fmt, dirac


@pytest.mark.parametrize("extra", [[], ["--operator-format", "ell"], ["--model", "dirac"]])
def test_buckets_match_jax(extra, mixed_meshes, tmp_path):
    """``--buckets 3`` on ten meshes of 40-220 vertices: the tiers (every
    field) equal the JAX package's ``BucketSet``; the train sampler's and
    the test sampler's draws equal JAX's ``TieredSampler``'s name for name;
    each of the first six batches pads to its tier and equals the JAX
    trainer's batch (``bucketset.select``) field by field, the operator
    bit for bit; every tier has its own device dataset."""
    trainer, jargs, jtrain_s, jtest_s, jset, fmt, dirac = _tier_case(tmp_path, mixed_meshes, extra)
    assert len(jset.tiers) == 3
    assert [dataclasses.asdict(t) for t in trainer.bucketset.tiers] == [dataclasses.asdict(t) for t in jset.tiers]
    assert sorted(trainer.store) == [0, 1, 2]
    names = lambda ss: [s["name"] for s in ss]  # noqa: E731
    jsamp = JTieredSampler(jtrain_s, jset, 2, seed=17)
    jtest = JTieredSampler(jtest_s, jset, 2, shuffle=False)
    probe = copy.deepcopy(trainer.train_sampler)
    drawn = [names(probe.next_batch()) for _ in range(12)]
    assert drawn == [names(jsamp.next_batch()) for _ in range(12)]
    assert [names(trainer.test_sampler.next_batch()) for _ in range(4)] == [names(jtest.next_batch()) for _ in range(4)]
    by_name = {s["name"]: s for s in jtrain_s}
    tiers = set()
    for _ in range(6):
        samples = trainer.train_sampler.next_batch()
        batch = trainer.batch(samples)
        js = [by_name[n] for n in names(samples)]
        b = jset.select(js)
        tiers.add(b.n_vertices)
        jb = jbat.dirac_batch(js, b) if dirac else jbat.laplacian_batch(js, b, fmt=fmt)
        assert batch.inputs.shape[1] == b.n_vertices
        for k in ("inputs", "targets", "mask"):
            np.testing.assert_array_equal(getattr(batch, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
        same_operator(batch.operator, jb.operator, "dirac" if dirac else ("dense" if fmt == "dense" else "ell"))
    assert len(tiers) >= 2


def test_buckets_step_matches_jax(mixed_meshes, tmp_path):
    """``--buckets 3``, LapDeepModel-2, dense per tier: the first update on
    the first tiered batch against the JAX trainer's step on its batch."""
    trainer, jargs, jtrain_s, _, jset, fmt, _ = _tier_case(tmp_path, mixed_meshes, [])
    probe = copy.deepcopy(trainer.train_sampler)
    by_name = {s["name"]: s for s in jtrain_s}
    js = [by_name[s["name"]] for s in probe.next_batch()]
    _hold_first_step(trainer, jargs, jbat.laplacian_batch(js, jset.select(js), fmt=fmt))


def test_cascade_refuses_buckets_as_jax(tmp_path):
    """``--model cas --buckets 2`` exits with the JAX trainer's own
    message."""
    argv = ["--synthetic", "4", "--model", "cas", "--buckets", "2", "--debug", "--result-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as jexit:
        jtrain.main(argv)
    with pytest.raises(SystemExit) as texit:
        ttrain.main(argv + ["--device", "cpu"])
    assert str(texit.value) == str(jexit.value) and "cascade" in str(jexit.value)


# ---------------------------------------------------------------------------
# --additional-opt intrinsic
# ---------------------------------------------------------------------------


def test_additional_opt_intrinsic_changes_nothing(tmp_path):
    """``--additional-opt intrinsic``, which the JAX trainer lists and never
    reads, trains as the run without it: the same operators, first loss
    and parameters after one update, bit for bit."""
    runs = []
    for extra in ([], ["--additional-opt", "intrinsic"]):
        t = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv(tmp_path, OBJS, "--device", "cpu", *extra)),
                                 log=lambda _: None)
        batch = t.batch(t.train_sampler.next_batch())
        loss, mad = t.update(batch)
        runs.append((batch, float(loss), float(mad), t.model.state_dict()))
    (b0, l0, m0, p0), (b1, l1, m1, p1) = runs
    assert (l0, m0) == (l1, m1) and b0.names == b1.names
    assert torch.equal(b0.operator, b1.operator)
    for k, v in p0.items():
        assert torch.equal(v, p1[k]), k
