"""The port's normal-prediction training slice against the JAX package on the
CPU: mesh I/O and the normal loaders (obj tree, ``cli.preprocess normal``
output), the cosine loss and the angle metric, the optimizers and the LR
schedule against optax, the device dataset, and the trainer on the committed
``tests/fixtures/objs`` in the ELL, BSR and dense formats (split, batch
order, first loss and the parameters after one update), end to end, resumed
from a JAX checkpoint file, and refusing the flags it does not port.

Tolerances, relative to ``max|ref|`` unless stated: loaders exact (the
same NumPy code), Laplacians to 1e-6 (scipy's products in another order);
losses 1e-6; optimizers 1e-6 (fp32, a few ulps); the whole step's are in
``test_normal_step_matches_jax``."""

import copy
import json
import pathlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu.cli import preprocess as jpreprocess
from surfacenetworks_tpu.cli import train_normal as jtrain
from surfacenetworks_tpu.cli.common import EpochSampler as JEpochSampler
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.models import normal_models as jmodels
from surfacenetworks_tpu.train import checkpoint as jckpt
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch import geometry as tgeo
from surfacenetworks_tpu_torch.cli import train_normal as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import datasets as tdatasets
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as toptim

from torch_parity import assert_close, config_flag_taken, perturbed_params, profile_flag_writes_trace, to_jax

OBJS = pathlib.Path(__file__).parent / "fixtures" / "objs"
LOSS_RTOL = 1e-6
OPT_RTOL = 1e-6
FP64_RTOL = 1e-6
STEP_RTOL = 1e-4
ADAM_ATOL = 3e-7  # two fp32 ulps at |p| < 2: the update's arithmetic in another order


def _objs():
    return sorted(str(p) for p in OBJS.rglob("*.obj"))


def test_mesh_io_matches_jax(tmp_path):
    """``load_obj`` on the fixtures; ``load_ply`` on a PLY the JAX package
    wrote (with an extra element to skip); and the port's writers read back
    by the JAX package's readers."""
    path = _objs()[3]
    V, F = tgeo.load_obj(path)
    jV, jF = jgeo.load_obj(path)
    assert V.dtype == np.float64 and F.dtype == np.int32
    np.testing.assert_array_equal(V, jV)
    np.testing.assert_array_equal(F, jF)
    ply = tmp_path / "m.ply"
    jgeo.save_ply(str(ply), V, F)
    ply.write_text(ply.read_text().replace("end_header\n", "element edge 1\nproperty int v1\nend_header\n", 1) + "7\n")
    pV, pF = tgeo.load_ply(str(ply))
    np.testing.assert_array_equal(pV, jgeo.load_ply(str(ply))[0])
    np.testing.assert_array_equal(pF, F)
    tgeo.save_obj(str(tmp_path / "o.obj"), V, F)
    tgeo.save_ply(str(tmp_path / "o.ply"), V, F)
    for reader, name in ((jgeo.load_obj, "o.obj"), (jgeo.load_ply, "o.ply")):
        rV, rF = reader(str(tmp_path / name))
        np.testing.assert_array_equal(rF, F)
        np.testing.assert_allclose(rV, V, rtol=1e-15)


def _same_sample(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    for k in ("V", "F", "input", "target"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["name"] == ref["name"]
    assert_close(got["L"].toarray(), ref["L"].toarray(), FP64_RTOL, "L")
    assert got["L"].dtype == ref["L"].dtype


@pytest.mark.parametrize("opts", [{}, {"uniform_mesh": True}, {"hack": 0.0}])
def test_load_normal_sample_matches_jax(opts, tmp_path):
    """Every fixture mesh, plain, with ``--uniform-mesh`` (the target stays
    the unscaled mesh's normals) and with ``hack0``; and a NaN mesh and an
    empty one give None in both packages."""
    for path in _objs():
        _same_sample(tdatasets.load_normal_sample(path, **opts), jdatasets.load_normal_sample(path, **opts))
    V, F = jgeo.load_obj(_objs()[0])
    V[4] = np.nan
    jgeo.save_obj(str(tmp_path / "nan.obj"), V, F)
    (tmp_path / "empty.obj").write_text("# nothing\n")
    for bad in ("nan.obj", "empty.obj"):
        assert jdatasets.load_normal_sample(str(tmp_path / bad), **opts) is None
        assert tdatasets.load_normal_sample(str(tmp_path / bad), **opts) is None


def test_scan_mesh_tree_and_npz_match_jax(tmp_path):
    """The obj tree scan, then the JAX package's ``cli.preprocess normal``
    output: the scan prefers its ``.npz`` files and ``load_normal_npz`` reads
    the same arrays and scipy operator."""
    assert tdatasets.scan_mesh_tree(str(OBJS)) == jdatasets.scan_mesh_tree(str(OBJS)) == _objs()
    out = tmp_path / "npz"
    jpreprocess.main(["normal", "--data-path", str(OBJS), "--out", str(out), "--workers", "1"])
    files = tdatasets.scan_mesh_tree(str(out))
    assert files == jdatasets.scan_mesh_tree(str(out)) and len(files) == len(_objs())
    for f in files:
        got, ref = tdatasets.load_normal_npz(f), jdatasets.load_normal_npz(f)
        _same_sample(got, ref)
        np.testing.assert_array_equal(got["L"].toarray(), ref["L"].toarray())


def _loss_inputs():
    rng = np.random.default_rng(21)
    out = rng.normal(size=(2, 40, 3)).astype(np.float32)
    out[0, 5] = 0.0  # a zero-norm row: the 1e-12 clamp
    tgt = rng.normal(size=(2, 40, 3))
    tgt = (tgt / np.linalg.norm(tgt, axis=-1, keepdims=True)).astype(np.float32)
    tgt[1, 7] = out[1, 7] / np.linalg.norm(out[1, 7])  # inner product 1: arccos at its edge
    mask = np.ones((2, 40, 1), np.float32)
    mask[0, 30:] = 0.0
    mask[1, 35:] = 0.0
    return out, mask, tgt


def test_normal_losses_match_jax():
    """The cosine loss, its gradient and the angle metric, with masked rows
    and a zero-norm prediction; the metric carries no graph.  At the
    zero-norm row JAX's gradient is NaN (``jnp.linalg.norm``'s derivative at
    0 is 0/0, and the clamp multiplies it by 0); torch's norm has derivative
    0 there, so the port's gradient is finite on that row and equals JAX's
    on every other."""
    out, mask, tgt = _loss_inputs()
    jloss, jgrad = jax.value_and_grad(jlosses.normal_cosine_loss)(jnp.asarray(out), jnp.asarray(mask), jnp.asarray(tgt))
    t = torch.from_numpy(out).requires_grad_()
    loss = tlosses.normal_cosine_loss(t, torch.from_numpy(mask), torch.from_numpy(tgt))
    loss.backward()
    assert_close(loss.detach().numpy(), jloss, LOSS_RTOL, "loss")
    jgrad, grad = np.asarray(jgrad).copy(), t.grad.numpy()
    assert np.isnan(jgrad[0, 5]).all() and np.isfinite(np.delete(jgrad.reshape(-1, 3), 5, axis=0)).all()
    assert np.isfinite(grad).all() and (grad[0, 30:] == 0).all() and (grad[1, 35:] == 0).all()
    jgrad[0, 5] = grad[0, 5]
    assert_close(grad, jgrad, LOSS_RTOL, "loss gradient off the zero-norm row")
    mad = tlosses.mean_angle_deviation(t, torch.from_numpy(mask), torch.from_numpy(tgt))
    assert not mad.requires_grad
    assert_close(mad.numpy(), jlosses.mean_angle_deviation(jnp.asarray(out), jnp.asarray(mask), jnp.asarray(tgt)),
                 LOSS_RTOL, "mad")


def _opt_case(kind):
    sched = (1e-2, 2, 1, 1)  # halving at the start of epoch 2 (step 4), then every epoch
    return {
        "adam": (joptim.adam(1e-2), lambda p: toptim.adam(p, 1e-2), None),
        "amsgrad": (joptim.adam(1e-2, amsgrad=True), lambda p: toptim.adam(p, 1e-2, amsgrad=True), None),
        "amsgrad_wd": (joptim.adam(1e-2, 1e-3, amsgrad=True), lambda p: toptim.adam(p, 1e-2, 1e-3, amsgrad=True), None),
        "sgd": (joptim.sgd(1e-2), lambda p: toptim.sgd(p, 1e-2), None),
        "adam_half_lr": (joptim.adam(joptim.epoch_halving_schedule(*sched)),
                         lambda p: toptim.adam(p, toptim.epoch_halving_schedule(*sched)),
                         toptim.epoch_halving_schedule(*sched)),
    }[kind]


def _run_port(make_opt, schedule, p0, grads):
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_opt([p])
    out = []
    for g in grads:
        p.grad = torch.from_numpy(g)
        toptim.apply_schedule(opt, schedule)
        opt.step()
        out.append(p.detach().numpy().copy())
    return out


def _grad_seq(n=7):
    """Gradients of alternating size, with a large one then zeros (where
    the two AMSGrad conventions part)."""
    rng = np.random.default_rng(22)
    gs = [rng.normal(size=(4, 5)).astype(np.float32) * s for s in (1.0, 30.0, 0.0, 0.0, 0.1, 2.0, 0.5)[:n]]
    return rng.normal(size=(4, 5)).astype(np.float32), gs


@pytest.mark.parametrize("kind", ["adam", "amsgrad", "amsgrad_wd", "sgd", "adam_half_lr"])
def test_optimizers_match_optax(kind):
    """Seven steps of each port optimizer against its optax counterpart in
    the JAX package's ``train/optim.py`` (``adam_half_lr`` crosses two
    halvings of ``epoch_halving_schedule``)."""
    tx, make_opt, schedule = _opt_case(kind)
    p0, grads = _grad_seq()
    got = _run_port(make_opt, schedule, p0, grads)
    params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for i, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
        assert_close(got[i], params, OPT_RTOL, f"{kind} step {i}")


def test_halving_schedule_matches_optax():
    for args in ((1e-3, 10, 100, 3), (1e-2, 2, 1, 1), (5e-4, 1, 0, 10)):
        j, t = joptim.epoch_halving_schedule(*args), toptim.epoch_halving_schedule(*args)
        steps = range(0, 2000, 7) if args[1] == 10 else range(60)
        assert [t(s) for s in steps] == pytest.approx([float(j(s)) for s in steps], rel=1e-7), args
    assert toptim.epoch_halving_schedule(1e-3, 10, 100, 3)(1009) == 1e-3
    assert toptim.epoch_halving_schedule(1e-3, 10, 100, 3)(1010) == 5e-4


def test_torch_amsgrad_is_not_optax_amsgrad():
    """``torch.optim.Adam(amsgrad=True)`` keeps the maximum of the raw second
    moment: after a large gradient and a zero one its step differs from
    optax's, which the port's ``Amsgrad`` matches."""
    p0 = np.ones((3,), np.float32)
    grads = [np.full(3, 10.0, np.float32), np.zeros(3, np.float32), np.zeros(3, np.float32)]
    ours = _run_port(lambda p: toptim.adam(p, 1e-2, amsgrad=True), None, p0, grads)[-1]
    theirs = _run_port(lambda p: torch.optim.Adam(p, lr=1e-2, amsgrad=True), None, p0, grads)[-1]
    tx = joptim.adam(1e-2, amsgrad=True)
    params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
    assert_close(ours, params, OPT_RTOL, "port Amsgrad vs optax")
    step_ours, step_theirs = p0 - ours, p0 - theirs
    assert np.all(step_theirs > 1.2 * step_ours), (step_ours, step_theirs)


def _argv(fmt, tmp_path, *extra):
    return ["--data-path", str(OBJS), "--layer", "2", "--batch-size", "2", "--operator-format", fmt,
            "--num-updates", "1", "--num-epoch", "1", "--result-dir", str(tmp_path), *extra]


def _jax_run(fmt, tmp_path):
    """The JAX trainer's split (its ``load_samples`` after ``random.seed``),
    rcm order and bucket for ``fmt``."""
    jargs = jtrain.parser.parse_args(_argv(fmt, tmp_path))
    random.seed(jargs.seed)
    train, test = jtrain.load_samples(jargs, lambda _: None)
    if fmt == "bsr":
        train = [jbat.rcm_reorder_sample(s) for s in train]
        test = [jbat.rcm_reorder_sample(s) for s in test]
    buckets = jbat.BucketSet.for_samples(train + test, n_tiers=1, multiple=128 if fmt == "bsr" else 8).tiers[-1]
    if fmt == "bsr":
        jbat.fit_bsr_k(train + test, buckets)
    return train, test, buckets


def _names(samples):
    return [s["name"] for s in samples]


@pytest.mark.parametrize("fmt", ["ell", "bsr", "dense"])
def test_normal_step_matches_jax(fmt, tmp_path):
    """The trainer on the fixture meshes (LapDeepModel, 2 layers, batch 2):

    * the train/test split and six batches' order (past an epoch's end)
      equal the JAX trainer's, name for name, and the first batch's inputs,
      targets, mask and operator equal the JAX package's packing;
    * fp64, both packages (JAX under ``enable_x64``; its BSR apply
      accumulates in fp32 by design, so its fp64 run applies the same
      RCM-ordered operator in ELL), with the flax params moved off init by
      seeded noise and converted in: the loss, every gradient and the
      parameters after one Adam update (against optax) agree to 1e-6;
    * fp32, the trainer's own ``update``: the loss within 1e-4 of JAX's fp32
      loss (measured at most 6.6e-6, BSR); each gradient no farther
      (relative Frobenius) from the fp64 step than 2x JAX's own fp32
      distance from it, plus 1e-6 (measured on these 70-vertex meshes at 2
      layers: the port's at most 9e-4, JAX's at most 1.7e-3: fp32 rounding
      where ``L x`` cancels, in both packages); the parameters after the
      update equal optax's Adam applied to the port's gradients (3e-7
      absolute)."""
    trainer = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv(fmt, tmp_path, "--device", "cpu")),
                                   log=lambda _: None)
    jtrain_s, jtest_s, jbuckets = _jax_run(fmt, tmp_path)
    assert trainer.fmt == fmt
    assert _names(trainer.train_samples) == _names(jtrain_s) and _names(trainer.test_samples) == _names(jtest_s)
    jsampler = JEpochSampler(jtrain_s, 2, seed=17)
    order = [trainer.train_sampler.next_batch() for _ in range(6)]
    assert [_names(b) for b in order] == [_names(jsampler.next_batch()) for _ in range(6)]
    trainer.train_sampler = ttrain.EpochSampler(trainer.train_samples, 2, seed=17)
    samples = trainer.train_sampler.next_batch()
    batch = trainer.batch(samples)
    by_name = {s["name"]: s for s in jtrain_s}
    jsamples = [by_name[n] for n in _names(samples)]
    jb = jbat.laplacian_batch(jsamples, jbuckets, fmt=fmt)
    for k in ("inputs", "targets", "mask"):
        np.testing.assert_array_equal(getattr(batch, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    if fmt == "dense":
        np.testing.assert_array_equal(batch.operator.numpy(), np.asarray(jb.operator))
    else:
        for part in ("fwd", "bwd"):
            t, j = getattr(batch.operator, part), getattr(jb.operator, part)
            fields = ("cols", "vals") if fmt == "ell" else ("block_cols", "block_vals")
            for f in fields:
                np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f"{part}.{f}")

    jmodel = jmodels.LapDeepModel(3, 3, layers=2)
    jop = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    params = perturbed_params(jmodel.init(jax.random.key(0), jop, jnp.asarray(jb.mask), jnp.asarray(jb.inputs))["params"], 31)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    model64 = copy.deepcopy(trainer.model).double()

    def jrun(p, op, dtype):
        def objective(q):
            out = jmodel.apply({"params": q}, op, jnp.asarray(jb.mask, dtype), jnp.asarray(jb.inputs, dtype))
            return jlosses.normal_cosine_loss(out, jnp.asarray(jb.mask, dtype), jnp.asarray(jb.targets, dtype))
        return jax.value_and_grad(objective)(p)

    def as_state(tree):
        return params_from_flax(jax.tree_util.tree_map(np.asarray, tree), like=trainer.model)

    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        op64 = jop
        if fmt == "bsr":
            op64 = jax.tree_util.tree_map(jnp.asarray, jbat.laplacian_batch(jsamples, jbuckets, fmt="ell").operator)
        jloss64, jg64 = jrun(jp64, op64, jnp.float64)
        tx = joptim.adam(1e-3)
        upd, _ = tx.update(jg64, tx.init(jp64), jp64)
        jnew64 = as_state(optax.apply_updates(jp64, upd))
        jg64 = as_state(jg64)
    b64 = copy.copy(batch)
    b64.inputs, b64.targets, b64.mask = batch.inputs.double(), batch.targets.double(), batch.mask.double()
    if fmt == "dense":
        b64.operator = batch.operator.double()
    loss64, _ = ttrain.train_step(model64, toptim.adam(model64.parameters(), 1e-3), b64)
    assert_close(loss64.numpy(), jloss64, FP64_RTOL, "fp64 loss")
    for k, p in model64.named_parameters():
        assert_close(p.grad.numpy(), jg64[k].numpy(), FP64_RTOL, f"fp64 grad {k}")
        assert_close(p.detach().numpy(), jnew64[k].numpy(), FP64_RTOL, f"fp64 after Adam {k}")

    jloss, jg = jrun(to_jax(params), jop, jnp.float32)
    jg = as_state(jg)
    loss, mad = trainer.update(batch)
    assert trainer.step == 1 and np.isfinite(float(mad))
    assert_close(loss.numpy(), jloss, STEP_RTOL, "fp32 loss")
    tg = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()}
    tx = joptim.adam(1e-3)
    upd, _ = tx.update(to_jax(tg), tx.init(to_jax(state)), to_jax(state))
    new = optax.apply_updates(to_jax(state), upd)
    for k, p in trainer.model.named_parameters():
        g, ref = tg[k], jg64[k].numpy()
        assert np.isfinite(g).all() and (g != 0).any(), f"{k}: no gradient"
        bound = 2 * _fro(jg[k], ref) + 1e-6
        assert _fro(g, ref) <= bound, f"fp32 grad {k}: {_fro(g, ref):.3e} from fp64 > {bound:.3e}"
        err = float(np.abs(p.detach().numpy() - np.asarray(new[k])).max())
        assert err <= ADAM_ATOL, f"{k}: after one Adam update max|err|={err:.3e}"


def _fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def test_device_dataset_and_host_path_give_the_same_batches(tmp_path):
    """The index gather of the device dataset and the host-stacked batch
    (``--no-device-store``, and the path over the device budget) hold the
    same tensors and operators."""
    on = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv("ell", tmp_path, "--device", "cpu")), log=lambda _: None)
    off = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv("ell", tmp_path, "--device", "cpu", "--no-device-store")),
                               log=lambda _: None)
    assert on.store is not None and off.store is None
    assert DeviceDataset.build(on.train_samples, on.packed, "cpu", budget_bytes=1000) is None
    for _ in range(5):
        a = on.batch(on.train_sampler.next_batch())
        b = off.batch(off.train_sampler.next_batch())
        assert a.names == b.names
        for x, y in ((a.inputs, b.inputs), (a.targets, b.targets), (a.mask, b.mask),
                     (a.operator.fwd.cols, b.operator.fwd.cols), (a.operator.fwd.vals, b.operator.fwd.vals),
                     (a.operator.bwd.cols, b.operator.bwd.cols), (a.operator.bwd.vals, b.operator.bwd.vals)):
            assert torch.equal(x, y)


def test_train_normal_main_cpu(tmp_path):
    """The acceptance run: one epoch of 3 updates on the fixtures, writing the
    JAX trainer's log and metrics files and the port's checkpoint; then
    ``--only-forward-test`` from that checkpoint writes one CSV per test
    mesh (padded rows)."""
    hist = ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--layer", "2", "--num-epoch", "1",
                        "--num-updates", "3", "--batch-size", "2", "--result-dir", str(tmp_path)])
    (train_loss, _), = hist["train"]
    assert np.isfinite(train_loss) and len(hist["test"]) == 1
    log = (tmp_path / "log" / "debug.log").read_text()
    assert "Train 0, loss" in log and "Eval 0, loss" in log and "device dataset: 10 samples" in log
    records = [json.loads(x) for x in (tmp_path / "log" / "debug.metrics.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["split"]) for r in records] == [(0, "train"), (0, "test")]
    ckpt = torch.load(tmp_path / "pts" / "debug_normal_state.pt", weights_only=True)
    assert ckpt["epoch"] == 0 and ckpt["step"] == 3 and "opt_state" in ckpt
    assert (tmp_path / "cfg" / "debug.json").is_file()
    ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--layer", "2", "--num-epoch", "1", "--batch-size", "2",
                 "--result-dir", str(tmp_path), "--deser", str(tmp_path / "pts" / "debug_normal_state.pt"),
                 "--only-forward-test", "--dump-dir", str(tmp_path / "dump"), "--result-prefix", "fwd"])
    csvs = sorted((tmp_path / "dump" / "fwd").glob("*.csv"))
    assert len(csvs) == 2 and np.loadtxt(csvs[0], delimiter=",").shape == (72, 3)


def test_train_normal_resumes_from_a_jax_checkpoint(tmp_path):
    """``--deser`` of a file the JAX package's ``save_checkpoint`` wrote
    (params and optax Adam state after 2 steps, epoch 4, step 2): the
    trainer starts at epoch 4 with those params and the optimizer loaded,
    and counts on from step 2."""
    N = 72
    jmodel = jmodels.LapDeepModel(3, 3, layers=2)
    params = to_jax(perturbed_params(jmodel.init(jax.random.key(0), jnp.zeros((1, N, N)), jnp.ones((1, N, 1)),
                                                 jnp.ones((1, N, 3)))["params"], 41))
    tx = joptim.adam(1e-3)
    state = tx.init(params)
    for _ in range(2):
        _, state = tx.update(jax.tree_util.tree_map(jnp.ones_like, params), state, params)
    path = tmp_path / "jax_normal_state.msgpack"
    jckpt.save_checkpoint(str(path), params, state, epoch=4, step=2)
    args = ttrain.parser.parse_args(["--device", "cpu", "--data-path", str(OBJS), "--layer", "2", "--batch-size", "2",
                                     "--num-epoch", "5", "--num-updates", "2", "--deser", str(path),
                                     "--result-dir", str(tmp_path)])
    logged = []
    trainer = ttrain.NormalTrainer(args, log=logged.append)
    assert "Continue..." in logged and not any("not loaded" in str(m) for m in logged)
    assert (trainer.start_epoch, trainer.step) == (4, 2)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, params), like=trainer.model)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert all(float(st["step"]) == 2 for st in trainer.opt.state.values())
    ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--layer", "2", "--batch-size", "2", "--num-epoch", "5",
                 "--num-updates", "2", "--deser", str(path), "--result-dir", str(tmp_path)])
    log = (tmp_path / "log" / "debug.log").read_text()
    assert "Train 4, loss" in log and "Train 3" not in log
    assert torch.load(tmp_path / "pts" / "debug_normal_state.pt", weights_only=True)["step"] == 4


@pytest.mark.parametrize("flag", [["--data-parallel", "2"], ["--graph-parallel", "2"], ["--config", "c"],
                                  ["--jax-profile", "x"], ["--preset", "p"], ["--multihost"]])
def test_train_normal_refuses_unported_flags(flag, tmp_path, monkeypatch):
    """``--multihost``, refused before it was ported, runs
    (``tests/test_torch_multihost.py``) and, with neither its coordinator
    flags nor torchrun's environment, exits naming them; ``--data-parallel`` and
    ``--graph-parallel``, refused before they were ported, run
    (``tests/test_torch_dist_train.py``, ``tests/test_torch_dist_gp_train.py``):
    a batch the data ranks cannot split and the Dirac model with a BSR
    format under ``--graph-parallel`` exit with the JAX trainer's
    messages.  ``--config`` and
    ``--preset``, refused before they were ported, are taken
    (``tests/test_torch_config.py`` holds each preset to the JAX package's
    resolution), and so is ``--jax-profile``, which writes a trace of the
    first epoch."""
    if flag[0] in ("--config", "--preset"):
        config_flag_taken(ttrain.parser, flag, tmp_path, ttrain.check_parallel)
        return
    if flag[0] == "--jax-profile":
        profile_flag_writes_trace(ttrain.main, ["--device", "cpu", "--data-path", str(OBJS), "--layer", "2",
                                                "--num-epoch", "2", "--num-updates", "1", "--batch-size", "2"],
                                  tmp_path)
        return
    if flag[0] == "--data-parallel":
        with pytest.raises(SystemExit, match="batch size 3 not divisible by --data-parallel 2"):
            ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--result-dir", str(tmp_path), *flag,
                         "--batch-size", "3"])
        return
    if flag[0] == "--graph-parallel":
        with pytest.raises(SystemExit, match="--graph-parallel supports ell or bsr operator formats"):
            ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--result-dir", str(tmp_path), *flag,
                         "--model", "dirac", "--operator-format", "bsr"])
        return
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="--multihost needs --coordinator-address, --num-processes and --process-id, "
                                         "or torchrun's environment"):
        ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--result-dir", str(tmp_path), *flag])
