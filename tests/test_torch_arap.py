"""The port's ARAP slice against the JAX package on the CPU: the synthetic
and ``.npy`` sequences, ``arap_batch`` (ELL, dense, Dirac), the smooth-L1
loss, the five ARAP models, the trainer on the committed
``tests/fixtures/arap`` (the pick draws, the first batch, one step in ELL,
``--dense`` and ``--model dir``), the value-keyed device store, ``main`` for
every model with and without ``--dense``, a JAX checkpoint read by the port,
and the flags the port refuses.

Tolerances, stated per case: sequences, batches and pick draws exact (the
same NumPy code and draws); the loss 1e-6 of ``max|ref|``; models and the
trainer's step in fp64 (JAX under ``enable_x64``) 1e-6 of ``max|ref|``; the
fp32 step's loss within 1e-4 of JAX's fp32 loss; a JAX checkpoint's test
loss 1e-4."""

import copy
import json
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfacenetworks_tpu.cli import train_arap as jtrain
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.cli import train_arap as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import batching as tbat
from surfacenetworks_tpu_torch.data import datasets as tdatasets
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset
from surfacenetworks_tpu_torch.models import arap_models as tmodels
from surfacenetworks_tpu_torch.train import checkpoint as tckpt
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as toptim

from torch_parity import assert_close, hold_grads, perturbed_params, rel_fro, state64, to_jax

ARAP = pathlib.Path(__file__).parent / "fixtures" / "arap"
LOSS_RTOL = 1e-6
FP64_RTOL = 1e-6
STEP_FP32_RTOL = 1e-4
CKPT_RTOL = 1e-4
ADAM_ATOL = 3e-7  # two fp32 ulps at |p| < 2: the update's arithmetic in another order
# fp32 results are held against the fp64 step, each no farther from it than
# FP32_RATIO x the JAX package's own fp32 distance, plus 1e-6 (relative
# Frobenius).  Both packages' distances are rounding noise amplified where
# batch norms cancel, and their ratio is a matter of summation order: over
# these models the port's read 0.97-5.5x JAX's (AvgModel highest), while on
# one AvgResNet2 with Gaussian inputs JAX's read 5x the port's.  A wrong
# gradient reads O(1).
FP32_RATIO = 10
PICKS = [(0, 1), (1, 1), (1, 0), (0, 0)]  # offsets above 0, across both sequences
COEFF_FIELDS = ("F", "q_fv", "vf_face", "vf_corner", "q_vf", "q_bwd_v", "q_bwd_f")
TABLES = ("faces", "q_fv", "vf_face", "q_vf", "q_bwd_v", "q_bwd_f", "ov_rows", "ov_face", "q_ov_vf", "q_ov_bwd_v")
STEP_CASES = {"ell": [], "dense": ["--dense"], "dir": ["--model", "dir"]}


def _files():
    return sorted(str(p) for p in ARAP.glob("*.npy"))


@pytest.fixture(scope="module")
def seqs():
    """The fixture's sequences as each package loads them, and each
    package's bucket over their first frames (the trainer's)."""
    t = [tdatasets.load_arap_sequence(f) for f in _files()]
    j = [jdatasets.load_arap_sequence(f) for f in _files()]
    first = lambda ss: [{"V": s[0]["V"], "F": s[0]["F"]} for s in ss]
    return t, j, tbat.Buckets.for_samples(first(t)), jbat.Buckets.for_samples(first(j))


def _same_frames(got: list, ref: list) -> None:
    assert len(got) == len(ref)
    for gs, rs in zip(got, ref):
        assert len(gs) == len(rs)
        for g, r in zip(gs, rs):
            assert sorted(g) == sorted(r)
            for k in ("V", "F"):
                assert g[k].dtype == r[k].dtype, k
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            if "L" in r:
                assert g["L"].dtype == r["L"].dtype
                np.testing.assert_array_equal(g["L"].toarray(), r["L"].toarray())
            # the coefficients a Dirac batch takes: the frame's own, else those of its float32 vertices
            gc, rc = tbat._dirac_coeffs_of(g), jbat._dirac_coeffs_of(r)
            for f in COEFF_FIELDS:
                a, b = getattr(gc, f), np.asarray(getattr(rc, f))
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("source", ["synthetic", "fixture"])
def test_arap_sequences_match_jax(source):
    """``synthetic_arap_sequences`` (40 points, 45 frames: L and the Dirac
    coefficients on the first 10) and ``load_arap_sequence`` on the
    fixture: every frame's V, F, L and Dirac coefficients equal the JAX
    package's."""
    if source == "synthetic":
        got = tdatasets.synthetic_arap_sequences(2, n_frames=45, n_points=40, seed=3)
        ref = jdatasets.synthetic_arap_sequences(2, n_frames=45, n_points=40, seed=3)
        assert all(("L" in f) == (t < 10) and ("dirac" in f) == (t < 10) for s in got for t, f in enumerate(s))
    else:
        got = [tdatasets.load_arap_sequence(f) for f in _files()]
        ref = [jdatasets.load_arap_sequence(f) for f in _files()]
    _same_frames(got, ref)


def _same_operator(got, ref, case: str) -> None:
    if case == "dense":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    elif case == "dirac":
        for f in TABLES:
            a, b = getattr(got, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    else:
        for part in ("fwd", "bwd"):
            for f in ("cols", "vals"):
                np.testing.assert_array_equal(getattr(getattr(got, part), f).numpy(),
                                              np.asarray(getattr(getattr(ref, part), f)), err_msg=f"{part}.{f}")


def _same_batch(got, ref, case: str) -> None:
    for k in ("inputs", "targets", "mask"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)
    _same_operator(got.operator, ref.operator, case)


@pytest.mark.parametrize("case", ["ell", "dense", "dirac"])
def test_arap_batch_matches_jax(case, seqs):
    """``arap_batch`` at picks with offsets above 0 across both sequences:
    inputs, targets, mask, faces and the operator equal the JAX package's
    bit for bit; the names are the picks."""
    t, j, tbk, jbk = seqs
    model, fmt = ("dirac", "ell") if case == "dirac" else ("lap", case)
    tb = tbat.arap_batch(t, PICKS, tbk, model=model, fmt=fmt)
    jb = jbat.arap_batch(j, PICKS, jbk, model=model, fmt=fmt)
    _same_batch(tb, jb, case)
    np.testing.assert_array_equal(tb.faces.numpy(), np.asarray(jb.faces))
    assert tb.names == PICKS


def test_smooth_l1_sum_matches_jax():
    """The loss and its gradient, with differences on both sides of 1 and
    exactly 0 (masked rows)."""
    rng = np.random.default_rng(5)
    out = rng.normal(scale=1.5, size=(3, 20, 12)).astype(np.float32)
    tgt = rng.normal(size=(3, 20, 12)).astype(np.float32)
    out[:, 15:] = tgt[:, 15:] = 0.0
    d = np.abs(out - tgt)
    assert (d > 1).sum() > 50 and ((d < 1) & (d > 0)).sum() > 50
    jl, jg = jax.value_and_grad(jlosses.smooth_l1_sum)(jnp.asarray(out), jnp.asarray(tgt), 3)
    x = torch.from_numpy(out).requires_grad_()
    loss = tlosses.smooth_l1_sum(x, torch.from_numpy(tgt), 3)
    loss.backward()
    assert_close(loss.detach().numpy(), jl, LOSS_RTOL, "loss")
    assert_close(x.grad.numpy(), jg, LOSS_RTOL, "gradient")


def _null_grads(model: str, layers: int) -> set:
    """Zero in exact arithmetic: in MlpModel the biases of conv1 and of each
    block's two convs add per-channel constants that a batch norm removes
    (fc0's the block's bn1; conv1's and fc1's, carried by the residuals, the
    next block's bn0 and the final one)."""
    if model != "mlp":
        return set()
    return {"conv1.fc.bias"} | {f"rn{i}.fc{k}.fc.bias" for i in range(layers) for k in (0, 1)}


@pytest.mark.parametrize("name", ["lap", "avg", "mlp", "dir", "gcn"])
def test_arap_models_match_jax(name, seqs):
    """Each ARAP model at 3 layers on two padded fixture picks (ELL, Dirac
    tables for ``dir``), flax params moved off init by seeded noise and
    converted by ``params_from_flax(like=)`` (every key and shape, strict):
    in fp64 the output, every parameter gradient and the input gradient of
    ``sum(out * w)`` within 1e-6 of ``max|ref|``; in fp32 each no farther
    (relative Frobenius) from that fp64 result than FP32_RATIO x JAX's own
    fp32 distance from it, plus 1e-6."""
    t, j, tbk, jbk = seqs
    kind = "dirac" if name == "dir" else "lap"
    picks = PICKS[:2]
    tb = tbat.arap_batch(t, picks, tbk, model=kind)
    jb = jbat.arap_batch(j, picks, jbk, model=kind, fmt="ell")
    jmod, tmod = jtrain.MODELS[name](layers=3), tmodels.MODELS[name](layers=3)
    jop = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    mask, x = np.asarray(jb.mask), np.asarray(jb.inputs)
    params = perturbed_params(jax.jit(jmod.init)(jax.random.key(0), jop, jnp.asarray(mask), jnp.asarray(x))["params"],
                              17)
    tmod.load_state_dict(params_from_flax(params, like=tmod), strict=True)
    w = np.random.default_rng(8).normal(size=(2, tbk.n_vertices, 120))

    def port(dtype):
        m = copy.deepcopy(tmod).to(dtype)
        xi = tb.inputs.to(dtype).requires_grad_()
        out = m(tb.operator, tb.mask.to(dtype), xi)
        (out.double() * torch.from_numpy(w)).sum().backward()
        return out.detach().numpy(), {k: p.grad.numpy() for k, p in m.named_parameters()}, xi.grad.numpy()

    def jax_run(dtype):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)

        def objective(q, xi):
            out = jmod.apply({"params": q}, jop, jnp.asarray(mask, dtype), xi)
            return jnp.sum(out * w), out

        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(objective, argnums=(0, 1), has_aux=True))(
            p, jnp.asarray(x, dtype))
        return np.asarray(out), state64(gp), np.asarray(gx)

    out64, g64, gx64 = port(torch.float64)
    with jax.enable_x64(True):
        jout64, jg64, jgx64 = jax_run(jnp.float64)
    assert_close(out64, jout64, FP64_RTOL, f"{name} output")
    hold_grads(g64, jg64, FP64_RTOL, _null_grads(name, 3), f"{name} fp64 gradient")
    assert_close(gx64, jgx64, FP64_RTOL, f"{name} input gradient")
    out32, g32, _ = port(torch.float32)
    jout32, jg32, _ = jax_run(jnp.float32)
    assert rel_fro(out32, out64) <= FP32_RATIO * rel_fro(jout32, out64) + 1e-6
    for k, ref in g64.items():
        if k not in _null_grads(name, 3):
            bound = FP32_RATIO * rel_fro(jg32[k], ref) + 1e-6
            assert rel_fro(g32[k], ref) <= bound, f"{name} fp32 grad {k}: {rel_fro(g32[k], ref):.3e} > {bound:.3e}"


def _argv(tmp_path, *extra):
    return ["--data-path", str(ARAP), "--layer", "2", "--batch-size", "4", "--num-epoch", "1", "--num-updates", "6",
            "--result-dir", str(tmp_path), *extra]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """``run(case)``: the JAX trainer's ``main`` over the fixture (2 layers,
    batch 4, 6 updates, its host path) once per case, with every batch's
    picks recorded in the order it draws them (its init batch, 6 train
    batches, the test batch); returns the picks and the result directory
    (log and ``.msgpack`` checkpoint)."""
    cache = {}

    def run(case):
        if case not in cache:
            out = tmp_path_factory.mktemp(f"jax_arap_{case}")
            picks, orig = [], jtrain.arap_batch

            def record(sequences, p, *args, **kwargs):
                picks.append(list(p))
                return orig(sequences, p, *args, **kwargs)

            jtrain.arap_batch = record
            saved = os.environ.get("SNX_COMPILATION_CACHE")
            os.environ["SNX_COMPILATION_CACHE"] = ""  # no persistent cache under HOME
            try:
                jtrain.main(_argv(out, "--id", "j", "--no-device-store", *STEP_CASES[case]))
            finally:
                jtrain.arap_batch = orig
                if saved is None:
                    del os.environ["SNX_COMPILATION_CACHE"]
                else:
                    os.environ["SNX_COMPILATION_CACHE"] = saved
            cache[case] = {"picks": picks, "dir": out}
        return cache[case]

    return run


def _trainer(tmp_path, *extra):
    return ttrain.ArapTrainer(ttrain.parser.parse_args(_argv(tmp_path, "--device", "cpu", *extra)), log=lambda _: None)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_arap_step_matches_jax(case, seqs, jax_runs, tmp_path):
    """The trainer on the fixture (2 layers, batch 4) in ELL, ``--dense``
    and ``--model dir``:

    * its first 6 train batches' picks and its first test batch's equal the
      JAX trainer's draws, after the draws of the JAX trainer's init batch;
    * the first batch equals the JAX package's packing;
    * fp64 (JAX under ``enable_x64``), flax params moved off init and
      converted: the loss, every gradient and the parameters after one
      coupled-L2 Adam update with the halving schedule (against optax)
      within 1e-6;
    * fp32, the trainer's own ``update``: the loss within 1e-4 of JAX's fp32
      loss, each gradient no farther from the fp64 step than FP32_RATIO x
      JAX's own fp32 distance plus 1e-6, and the parameters equal optax's update
      applied to the port's gradients (3e-7 absolute)."""
    t, j, tbk, jbk = seqs
    run = jax_runs(case)
    trainer = _trainer(tmp_path, *STEP_CASES[case])
    name = trainer.args.model
    assert trainer.fmt == ("dense" if case == "dense" else "ell") and (trainer.store is None) == (case == "dense")
    order = [trainer.sample_train_picks() for _ in range(6)]
    assert len(run["picks"]) == 8
    assert order == run["picks"][1:7]
    assert trainer.sample_test_picks() == run["picks"][7]
    batch = trainer.batch(order[0])
    kind, fmt = ("dirac", "ell") if case == "dir" else ("lap", trainer.fmt)
    jb = jbat.arap_batch(j, order[0], jbk, model=kind, fmt=fmt)
    _same_batch(batch, jb, "dirac" if case == "dir" else case)

    jmod = jtrain.MODELS[name](layers=2)
    jop = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    params = perturbed_params(
        jax.jit(jmod.init)(jax.random.key(0), jop, jnp.asarray(jb.mask), jnp.asarray(jb.inputs))["params"], 31)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    sched = (1e-3, 6, 50, 10)

    def jrun(p, dtype):
        def objective(q):
            out = jmod.apply({"params": q}, jop, jnp.asarray(jb.mask, dtype), jnp.asarray(jb.inputs, dtype))
            out = out * jnp.broadcast_to(jnp.asarray(jb.mask, dtype), out.shape)
            return jlosses.smooth_l1_sum(out, jnp.asarray(jb.targets, dtype), 4)
        return jax.jit(jax.value_and_grad(objective))(p)

    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jloss64, jg = jrun(jp64, jnp.float64)
        tx = joptim.adam(joptim.epoch_halving_schedule(*sched), weight_decay=1e-5)
        upd, _ = tx.update(jg, tx.init(jp64), jp64)
        jnew64, jg64 = state64(optax.apply_updates(jp64, upd)), state64(jg)
    model64 = copy.deepcopy(trainer.model).double()
    b64 = copy.copy(batch)
    b64.inputs, b64.targets, b64.mask = batch.inputs.double(), batch.targets.double(), batch.mask.double()
    if case == "dense":
        b64.operator = batch.operator.double()
    schedule = toptim.epoch_halving_schedule(*sched)
    loss64 = ttrain.train_step(model64, toptim.adam(model64.parameters(), schedule, weight_decay=1e-5), b64, schedule)
    assert_close(loss64.numpy(), jloss64, FP64_RTOL, "fp64 loss")
    g64 = {k: p.grad.numpy() for k, p in model64.named_parameters()}
    hold_grads(g64, jg64, FP64_RTOL, set(), "fp64 gradient")
    for k, p in model64.named_parameters():
        assert_close(p.detach().numpy(), jnew64[k], FP64_RTOL, f"fp64 after Adam {k}")

    jloss, jg32 = jrun(to_jax(params), jnp.float32)
    jg32 = state64(jg32)
    loss = trainer.update(batch)
    assert trainer.step == 1
    assert_close(loss.numpy(), jloss, STEP_FP32_RTOL, "fp32 loss")
    tg = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()}
    tx = joptim.adam(joptim.epoch_halving_schedule(*sched), weight_decay=1e-5)
    upd, _ = tx.update(to_jax(tg), tx.init(to_jax(state)), to_jax(state))
    new = optax.apply_updates(to_jax(state), upd)
    for k, p in trainer.model.named_parameters():
        g, ref = tg[k], g64[k]
        assert np.isfinite(g).all() and (g != 0).any(), f"{k}: no gradient"
        bound = FP32_RATIO * rel_fro(jg32[k], ref) + 1e-6
        assert rel_fro(g, ref) <= bound, f"fp32 grad {k}: {rel_fro(g, ref):.3e} from fp64 > {bound:.3e}"
        err = float(np.abs(p.detach().numpy() - np.asarray(new[k])).max())
        assert err <= ADAM_ATOL, f"{k}: after one Adam update max|err|={err:.3e}"


@pytest.mark.parametrize("model", ["lap", "dir"])
def test_device_store_and_host_path_give_the_same_batches(model, tmp_path):
    """The value-keyed device store's index gather and the host-stacked
    batch (``--no-device-store``, and the path over the device budget) hold
    the same tensors and operators, train and test batches alike."""
    on = _trainer(tmp_path, "--model", model)
    off = _trainer(tmp_path, "--model", model, "--no-device-store")
    assert on.store is not None and off.store is None and on.packed.value_keys
    assert DeviceDataset.build(on.all_picks, on.packed, "cpu", budget_bytes=1000) is None
    case = "dirac" if model == "dir" else "ell"
    for sample in [ttrain.ArapTrainer.sample_train_picks] * 5 + [ttrain.ArapTrainer.sample_test_picks] * 2:
        picks = sample(on)
        assert picks == sample(off)
        a, b = on.batch(picks), off.batch(picks)
        assert a.names == b.names == picks
        for k in ("inputs", "targets", "mask"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
        if case == "dirac":
            for f in TABLES + ("ov_map",):
                x, y = getattr(a.operator, f), getattr(b.operator, f)
                assert (x is None and y is None) or torch.equal(x, y), f
        else:
            for part in ("fwd", "bwd"):
                for f in ("cols", "vals"):
                    assert torch.equal(getattr(getattr(a.operator, part), f), getattr(getattr(b.operator, part), f))


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("model", ["lap", "avg", "mlp", "dir", "gcn"])
def test_train_arap_main_cpu(model, dense, tmp_path):
    """The acceptance run for each model, with and without ``--dense``: one
    epoch of 3 updates writes the JAX trainer's log lines, the metrics file
    and the port's checkpoint."""
    argv = ["--device", "cpu", "--data-path", str(ARAP), "--layer", "2", "--num-epoch", "1", "--num-updates", "3",
            "--batch-size", "4", "--model", model, "--result-dir", str(tmp_path), "--id", "a"]
    hist = ttrain.main(argv + (["--dense"] if dense else []))
    (train_loss,), (test_loss,) = hist["train"], hist["test"]
    assert np.isfinite(train_loss) and np.isfinite(test_loss)
    log = (tmp_path / "log" / "a.log").read_text()
    assert f"Train epoch 0, loss {train_loss}, " in log and f"Test epoch 0, loss {test_loss}" in log
    assert "Num parameters" in log
    records = [json.loads(x) for x in (tmp_path / "log" / "a.metrics.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["split"]) for r in records] == [(0, "train"), (0, "test")]
    ckpt = torch.load(tmp_path / "pts" / f"a_2_{model}.pt", weights_only=True)
    assert ckpt["epoch"] == 0 and ckpt["step"] == 3 and "opt_state" in ckpt


@pytest.mark.parametrize("case", ["ell", "dir"])
def test_port_reads_a_jax_arap_checkpoint(case, jax_runs, tmp_path):
    """The ``.msgpack`` a JAX ``train_arap.main`` run on the fixture wrote
    (params after 6 updates), decoded by ``load_flax_msgpack`` and converted
    by ``params_from_flax``: the port's model on the first test batch gives
    the test loss the JAX log reports, to 1e-4."""
    run = jax_runs(case)
    name = "dir" if case == "dir" else "lap"
    ckpt = tckpt.load_flax_msgpack(str(run["dir"] / "pts" / f"j_2_{name}.msgpack"))
    assert (ckpt["epoch"], ckpt["step"]) == (0, 6)
    trainer = _trainer(tmp_path, *STEP_CASES[case])
    trainer.model.load_state_dict(params_from_flax(ckpt["params"], like=trainer.model), strict=True)
    logged = (run["dir"] / "log" / "j.log").read_text()
    jloss = float(re.search(r"Test epoch 0, loss (\S+)", logged).group(1))
    loss = trainer.test_pass(0)
    assert abs(loss - jloss) <= CKPT_RTOL * abs(jloss), (loss, jloss)


@pytest.mark.parametrize("flag", [["--data-parallel", "2"], ["--graph-parallel", "2"],
                                  ["--dump-rollout", "x"], ["--config", "c.json"], ["--preset", "arap-lap"]])
def test_train_arap_refuses_unported_flags(flag, tmp_path):
    with pytest.raises(SystemExit, match="not ported yet"):
        ttrain.main(["--device", "cpu", "--data-path", str(ARAP), "--result-dir", str(tmp_path), *flag])
