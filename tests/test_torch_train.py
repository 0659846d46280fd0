"""The port's correspondence training slice against the JAX package on the
CPU: the smoothness term, the dense and streaming dcel, the streaming argmax
and FAUST metrics, the whole siamese step (features, objective, every
gradient, the parameters after one Adam update) on the committed FAUST
scans in both operator formats, and the trainer's ``main`` end to end.

Tolerances, relative to ``max|ref|`` unless stated: 1e-5 for the losses on
given features (fp32, another summation order); the whole step's are in
``test_siamese_step_matches_jax``."""

import copy
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.models import SiameseModel as JSiameseModel
from surfacenetworks_tpu.sparse import stack_operators as jstack_operators
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch import config
from surfacenetworks_tpu_torch.cli import train_correspondence as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as torch_optim

from torch_parity import assert_close, blob_laplacian, operators, perturbed_params, to_jax

RTOL = 1e-5
STEP_RTOL = 1e-4
FP64_RTOL = 1e-6
ADAM_ATOL = 3e-7  # two fp32 ulps at |p| < 2: the update's arithmetic in another order
FAUST = pathlib.Path(__file__).parent / "fixtures" / "faust"


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def test_corr_feature_smoothness_matches_jax():
    """Value and gradient, on a mesh pattern with padding slots and a
    padded bucket."""
    _, _, L = blob_laplacian(5, 200)
    jop, top = operators(L, 256, "ell", batch=1)
    f = np.random.default_rng(11).normal(size=(1, 256, 24)).astype(np.float32)
    jval, jgrad = jax.value_and_grad(lambda x: jlosses.corr_feature_smoothness(jop, x))(jnp.asarray(f))
    tf = _t(f, grad=True)
    tval = tlosses.corr_feature_smoothness(top, tf)
    tval.backward()
    assert_close(tval.detach().numpy(), jval, RTOL, "value")
    assert_close(tf.grad.numpy(), jgrad, RTOL, "gradient")


@pytest.mark.parametrize("head", ["dense", "streaming"])
def test_dcel_matches_jax(head):
    """dcel on full logits and the streaming dcel, value and both
    gradients, at N=700 rows (not a multiple of the 512-row tile)."""
    rng = np.random.default_rng(12)
    fa = rng.normal(size=(700, 16)).astype(np.float32)
    fb = rng.normal(size=(650, 16)).astype(np.float32)
    target = rng.integers(0, 650, size=700).astype(np.int32)
    if head == "dense":
        jfn = lambda a, b: jlosses.corr_delta_cross_entropy_from_target(a @ b.T, jnp.asarray(target))
        tfn = lambda a, b: tlosses.corr_delta_cross_entropy_from_target(a @ b.T, _t(target))
    else:
        jfn = lambda a, b: jlosses.corr_dcel_streaming(a, b, jnp.asarray(target))
        tfn = lambda a, b: tlosses.corr_dcel_streaming(a, b, _t(target))
    jval, (jga, jgb) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(fa), jnp.asarray(fb))
    ta, tb = _t(fa, grad=True), _t(fb, grad=True)
    tval = tfn(ta, tb)
    tval.backward()
    assert_close(tval.detach().numpy(), jval, RTOL, "value")
    assert_close(ta.grad.numpy(), jga, RTOL, "d fa")
    assert_close(tb.grad.numpy(), jgb, RTOL, "d fb")


def test_streaming_head_equals_dense_head_batched():
    """The batched front end: the mean of per-sample streaming losses equals
    the dense loss over all rows of equal-size samples."""
    rng = np.random.default_rng(13)
    fa, fb = (_t(rng.normal(size=(2, 600, 8)).astype(np.float32)) for _ in range(2))
    target = _t(rng.integers(0, 600, size=(2, 600)))
    dense = tlosses.corr_delta_cross_entropy_from_target(torch.einsum("bnc,bmc->bnm", fa, fb), target)
    assert_close(tlosses.corr_dcel_streaming(fa, fb, target).numpy(), dense.numpy(), RTOL)


def test_streaming_argmax_and_metrics_match_jax():
    rng = np.random.default_rng(14)
    N, n = 700, 640
    fa = rng.normal(size=(N, 8)).astype(np.float32)
    fb = rng.normal(size=(N, 8)).astype(np.float32)
    mask = (np.arange(N) < n).astype(np.float32)
    lab = np.zeros(N, np.int64)
    lab[:n] = rng.permutation(n)
    li = np.zeros(N, np.int64)
    li[lab[:n]] = np.arange(n)
    lb = np.zeros(N, np.int64)
    lb[:n] = rng.permutation(n)
    G = rng.uniform(size=(N, N)).astype(np.float32)
    jpred = jlosses.streaming_corr_argmax(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(mask))
    tpred = tlosses.streaming_corr_argmax(_t(fa), _t(fb), _t(mask))
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    assert tpred.max() < n  # padded columns never predicted
    args = (lab, lb, li, G, mask)
    jm = jlosses.corr_metrics_from_pred(jpred, *(jnp.asarray(a) for a in args))
    tm = tlosses.corr_metrics_from_pred(tpred, *(_t(a) for a in args))
    logits = fa @ fb.T
    jfull = jlosses.corr_accuracy_metrics(jnp.asarray(logits), *(jnp.asarray(a) for a in args), jnp.asarray(mask))
    tfull = tlosses.corr_accuracy_metrics(_t(logits), *(_t(a) for a in args), _t(mask))
    assert sorted(tm) == sorted(jm) == sorted(tfull)
    for k in jm:
        assert_close(float(tm[k]), float(jm[k]), RTOL, k)
        assert_close(float(tfull[k]), float(jfull[k]), RTOL, f"full logits {k}")


def _jax_pair(fmt):
    """The JAX package's trainer data for scans 0 and 1: per-shape batches,
    smoothness patterns (fixed-k ELL), and the pair's dcel target."""
    data = [jdatasets.load_faust_npz(str(p)) for p in sorted(FAUST.glob("*.npz"))]
    if fmt == "bsr":
        data = [jbat.rcm_reorder_sample(s) for s in data]
    buckets = jbat.Buckets.for_samples(data, multiple=128 if fmt == "bsr" else 8)
    if fmt == "bsr":
        jbat.fit_bsr_k([s["L"] for s in data], buckets)
    N = buckets.n_vertices
    batches = [jbat.correspondence_batch(s, buckets, fmt=fmt) for s in data[:2]]
    regs = [jstack_operators([jbat._fixed_k_operator(s["L"], buckets, N)]) for s in data[:2]]
    (GA, lA, liA), (GB, lB, liB) = (b.targets for b in batches)
    agg = np.asarray(jlosses.aggregate_G(*(jnp.asarray(a) for a in (GA, lA, liA, GB, lB, liB))))
    GAB = np.zeros((N, N), np.float32)
    GAB[: agg.shape[0], : agg.shape[1]] = agg
    GAB[:, agg.shape[1]:] = 1e9
    return batches, regs, np.argmin(GAB, axis=-1).astype(np.int32)


def _fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
@pytest.mark.parametrize("head", ["dense", "streaming"])
def test_siamese_step_matches_jax(fmt, head):
    """The whole slice on scans 0 and 1 of the committed FAUST fixtures: a
    flax SiameseModel(lap, 3 layers), its params moved off init by seeded
    noise, converted into the port's trainer.

    * fp64, both packages (JAX under ``enable_x64``; its BSR apply
      accumulates in fp32 by design, so its fp64 run applies the same
      RCM-ordered operator in ELL): features, the step-0 objective (dcel +
      0.1 x smoothness of both shapes), every gradient, and the parameters
      after one Adam update (lr 1e-3, weight decay 1e-5, against optax) agree
      to 1e-6.  This holds the algorithm: the features agree to 1e-11 and
      the gradients to 5e-8 (scan 1's operator amplifies even fp64
      rounding, below).
    * fp32, the trainer's own ``update``: the objective within 1e-4 of JAX's
      fp32 objective; the features and every gradient no farther (relative
      Frobenius) from the fp64 step than 2x JAX's own fp32 distance from it,
      plus 1e-6.  Scan 1 has |L| up to 1.9e4 where L x cancels, so fp32
      rounding moves gradients up to ~10% in both packages; the fp64 step is
      the arbiter.  The parameters after the update equal optax's Adam
      applied to the port's gradients (3e-7 absolute).
    """
    argv = ["--datapath", str(FAUST), "--device", "cpu", "--layer", "3", "--operator-format", fmt,
            "--smooth-reg", "0.1", "--lr", "1e-3", "--num-updates", "1", "--num-epoch", "1"]
    argv += ["--streaming-head"] if head == "streaming" else ["--no-streaming-head"]
    trainer = ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(argv), log=lambda _: None)
    assert trainer.use_stream == (head == "streaming")
    batches, regs, target = _jax_pair(fmt)
    np.testing.assert_array_equal(trainer.pair_target(0, 1).numpy(), target)
    da, db = trainer.dev_sample(0), trainer.dev_sample(1)
    for d, b in zip((da, db), batches):
        np.testing.assert_array_equal(d["inputs"].numpy(), b.inputs)

    rots = (0.7, 0.0, 2.3, 0.0)
    jmodel = JSiameseModel(model="lap", layers=3)
    jops32 = [(jax.tree_util.tree_map(jnp.asarray, b.operator), jnp.asarray(b.mask)) for b in batches]
    x0 = jnp.asarray(batches[0].inputs)
    params = perturbed_params(jmodel.init(jax.random.key(0), jops32[0], jops32[0], x0, x0)["params"], 15)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    model64 = copy.deepcopy(trainer.model).double()
    jregs = [jax.tree_util.tree_map(jnp.asarray, r) for r in regs]
    tgt = jnp.asarray(target)

    def jrun(p, ops, inputs, dtype):
        """JAX features, objective and gradient."""
        rm = [jnp.asarray(ttrain.rot_matrix(rots[2 * i], rots[2 * i + 1], "cpu", dtype).numpy()) for i in range(2)]
        xs = [jnp.asarray(x) @ R for x, R in zip(inputs, rm)]

        def feats(q):
            return jmodel.apply({"params": q}, ops[0], ops[1], *xs, method=JSiameseModel.features)

        def obj(q):
            fa, fb = feats(q)
            if head == "streaming":
                loss = jlosses.corr_dcel_streaming(fa[0], fb[0], tgt)
            else:
                loss = jlosses.corr_delta_cross_entropy_from_target(jnp.einsum("bnc,bmc->bnm", fa, fb)[0], tgt)
            return loss + 0.1 * (jlosses.corr_feature_smoothness(jregs[0], fa)
                                 + jlosses.corr_feature_smoothness(jregs[1], fb))

        loss, grads = jax.value_and_grad(obj)(p)
        return feats(p), loss, grads

    def as_state(tree):
        return params_from_flax(jax.tree_util.tree_map(np.asarray, tree), like=trainer.model)

    # fp64: the algorithm, exactly
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jops64 = [(jax.tree_util.tree_map(jnp.asarray, r), jnp.asarray(b.mask, jnp.float64))
                  for r, b in zip(regs, batches)] if fmt == "bsr" else jops32
        inputs64 = [np.asarray(b.inputs, np.float64) for b in batches]
        (jfa64, jfb64), jloss64, jg64 = jrun(jp64, jops64, inputs64, torch.float64)
        opt = joptim.adam(1e-3, weight_decay=1e-5)
        upd, _ = opt.update(jg64, opt.init(jp64), jp64)
        jnew64 = as_state(optax.apply_updates(jp64, upd))
        jg64 = as_state(jg64)
    d64 = [{**d, "inputs": d["inputs"].double(), "mask": d["mask"].double()} for d in (da, db)]
    with torch.no_grad():
        rm64 = [ttrain.rot_matrix(rots[2 * i], rots[2 * i + 1], "cpu", torch.float64) for i in range(2)]
        tfa64, tfb64 = model64.features(*((d["op"], d["mask"]) for d in d64), *(d["inputs"] @ R for d, R in zip(d64, rm64)))
    assert_close(tfa64.numpy(), jfa64, FP64_RTOL, "fp64 features A")
    assert_close(tfb64.numpy(), jfb64, FP64_RTOL, "fp64 features B")
    opt64 = torch_optim.adam(model64.parameters(), 1e-3, weight_decay=1e-5)
    loss64 = ttrain.train_step(model64, opt64, d64[0], d64[1], rots, trainer.pair_target(0, 1), 0.1, trainer.use_stream)
    assert_close(loss64.numpy(), jloss64, FP64_RTOL, "fp64 objective")
    for k, p in model64.named_parameters():
        assert_close(p.grad.numpy(), jg64[k].numpy(), FP64_RTOL, f"fp64 grad {k}")
        assert_close(p.detach().numpy(), jnew64[k].numpy(), FP64_RTOL, f"fp64 after Adam {k}")

    # fp32: the trainer's own step
    (jfa, jfb), jloss, jg = jrun(to_jax(params), jops32, [b.inputs for b in batches], torch.float32)
    jg = as_state(jg)
    with torch.no_grad():
        rm = [ttrain.rot_matrix(rots[2 * i], rots[2 * i + 1], "cpu") for i in range(2)]
        tfa, tfb = trainer.model.features((da["op"], da["mask"]), (db["op"], db["mask"]),
                                          da["inputs"] @ rm[0], db["inputs"] @ rm[1])
    for what, t, j, ref in (("A", tfa, jfa, tfa64), ("B", tfb, jfb, tfb64)):
        bound = 2 * _fro(j, ref) + 1e-6
        assert _fro(t, ref) <= bound, f"fp32 features {what}: {_fro(t, ref):.3e} from fp64 > {bound:.3e}"
    loss = trainer.update(0, 1, rots)
    assert_close(loss.numpy(), jloss, STEP_RTOL, "fp32 objective")
    opt = joptim.adam(1e-3, weight_decay=1e-5)
    tg = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()}
    upd, _ = opt.update(to_jax(tg), opt.init(to_jax(state)), to_jax(state))
    new = optax.apply_updates(to_jax(state), upd)
    for k, p in trainer.model.named_parameters():
        g, ref = tg[k], jg64[k].numpy()
        assert np.isfinite(g).all() and (g != 0).any(), f"{k}: no gradient"
        bound = 2 * _fro(jg[k], ref) + 1e-6
        assert _fro(g, ref) <= bound, f"fp32 grad {k}: {_fro(g, ref):.3e} from fp64 > {bound:.3e}"
        err = float(np.abs(p.detach().numpy() - np.asarray(new[k])).max())
        assert err <= ADAM_ATOL, f"{k}: after one Adam update max|err|={err:.3e}"


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_train_correspondence_main_cpu(fmt, tmp_path):
    """The trainer's entry point on the FAUST scans: two updates with the
    smoothness term, then the test pass; the losses are finite."""
    hist = ttrain.main(["--datapath", str(FAUST), "--device", "cpu", "--layer", "2", "--num-updates", "2",
                        "--num-epoch", "1", "--smooth-reg", "0.1", "--xz-rotate", "--operator-format", fmt,
                        "--result-dir", str(tmp_path)])
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])
    (test,) = hist["test"]
    assert np.isfinite(test["loss"]) and 0.0 <= test["exact"] <= 1.0 and np.isfinite(test["geo_mean"])
    assert (tmp_path / "log" / "test.log").read_text().count("Train epoch 0") == 1
    assert [r["split"] for r in map(json.loads, (tmp_path / "log" / "test.metrics.jsonl").read_text().splitlines())] == [
        "train", "test"]


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_trainer_takes_its_scans_from_code(fmt):
    """``CorrespondenceTrainer(args, data=...)`` on the scans that
    ``--synthetic`` would make builds the same run: the same bucket, inputs,
    operator and pair target, and the same first loss."""
    import dataclasses

    from surfacenetworks_tpu_torch.data import datasets as tdatasets

    argv = ["--synthetic", "3", "--synthetic-points", "120", "--device", "cpu", "--layer", "2", "--operator-format",
            fmt, "--num-updates", "1", "--num-epoch", "1"]
    flags = ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(argv), log=lambda _: None)
    code = ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(argv), log=lambda _: None,
                                        data=tdatasets.synthetic_correspondence_dataset(3, n_points=120, seed=17))
    assert code.N == flags.N and len(code.data) == len(flags.data) == 3
    a, b = code.dev_sample(0), flags.dev_sample(0)
    assert torch.equal(a["inputs"], b["inputs"]) and torch.equal(a["G"], b["G"])
    fa, fb = a["op"].fwd, b["op"].fwd
    assert all(torch.equal(getattr(fa, f.name), getattr(fb, f.name))
               for f in dataclasses.fields(fa) if isinstance(getattr(fa, f.name), torch.Tensor))
    assert torch.equal(code.pair_target(0, 1), flags.pair_target(0, 1))
    code.model.load_state_dict(flags.model.state_dict())
    rots = (0.3, 0.0, 1.1, 0.0)
    assert torch.equal(code.update(0, 1, rots), flags.update(0, 1, rots))


@pytest.mark.parametrize("flag", [["--graph-parallel", "2", "--model", "amp"], ["--multihost"],
                                  ["--config", "any.json"], ["--loss", "sl1", "past the budget"]])
def test_train_correspondence_refuses_unported_flags(flag, tmp_path, monkeypatch):
    """``--multihost``, refused before it was ported, runs
    (``tests/test_torch_multihost_faust.py``) and, with neither its
    coordinator flags nor torchrun's environment, exits naming them; ``--graph-parallel``, refused
    before it was ported, runs (``tests/test_torch_dist_gp_train.py``) and
    refuses the amp trunk with the JAX trainer's message.  ``--config`` and sl1
    (or cel) with geodesic matrices past the device budget (the budget set
    below the fixtures' 115 KB here), refused before they were ported, now
    run: the config file's values are taken, and sl1 trains through the JAX
    trainer's host path (``tests/test_torch_pipeline.py`` holds it to
    JAX's)."""
    argv = ["--datapath", str(FAUST), "--device", "cpu", "--result-dir", str(tmp_path), "--layer", "2",
            "--num-updates", "2", "--num-epoch", "1"]
    if flag[-1] == "past the budget":
        monkeypatch.setattr(ttrain, "DEVICE_BUDGET_BYTES", 1 << 10)
        logged = []
        trainer = ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(argv + flag[:-1]), log=logged.append)
        assert trainer.host_path and not trainer.light and any(m.startswith("host path") for m in logged)
        loss = trainer.train_epoch(0)
        assert np.isfinite(loss) and trainer.step == 2
        return
    if flag[0] == "--config":
        (tmp_path / flag[1]).write_text(json.dumps({"seed": 23, "loss": "cel"}))
        args = config.parse_with_config(ttrain.parser, ["--config", str(tmp_path / flag[1])])
        assert (args.seed, args.loss) == (23, "cel")
        ttrain.refuse_unported(args)
        return
    if flag[0] == "--graph-parallel":
        with pytest.raises(SystemExit, match="--graph-parallel supports the lap and dir trunks"):
            ttrain.main(argv + flag)
        return
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="--multihost needs --coordinator-address, --num-processes and --process-id, "
                                         "or torchrun's environment"):
        ttrain.main(argv + flag)


@pytest.mark.parametrize("case", ["ties", "padded_rows"])
def test_target_inverse_matches_segment_sum(case):
    """The dcel mirror's map: ``target_inverse`` lists each column's rows in
    ascending order with value 1, padded to the largest multiplicity, and
    ``ell_matmul`` over it equals ``jax.ops.segment_sum(fa, target, M)``.
    ``ties``: many rows on few columns (argmin ties); ``padded_rows``: a
    bucket's padded rows all on column 0, as the trainer's cost gives them."""
    from surfacenetworks_tpu_torch.sparse import kernels

    rng = np.random.default_rng(31)
    N, M = 300, 260
    if case == "ties":
        target = rng.integers(0, 12, size=N).astype(np.int32)
    else:
        target = rng.permutation(M)[:N - 40].astype(np.int32)
        target = np.concatenate([target, np.zeros(40, np.int32)])
    fa = rng.normal(size=(N, 24)).astype(np.float32)
    cols, vals = tlosses.target_inverse(_t(target), M)
    counts = np.bincount(target, minlength=M)
    assert cols.shape == vals.shape == (M, counts.max()) and cols.dtype == torch.int32
    for j in range(M):
        rows = np.flatnonzero(target == j)
        np.testing.assert_array_equal(cols[j, : rows.size].numpy(), rows)
        assert (vals[j, : rows.size] == 1).all() and (vals[j, rows.size :] == 0).all()
    got = kernels.ell_matmul(cols, vals, _t(fa))
    ref = jax.ops.segment_sum(jnp.asarray(fa), jnp.asarray(target), num_segments=M)
    assert_close(got.numpy(), ref, RTOL, "mirror vs segment_sum")


def test_streaming_dcel_with_cached_inverse_matches_jax():
    """The streaming dcel given the target's cached inverse, as the trainer
    passes it, against the JAX package's value and gradients (with argmin
    ties in the target)."""
    rng = np.random.default_rng(32)
    fa = rng.normal(size=(700, 16)).astype(np.float32)
    fb = rng.normal(size=(650, 16)).astype(np.float32)
    target = rng.integers(0, 90, size=700).astype(np.int32)
    jval, (jga, jgb) = jax.value_and_grad(
        lambda a, b: jlosses.corr_dcel_streaming(a, b, jnp.asarray(target)), argnums=(0, 1))(
        jnp.asarray(fa), jnp.asarray(fb))
    ta, tb = _t(fa, grad=True), _t(fb, grad=True)
    tval = tlosses.corr_dcel_streaming(ta, tb, _t(target), target_inv=tlosses.target_inverse(_t(target), 650))
    tval.backward()
    assert_close(tval.detach().numpy(), jval, RTOL, "value")
    assert_close(ta.grad.numpy(), jga, RTOL, "d fa")
    assert_close(tb.grad.numpy(), jgb, RTOL, "d fb")


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_train_step_sums_through_the_kernels(fmt, monkeypatch, tmp_path):
    """One update of the trainer (streaming head, ``--smooth-reg``) calls
    the kernel wrappers as ``chip_smoke.py``'s ``EXPECTED_PER_STEP`` counts
    them: the applies of two trunks forward and backward (4 per trunk
    apply), and ``ell_matmul`` five times besides: the two SDDMMs' ``da``
    and ``db`` and the dcel mirror.  No ``index_add_`` is left on the step."""
    from surfacenetworks_tpu_torch.sparse import kernels

    calls = {"bsr_matmul": 0, "ell_matmul": 0, "sddmm": 0}
    for name in calls:
        def counted(*args, _fn=getattr(kernels, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(kernels, name, counted)
    monkeypatch.setattr(torch.Tensor, "index_add_", lambda *a, **k: pytest.fail("index_add_ on the train step"))
    args = ttrain.parser.parse_args(["--datapath", str(FAUST), "--device", "cpu", "--layer", "2",
                                     "--num-updates", "1", "--smooth-reg", "0.1", "--streaming-head",
                                     "--operator-format", fmt, "--result-dir", str(tmp_path)])
    trainer = ttrain.CorrespondenceTrainer(args, log=lambda m: None)
    (ia, ib), rots = (int(v) for v in trainer.epoch_plan()[0][0]), [0.0] * 4
    d = trainer.dev_sample(ia)
    with torch.no_grad():
        trainer.model.trunk(d["op"], d["mask"], d["inputs"])
    applies = calls[f"{fmt}_matmul"]
    assert applies > 0
    calls.update({k: 0 for k in calls})
    trainer.update(ia, ib, rots)
    if fmt == "ell":
        assert calls == {"bsr_matmul": 0, "ell_matmul": 4 * applies + 5, "sddmm": 2}, calls
    else:
        assert calls == {"bsr_matmul": 4 * applies, "ell_matmul": 5, "sddmm": 2}, calls
