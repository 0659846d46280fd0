"""The FAUST trainer's modes on the CPU: the sl1 and cel losses through the
trainer against the JAX package's step (``test_torch_faust_trunks.
check_step``), each new trunk's ``--bf16`` step held unit by unit against
flax (``torch_parity.hold_bf16_units``), the light path against the full
path and ``--remat`` against no remat (bit for bit), ``--eval-only`` on a
checkpoint the JAX trainer wrote against the JAX trainer's ``--eval-only``
on it, the host metrics against the device's, and two repairs: the test
pass's loss is the chosen ``--loss`` (it was dcel whatever the flag), and
the streaming head, by flag or by default, is dcel's only (it also took
sl1 and cel at buckets of 4,096 vertices and more)."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.cli import train_correspondence as jtrain
from surfacenetworks_tpu.models import SiameseModel as JSiameseModel
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.cli import train_correspondence as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import datasets as tdatasets
from surfacenetworks_tpu_torch.train import losses as tlosses

from test_torch_faust_trunks import check_step, jax_pair, jops
from test_torch_bf16_train import _hold_step, _jax_loss
from torch_parity import BF16, assert_close, perturbed_params, unit_calls

FAUST = pathlib.Path(__file__).parent / "fixtures" / "faust"


def _argv(tmp_path, *flags, layers: int = 2) -> list:
    return ["--datapath", str(FAUST), "--device", "cpu", "--layer", str(layers), "--num-updates", "3",
            "--num-epoch", "1", "--smooth-reg", "0.1", "--xz-rotate", "--result-dir", str(tmp_path),
            "--deser-option", "no", *flags]


def _trainer(argv):
    return ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(argv), log=lambda _: None)


@pytest.mark.parametrize("loss", ["sl1", "cel"])
def test_loss_step_matches_jax(loss):
    """The lap trunk (3 layers) with ``--loss sl1|cel`` over the full
    logits and the pair's padded cost, aggregated in the step: fp64 to
    1e-6 (objective, gradients, one Adam update); in fp32 the objective and
    the features within 2x JAX's own distance from fp64 and the update
    optax's.  The fp32 gradients of the whole step are not bounded: on
    scan 1 the lap trunk's fp32 rounding moves them 20-60% from fp64 in
    both packages (the port's 1.3-2.3x JAX's distance over the three
    rotations, and 2.15x under the dcel head on the same trunk), so the
    losses' own fp32 gradients are held where they are computed
    (``test_torch_faust_trunks.test_corr_losses_match_jax``)."""
    check_step([], 3, loss, fp32_grads=False)


# the new trunks under --bf16: (flags, layers); amp at 3 layers reads levels 0 and 1
BF16_CASES = {"amp": (["--model", "amp"], 3), "avg": (["--model", "avg"], 2), "mlp": (["--model", "mlp"], 2),
              "dir": (["--model", "dir"], 2)}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_trunk_bf16_step_matches_jax(case, tmp_path):
    """The trainer's ``--bf16`` update (ELL, the full-logits dcel head, 0.1
    x smoothness on the bf16 features) against the JAX trainer's objective
    at ``dtype=bf16``: the loss within 8U (U = 2^-8) of JAX's, every layer
    and block held unit by unit, the parameters after the update optax's
    (``test_torch_bf16_train._hold_step``)."""
    flags, layers = BF16_CASES[case]
    trainer = _trainer(["--datapath", str(FAUST), "--device", "cpu", "--layer", str(layers), "--operator-format",
                        "ell", "--smooth-reg", "0.1", "--num-updates", "1", "--num-epoch", "1", "--bf16",
                        "--result-dir", str(tmp_path), *flags])
    batches, regs, target = jax_pair(trainer.model_key)
    regs = [jax.tree_util.tree_map(jnp.asarray, r) for r in regs]
    tgt = jnp.asarray(target)
    rots = (0.7, 0.0, 2.3, 0.0)
    xs = [jnp.asarray(np.asarray(b.inputs) @ ttrain.rot_matrix(rots[2 * i], rots[2 * i + 1], "cpu").numpy())
          for i, b in enumerate(batches)]
    ops = [jops(b) for b in batches]
    j16 = JSiameseModel(model=trainer.args.model, layers=layers, dtype=BF16)

    def obj(p):
        fa, fb = j16.apply({"params": p}, ops[0], ops[1], *xs, method=JSiameseModel.features)
        loss = jlosses.corr_delta_cross_entropy_from_target(
            jnp.einsum("bnc,bmc->bnm", fa, fb, preferred_element_type=jnp.float32)[0], tgt)
        return loss + 0.1 * (jlosses.corr_feature_smoothness(regs[0], fa) + jlosses.corr_feature_smoothness(regs[1], fb))

    params = perturbed_params(j16.init(jax.random.key(0), ops[0], ops[0], xs[0], xs[0])["params"], 15)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    jloss, _ = _jax_loss(obj, params)
    with unit_calls(trainer.model) as recorded:
        loss = trainer.update(0, 1, rots)
    assert trainer.step == 1
    _hold_step(f"FAUST {case} bf16", trainer.model, state, loss, jloss, recorded, obj, params,
               joptim.adam(1e-3, weight_decay=1e-5))


def _run(trainer) -> tuple[list, dict]:
    """An epoch of the trainer's plan: its losses and the weights after it."""
    pair_idx, rots = trainer.epoch_plan()
    losses = [trainer.update(int(a), int(b), r) for (a, b), r in zip(pair_idx, rots)]
    return losses, {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _same_run(a, b, what: str) -> None:
    (la, wa), (lb, wb) = a, b
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb)), (what, la, lb)
    assert sorted(wa) == sorted(wb) and all(torch.equal(wa[k], wb[k]) for k in wa), what


@pytest.mark.parametrize("head", ["dense", "streaming"])
def test_light_path_equals_full_path(head, tmp_path, monkeypatch):
    """``_FORCE_LIGHT``: no geodesic matrix on the device, the targets
    argmins on the host, the test pass skipped with JAX's log line; the
    targets, the losses of 3 updates and the weights after them equal the
    full path's, bit for bit."""
    argv = _argv(tmp_path, "--streaming-head" if head == "streaming" else "--no-streaming-head")
    full = _trainer(argv)
    logged = []
    monkeypatch.setattr(ttrain, "_FORCE_LIGHT", True)
    light = ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(argv), log=logged.append)
    assert light.light and not full.light and light.use_stream == full.use_stream == (head == "streaming")
    assert any(m.startswith("light fast path: geodesic matrices stay on host") for m in logged)
    for i in range(len(light.data)):
        assert "G" not in light.dev_sample(i) and "G" in full.dev_sample(i)
    for ia in range(3):
        for ib in range(3):
            t = light.pair_target(ia, ib)
            assert t.dtype == full.pair_target(ia, ib).dtype and torch.equal(t, full.pair_target(ia, ib))
    _same_run(_run(light), _run(full), "light vs full")
    assert light.test_pass(0) is None and full.test_pass(0) is not None
    assert any("per-epoch eval skipped" in m for m in logged)


@pytest.mark.parametrize("case", ["ell", "bsr", "ell bf16"])
def test_remat_is_bit_equal(case, tmp_path):
    """``--remat`` recomputes each block of the lap trunk in the backward:
    the losses of 3 updates and the weights after them equal the run
    without it, bit for bit."""
    fmt, *bf16 = case.split()
    argv = _argv(tmp_path, "--operator-format", fmt, *(["--bf16"] if bf16 else []), layers=3)
    plain, remat = _trainer(argv), _trainer(argv + ["--remat"])
    assert remat.model.trunk.remat and not plain.model.trunk.remat
    _same_run(_run(remat), _run(plain), f"remat {case}")


def _eval_line(path: pathlib.Path) -> str:
    lines = [ln for ln in path.read_text().splitlines() if "Eval-only over" in ln]
    assert len(lines) == 1, lines
    return lines[0][lines[0].index("Eval-only over"):]


def test_eval_only_matches_jax_on_its_checkpoint(tmp_path):
    """The JAX trainer trains 2 updates and writes its ``.msgpack``; the JAX
    trainer's ``--eval-only`` and the port's, both restoring it, log the
    same line over the test pair (scan 2 with itself)."""
    common = ["--datapath", str(FAUST), "--layer", "2", "--num-epoch", "1", "--num-updates", "2"]
    jtrain.main(common + ["--result-dir", str(tmp_path / "jax"), "--deser-option", "no"])
    ckpt = tmp_path / "jax" / "pts" / "test_state.msgpack"
    assert ckpt.is_file()
    jtrain.main(common + ["--result-dir", str(tmp_path / "jax_eval"), "--eval-only", "--deser-path", str(ckpt)])
    out = ttrain.main(common + ["--result-dir", str(tmp_path / "port"), "--eval-only", "--deser-path", str(ckpt),
                                "--device", "cpu"])
    want = _eval_line(tmp_path / "jax_eval" / "log" / "test.log")
    got = _eval_line(tmp_path / "port" / "log" / "test.log")
    assert re.fullmatch(r"Eval-only over 1 pairs: exact \S+ geo_mean \S+ geo_q25 \S+ geo_q50 \S+ geo_q75 \S+", got)
    assert got == want
    assert sorted(out["eval"]) == ["exact", "geo_mean", "geo_q25", "geo_q50", "geo_q75"]
    assert not (tmp_path / "port" / "pts").exists()  # no training, no checkpoint


def test_host_metrics_match_the_device_metrics():
    """``host_corr_metrics`` (numpy, ``--eval-only``) against
    ``losses.corr_metrics_from_pred`` (torch, the test pass) on the same
    padded predictions: the share of exact matches and the mean distance
    equal; the quartiles, which the host interpolates as ``np.quantile``
    does and the device takes at ``floor(p (n - 1))``, against
    ``torch.quantile`` of the same distances."""
    s = tdatasets.synthetic_correspondence_dataset(2, n_points=150, seed=4)
    N, n = 160, s[0]["V"].shape[0]
    pred = np.random.default_rng(5).integers(0, n, size=N)
    pred[:20] = s[1]["label_inv"][s[0]["label"][:20]]  # some exact matches
    host = ttrain.host_corr_metrics(pred, s[0], s[1])

    def pad(a, shape=None):
        out = np.zeros(shape or (N,) + a.shape[1:], a.dtype)
        out[tuple(slice(0, d) for d in a.shape)] = a
        return torch.from_numpy(out)

    mask = pad(np.ones(n, np.float32))
    dev = tlosses.corr_metrics_from_pred(torch.from_numpy(pred), pad(s[0]["label"]), pad(s[1]["label"]),
                                         pad(s[1]["label_inv"]), pad(s[1]["G"], (N, N)), mask)
    assert host["exact"] > 0
    assert_close(host["exact"], float(dev["exact"]), 1e-6, "exact")
    assert_close(host["geo_mean"], float(dev["geo_mean"]), 1e-6, "geo_mean")
    geo = torch.from_numpy(s[1]["G"])[torch.from_numpy(s[1]["label_inv"][s[0]["label"]]), torch.from_numpy(pred[:n])]
    for q in (25, 50, 75):
        assert_close(host[f"geo_q{q}"], float(torch.quantile(geo.double(), q / 100)), 1e-6, f"geo_q{q}")


def test_test_pass_takes_the_chosen_loss(tmp_path):
    """Repair: the full-logits head's test loss is ``--loss``'s (here sl1)
    on the pair's padded cost, as the JAX trainer's ``eval_step_fast``
    returns ``loss_fn(logits, GAB)``; it was dcel whatever the flag."""
    trainer = _trainer(_argv(tmp_path, "--loss", "sl1"))
    rots = (0.3, 0.0, 1.2, 0.0)
    loss, _ = trainer.eval_pair(2, 2, rots)
    da = trainer.dev_sample(2)
    with torch.no_grad():
        x = da["inputs"] @ ttrain.rot_matrix(rots[0], rots[1], "cpu")
        y = da["inputs"] @ ttrain.rot_matrix(rots[2], rots[3], "cpu")
        fa, fb = trainer.model.features((da["op"], da["mask"]), (da["op"], da["mask"]), x, y)
    logits = torch.einsum("bnc,bmc->bnm", fa, fb)[0]
    GAB = trainer.aggregate_padded(da, da)
    assert torch.equal(loss, tlosses.corr_smooth_l1(logits, GAB))
    assert not torch.equal(loss, tlosses.corr_delta_cross_entropy(logits, GAB))


def test_streaming_head_is_dcel_only(tmp_path):
    """Repair: ``--streaming-head`` with another loss exits as the JAX
    trainer does, and the default streaming head at buckets of 4,096
    vertices and more applies to dcel only (sl1 and cel keep the full
    logits there)."""
    with pytest.raises(SystemExit, match="supports --loss dcel only"):
        _trainer(_argv(tmp_path, "--loss", "cel", "--streaming-head"))
    data = tdatasets.synthetic_correspondence_dataset(2, n_points=4100, seed=6)
    base = ["--device", "cpu", "--layer", "1", "--operator-format", "ell", "--result-dir", str(tmp_path)]
    for loss, stream in (("dcel", True), ("sl1", False), ("cel", False)):
        t = ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(base + ["--loss", loss]), log=lambda _: None,
                                         data=data)
        assert t.N >= 4096 and t.use_stream == stream, (loss, t.use_stream)


@pytest.mark.parametrize("model", ["lap", "amp"])
def test_intrinsic_replaces_the_lap_operator(model, tmp_path):
    """``--intrinsic`` packs the intrinsic Delaunay Laplacian of each scan
    (the JAX package's, bit for bit) under the lap key only, as the JAX
    trainer does (amp keeps the extrinsic pyramid), and leaves the scans it
    was handed as they were."""
    from surfacenetworks_tpu.data import datasets as jdatasets
    from surfacenetworks_tpu.geometry import intrinsic as jintrinsic

    data = [tdatasets.load_faust_npz(str(p)) for p in sorted(FAUST.glob("*.npz"))]
    before = [s["L"].copy() for s in data]
    trainer = ttrain.CorrespondenceTrainer(
        ttrain.parser.parse_args(_argv(tmp_path, "--intrinsic", "--model", model)), log=lambda _: None, data=data)
    for s, t, L0 in zip(data, trainer.data, before):
        assert (s["L"] != L0).nnz == 0  # the caller's scans are untouched
        j = jdatasets.load_faust_npz(s["name"])
        want = jintrinsic.intrinsic_laplacian(j["V"], j["F"]) if model == "lap" else j["L"]
        got = t["L"].tocsr()
        assert (got != want).nnz == 0 and got.dtype == want.dtype, s["name"]
    assert (trainer.data[0]["L"] != before[0]).nnz > 0 if model == "lap" else "L_pyr" in trainer.data[0]


def test_auto_format_follows_the_operator_key(tmp_path):
    """``--operator-format auto`` above 2,048 vertices, as the JAX trainer
    resolves it: BSR over RCM order under the lap key, which the avg and
    mlp trunks also take though they read no operator (so their vertex
    order, and the order of their sums, is RCM's); ELL for amp and dir,
    whose operators are their own; ``bsr`` asked for outright is ELL there
    too."""
    data = tdatasets.synthetic_correspondence_dataset(2, n_points=2100, seed=7)
    base = ["--device", "cpu", "--layer", "1", "--result-dir", str(tmp_path)]
    for model, fmt, want in (("lap", "auto", "bsr"), ("avg", "auto", "bsr"), ("mlp", "auto", "bsr"),
                             ("amp", "auto", "ell"), ("dir", "auto", "ell"), ("dir", "bsr", "ell")):
        t = ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(base + ["--model", model, "--operator-format", fmt]),
                                         log=lambda _: None, data=data)
        assert t.fmt == want and ("rcm_perm" in t.data[0]) == (want == "bsr"), (model, fmt, t.fmt)
        assert t.N % (128 if want == "bsr" else 8) == 0 and t.N >= 2100
