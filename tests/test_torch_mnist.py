"""The port's mesh-MNIST classifier slice against the JAX package on the CPU:
``height_field_mesh`` and ``synthetic_mnist_dataset``, the ``train_plus.np``
reader (the committed fixture, a pickle of the JAX package's
``add_operators`` with ``DiracCoeffs`` read while the JAX package cannot be
imported, and refused globals), ``mnist_batch`` (dense, ELL, Dirac) and the
device dataset, ``nll_loss`` and ``accuracy``, the four classifiers, one
update of the trainer per model on ``tests/fixtures/mnist_plus.np``, its
batch order, and ``main`` on the CPU with its refused flags.

Randomness is handed in on both sides: JAX's dropout keep mask is read from
its ``Dropout`` output (``capture_intermediates``) and given to the port.
The JAX package draws other masks under ``enable_x64`` than without it, so
each dtype's run hands its own mask on.

Tolerances, stated per case: meshes, operators, batches and batch order
exact (the same NumPy code and draws); losses 1e-6 of ``max|ref|``; models
and the step in fp64 (JAX under ``enable_x64``) 1e-6 of ``max|ref|``; in
fp32 each gradient no farther (relative Frobenius) from the port's fp64
result on the same mask than FP32_RATIO x the JAX package's own fp32
distance, plus 1e-6; the fp32 loss within 1e-4 of JAX's; the parameters
after one Adam update in fp64 within 1e-6 of JAX's wherever Adam's first
step is well conditioned (``torch_parity.hold_adam_update``), in fp32 within
3e-7 of optax's update of the port's gradients."""

import copy
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.cli.common import EpochSampler as JEpochSampler
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.geometry import sampling as jsampling
from surfacenetworks_tpu.models import mnist_models as jmodels
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu_torch import geometry as tgeo
from surfacenetworks_tpu_torch.cli import train_mnist as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import batching as tbat
from surfacenetworks_tpu_torch.data import datasets as tdatasets
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as toptim

from torch_parity import (assert_close, batch_as, config_flag_taken, hold_adam_update, hold_grads, jax_adam_step,
                          random_params, rel_fro, same_operator, same_tensors, state64, to_jax)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "mnist_plus.np"
LOSS_RTOL = 1e-6
FP64_RTOL = 1e-6
STEP_FP32_RTOL = 1e-4
ADAM_ATOL = 3e-7  # two fp32 ulps at |p| < 2: the update's arithmetic in another order
FP32_RATIO = 10  # as in tests/test_torch_arap.py: rounding noise whose ratio is a matter of summation order
LAYERS = {"lap": 2, "avg": 2, "mlp": 2, "dirac": 1}  # the JAX package's Dirac model compiles slowly on the CPU
BATCH = 4
JMODELS = {"lap": jmodels.Model, "avg": jmodels.AvgModel, "mlp": jmodels.MlpModel, "dirac": jmodels.DirModel}
COEFF_FIELDS = ("F", "q_fv", "vf_face", "vf_corner", "q_vf", "q_bwd_v", "q_bwd_f")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "surfacenetworks_tpu", "msgpack", "matplotlib")


def _same_coeffs(got, ref) -> None:
    for f in COEFF_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _same_samples(got: list, ref: list) -> None:
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k, v in r.items():
            if k in ("L", "flat_L"):
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
                np.testing.assert_array_equal(g[k].toarray(), v.toarray(), err_msg=k)
            elif k in ("dirac", "flat_dirac"):
                _same_coeffs(g[k], v)
            elif isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v and type(g[k]) is type(v), k


@pytest.mark.parametrize("seed", [0, 7])
def test_height_field_mesh_matches_jax(seed):
    """Same rng, same draws: V, F and the label equal, and the rng is left in
    the same state (the blob-placement retries consume the same draws)."""
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    for n_blobs in (1, 4):
        (tv, tf, tl), (jv, jf, jl) = tdatasets.height_field_mesh(rt, 60, n_blobs), jdatasets.height_field_mesh(
            rj, 60, n_blobs)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
        assert tf.dtype == jf.dtype and tl == jl == n_blobs
    assert rt.integers(0, 1 << 30) == rj.integers(0, 1 << 30)


@pytest.mark.parametrize("n_classes", [3, 10])
def test_synthetic_mnist_dataset_matches_jax(n_classes):
    """8 meshes of 60 points: V, F, labels, names, L, flat_L, flat_V and the
    lifted and flat Dirac coefficients equal the JAX package's."""
    got = tdatasets.synthetic_mnist_dataset(8, seed=3, n_points=60, n_classes=n_classes)
    ref = jdatasets.synthetic_mnist_dataset(8, seed=3, n_points=60, n_classes=n_classes)
    _same_samples(got, ref)
    assert len({s["label"] for s in got}) > 1


def test_load_mnist_mesh_pickle_reads_the_fixture():
    """The committed ``mnist_plus.np`` (coo operators, no Dirac
    coefficients): every field as the JAX package reads it."""
    got, ref = tdatasets.load_mnist_mesh_pickle(str(FIXTURE)), jdatasets.load_mnist_mesh_pickle(str(FIXTURE))
    assert len(got) == 8 and all(s["L"].format == "csr" for s in got)
    _same_samples(got, ref)


def _jax_preprocessed_pickle(path) -> None:
    """Three samples through the JAX package's ``add_operators`` (operators
    and ``DiracCoeffs`` of the lifted and flat meshes), pickled as the
    reference's ``train_plus.np``."""
    rng = np.random.default_rng(11)
    samples = []
    for label in (1, 2, 3):
        V, F, _ = jdatasets.height_field_mesh(rng, 50, label)
        samples.append(jsampling.add_operators({"V": V * 27.0, "F": F, "label": label}))
    arr = np.empty(len(samples), dtype=object)
    arr[:] = samples
    with open(path, "wb") as fh:
        np.save(fh, arr, allow_pickle=True)


_READ_BLOCKED = f"""
import importlib.abc, sys
BLOCKED = {BLOCKED!r}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"import of {{name}} refused")
        return None
sys.meta_path.insert(0, Refuse())
from surfacenetworks_tpu_torch import geometry
from surfacenetworks_tpu_torch.data import datasets
data = datasets.load_mnist_mesh_pickle(sys.argv[1])
assert all(isinstance(s[k], geometry.DiracCoeffs) for s in data for k in ("dirac", "flat_dirac"))
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("read", len(data))
"""


def test_load_mnist_mesh_pickle_reads_jax_dirac_samples(tmp_path):
    """A pickle holding the JAX package's ``DiracCoeffs``: read in a process
    where the JAX package cannot be imported, the coefficients become the
    port's; read here, every field equals the JAX package's reading."""
    path = tmp_path / "train_plus.np"
    _jax_preprocessed_pickle(path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _READ_BLOCKED, str(path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.split() == ["read", "3"], res.stderr[-3000:]
    got, ref = tdatasets.load_mnist_mesh_pickle(str(path)), jdatasets.load_mnist_mesh_pickle(str(path))
    assert all(isinstance(s["dirac"], tgeo.DiracCoeffs) for s in got)
    _same_samples(got, ref)


class _Evil:
    def __reduce__(self):
        return (print, ("ran",))


@pytest.mark.parametrize("payload", ["builtins.print", "jax-package function"])
def test_load_mnist_mesh_pickle_refuses_other_globals(payload, tmp_path):
    """Any global but numpy's reconstructors, scipy's sparse classes and
    ``DiracCoeffs`` is refused: a callable that would run, and a JAX-package
    name (importing it would import jax)."""
    obj = _Evil() if payload == "builtins.print" else jdatasets.height_field_mesh
    arr = np.empty(1, dtype=object)
    arr[0] = {"V": np.zeros((3, 3)), "F": np.zeros((1, 3), np.int32), "label": 0, "x": obj}
    path = tmp_path / "bad.np"
    with open(path, "wb") as fh:
        np.save(fh, arr, allow_pickle=True)
    name = "builtins.print" if payload == "builtins.print" else "surfacenetworks_tpu.data.datasets.height_field_mesh"
    with pytest.raises(pickle.UnpicklingError, match=f"refused global {name}"):
        tdatasets.load_mnist_mesh_pickle(str(path))


@pytest.fixture(scope="module")
def data():
    """The fixture as each package reads it, and each package's bucket over
    all of it (the trainers')."""
    t, j = tdatasets.load_mnist_mesh_pickle(str(FIXTURE)), jdatasets.load_mnist_mesh_pickle(str(FIXTURE))
    return t, j, tbat.Buckets.for_samples(t, multiple=8), jbat.Buckets.for_samples(j, multiple=8)


@pytest.mark.parametrize("case", ["dense", "ell", "dirac"])
def test_mnist_batch_and_device_store_match_jax(case, data):
    """``mnist_batch`` (``fmt='auto'`` resolves to dense here) of five
    samples: inputs, int32 labels, mask, faces and the operator equal the
    JAX package's bit for bit, and a device dataset of single-sample
    packings gathers the same batch."""
    t, j, tbk, jbk = data
    model, fmt = ("dirac", "ell") if case == "dirac" else ("lap", "auto" if case == "dense" else "ell")
    pick = [3, 0, 5, 5, 1]
    tb = tbat.mnist_batch([t[i] for i in pick], tbk, model=model, fmt=fmt)
    jb = jbat.mnist_batch([j[i] for i in pick], jbk, model=model, fmt=fmt)
    for k in ("inputs", "targets", "mask", "faces"):
        got, ref = getattr(tb, k).numpy(), np.asarray(getattr(jb, k))
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    same_operator(tb.operator, jb.operator, case)
    assert tb.aux is None
    store = DeviceDataset.build(t, PackedSamples(lambda s: tbat.mnist_batch([s], tbk, model=model, fmt=fmt)), "cpu")
    same_tensors(store.batch([t[i] for i in pick]).gather(), tb)


def test_nll_loss_and_accuracy_match_jax():
    """On log-softmax outputs of a batch of 16 over 10 classes with ties
    broken as argmax does: the loss and its gradient, and the accuracy."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(16, 10)).astype(np.float32)
    logits[3, 4] = logits[3, 7] = 9.0  # a tie: the first index wins in both
    labels = rng.integers(0, 10, 16).astype(np.int32)
    labels[:5] = np.argmax(logits[:5], axis=1)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    jl, jg = jax.value_and_grad(jlosses.nll_loss)(jnp.asarray(logp), jnp.asarray(labels))
    x = torch.tensor(logp, requires_grad=True)
    loss = tlosses.nll_loss(x, torch.from_numpy(labels))
    loss.backward()
    assert_close(loss.detach().numpy(), jl, LOSS_RTOL, "loss")
    assert_close(x.grad.numpy(), jg, LOSS_RTOL, "gradient")
    acc = tlosses.accuracy(x.detach(), torch.from_numpy(labels))
    assert acc.dtype == torch.float32 and float(acc) == float(jlosses.accuracy(jnp.asarray(logp), jnp.asarray(labels)))
    assert 5 / 16 <= float(acc) < 1


def _argv(tmp_path, *extra, model: str = "lap"):
    return ["--device", "cpu", "--data-path", str(FIXTURE), "--model", model, "--layer", str(LAYERS[model]),
            "--batch-size", str(BATCH), "--num-epoch", "1", "--result-dir", str(tmp_path), *extra]


def _trainer(tmp_path, *extra, model: str = "lap"):
    return ttrain.MnistTrainer(ttrain.parser.parse_args(_argv(tmp_path, *extra, model=model)), log=lambda _: None)


def _jax_first_batch(j, jbk, kind):
    """The JAX trainer's first train batch: the split, its sampler's first
    draw, ``mnist_batch`` at ``fmt='auto'``."""
    sep = max(1, int(len(j) * 0.8))
    return jbat.mnist_batch(JEpochSampler(j[:sep], BATCH, seed=17).next_batch(), jbk, model=kind)


@pytest.fixture(scope="module")
def jax_steps(data):
    """``run(model)``: the JAX package's step on its trainer's first batch
    (``model.apply`` with dropout, ``nll_loss``, ``accuracy`` and
    ``optim.adam(1e-3, weight_decay=1e-5)`` as its trainer builds them),
    with seeded params, in fp64 (under ``enable_x64``) and fp32; each run's
    loss, log-probabilities, gradients, parameters after the update and
    its dropout keep mask.  Cached per model."""
    _, j, _, jbk = data
    cache = {}

    def run(name):
        if name in cache:
            return cache[name]
        kind = "dirac" if name == "dirac" else "lap"
        jb = _jax_first_batch(j, jbk, kind)
        jmod = JMODELS[name](layers=LAYERS[name])
        op = jax.tree_util.tree_map(jnp.asarray, jb.operator)
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), jnp.asarray(jb.inputs), op,
                                                  jnp.asarray(jb.mask), deterministic=True))["params"]
        params = random_params(shapes, 5)
        out = {"params": params, "batch": jb}
        for dtype in (jnp.float64, jnp.float32):
            def objective(p):
                logp, st = jmod.apply({"params": p}, jnp.asarray(jb.inputs, dtype), op, jnp.asarray(jb.mask, dtype),
                                      deterministic=False, rngs={"dropout": jax.random.key(9)},
                                      capture_intermediates=True, mutable=["intermediates"])
                dropped = st["intermediates"]["head"]["Dropout_0"]["__call__"][0]
                return jlosses.nll_loss(logp, jnp.asarray(jb.targets)), (logp, dropped)

            def step(p):
                (loss, aux), g = jax.value_and_grad(objective, has_aux=True)(p)
                return loss, aux, g, jax_adam_step(g, p)

            with jax.enable_x64(dtype == jnp.float64):
                p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
                loss, (logp, dropped), g, new = jax.jit(step)(p)
                out[np.dtype(dtype).name] = {
                    "loss": float(loss), "logp": np.asarray(logp), "grads": state64(g), "new": state64(new),
                    "keep": np.asarray(dropped) != 0}
        cache[name] = out
        return out

    return run


def _null_grads(name: str) -> set:
    """Zero in exact arithmetic: in MlpModel each block's fc0 bias adds a
    per-channel constant that the block's bn1 removes."""
    return {f"rn{i}.fc0.fc.bias" for i in range(LAYERS[name])} if name == "mlp" else set()


def _port_run(model, batch, keep, dtype):
    """The port's log-probabilities, NLL loss and gradients on ``batch``
    with the keep mask ``keep``, in ``dtype``."""
    m = copy.deepcopy(model).to(dtype)
    b = batch_as(batch, dtype)
    logp = m(b.operator, b.mask, b.inputs, deterministic=False, keep=torch.from_numpy(keep))
    loss = tlosses.nll_loss(logp, b.targets)
    loss.backward()
    return float(loss.detach()), logp.detach().numpy(), {k: p.grad.numpy() for k, p in m.named_parameters()}


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_classifier_matches_jax(name, data, jax_steps, tmp_path):
    """Each classifier (2 layers, ``dirac`` 1) on the trainer's first fixture batch
    (dense; Dirac tables for ``dirac``) with seeded flax params converted
    by ``params_from_flax(like=)`` (every key and shape), dropout on with
    JAX's mask: in fp64 the log-probabilities and every parameter gradient
    of the NLL within 1e-6 of ``max|ref|``; in fp32 (JAX's fp32 mask) each
    gradient within FP32_RATIO x JAX's own distance of the port's fp64
    result, plus 1e-6."""
    ref = jax_steps(name)
    trainer = _trainer(tmp_path, model=name)
    trainer.model.load_state_dict(params_from_flax(ref["params"], like=trainer.model), strict=True)
    batch = trainer.batch(trainer.train_sampler.next_batch())
    r64, r32 = ref["float64"], ref["float32"]
    _, logp64, g64 = _port_run(trainer.model, batch, r64["keep"], torch.float64)
    assert_close(logp64, r64["logp"], FP64_RTOL, f"{name} log-probabilities")
    hold_grads(g64, r64["grads"], FP64_RTOL, _null_grads(name), f"{name} fp64 gradient")
    _, _, arbiter = _port_run(trainer.model, batch, r32["keep"], torch.float64)
    _, logp32, g32 = _port_run(trainer.model, batch, r32["keep"], torch.float32)
    assert_close(logp32, r32["logp"], STEP_FP32_RTOL, f"{name} fp32 log-probabilities")
    for k, a in arbiter.items():
        if k not in _null_grads(name):
            bound = FP32_RATIO * rel_fro(r32["grads"][k], a) + 1e-6
            assert rel_fro(g32[k], a) <= bound, f"{name} fp32 grad {k}: {rel_fro(g32[k], a):.3e} > {bound:.3e}"


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_mnist_step_matches_jax(name, data, jax_steps, tmp_path):
    """One update of the trainer (as above, batch 4) on the fixture for each
    model: its first batch equals the JAX trainer's; in fp64, with JAX's
    mask, the loss and the parameters after one coupled-L2 Adam update
    within 1e-6 of the JAX package's (against optax); in fp32 the trainer's
    own ``update`` with JAX's fp32 mask: the first loss within 1e-4 of
    JAX's, the parameters equal optax's update of the port's gradients
    (3e-7 absolute), and the update count 1."""
    t, j, tbk, jbk = data
    ref = jax_steps(name)
    trainer = _trainer(tmp_path, model=name)
    assert trainer.store is not None and trainer.fmt == "auto"
    batch = trainer.batch(trainer.train_sampler.next_batch())
    jb = ref["batch"]
    for k in ("inputs", "targets", "mask"):
        np.testing.assert_array_equal(getattr(batch, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    same_operator(batch.operator, jb.operator, "dirac" if name == "dirac" else "dense")
    state = params_from_flax(ref["params"], like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)

    r64 = ref["float64"]
    model64 = copy.deepcopy(trainer.model).double()
    loss64, _ = ttrain.train_step(model64, toptim.adam(model64.parameters(), 1e-3, weight_decay=1e-5),
                                  batch_as(batch, torch.float64), torch.from_numpy(r64["keep"]).double())
    assert_close(loss64.numpy(), r64["loss"], FP64_RTOL, "fp64 loss")
    hold_adam_update(model64, r64["new"], r64["grads"], state, FP64_RTOL, null=frozenset(_null_grads(name)))

    r32 = ref["float32"]
    loss, acc = trainer.update(batch, keep=torch.from_numpy(r32["keep"]).float())
    assert trainer.step == 1 and torch.equal(trainer.last_keep, torch.from_numpy(r32["keep"]).float())
    assert_close(loss.numpy(), r32["loss"], STEP_FP32_RTOL, "fp32 loss")
    assert 0.0 <= float(acc) <= 1.0
    tg = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()}
    new = jax_adam_step(to_jax(tg), to_jax(state))
    for k, p in trainer.model.named_parameters():
        err = float(np.abs(p.detach().numpy() - np.asarray(new[k])).max())
        assert err <= ADAM_ATOL, f"{k}: after one Adam update max|err|={err:.3e}"


def test_mnist_batch_order_and_dropout_draws(data, tmp_path):
    """The port's first 6 train batches are the JAX trainer's
    ``EpochSampler`` batches (by index into the train split) and its test
    batches are in order; its own keep masks are 0/1 from its generator,
    kept about half, and the same seed draws them again."""
    t, j, _, _ = data
    trainer = _trainer(tmp_path)
    sep = max(1, int(len(j) * 0.8))
    assert len(trainer.train_samples) == sep and trainer.steps_per_epoch == max(sep // BATCH, 1)
    jsampler = JEpochSampler(j[:sep], BATCH, seed=17)
    index = {id(s): i for i, s in enumerate(trainer.train_samples)}
    jindex = {id(s): i for i, s in enumerate(j[:sep])}
    for _ in range(6):
        assert [index[id(s)] for s in trainer.train_sampler.next_batch()] == [
            jindex[id(s)] for s in jsampler.next_batch()]
    tindex = {id(s): i for i, s in enumerate(trainer.test_samples)}
    assert [tindex[id(s)] for s in trainer.test_sampler.next_batch()] == [
        i % len(trainer.test_samples) for i in range(BATCH)]
    batch = trainer.batch(trainer.train_samples[:BATCH])
    trainer.update(batch)
    first = trainer.last_keep
    assert first.shape == (BATCH, 64) and set(first.unique().tolist()) <= {0.0, 1.0} and 0.3 < float(first.mean()) < 0.7
    again = _trainer(tmp_path)
    again.update(again.batch(again.train_samples[:BATCH]))
    assert torch.equal(again.last_keep, first)


@pytest.mark.parametrize("model", sorted(JMODELS))
def test_train_mnist_main_cpu(model, tmp_path):
    """The acceptance run for each model: one epoch on the fixture writes
    the JAX trainer's log lines, the metrics file and the checkpoint."""
    hist = ttrain.main(_argv(tmp_path, "--result-prefix", "m", model=model))
    ((train_loss, train_acc),), ((test_loss, test_acc),) = hist["train"], hist["test"]
    assert np.isfinite([train_loss, train_acc, test_loss, test_acc]).all()
    log = (tmp_path / "log" / "m.log").read_text()
    assert f"Train epoch 0, loss {train_loss}, acc {train_acc}" in log
    assert f"Test epoch 0, loss {test_loss}, acc {test_acc}" in log and "Num parameters" in log
    records = [json.loads(x) for x in (tmp_path / "log" / "m.metrics.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["split"]) for r in records] == [(0, "train"), (0, "test")]
    assert records[0]["acc"] == train_acc
    ckpt = torch.load(tmp_path / "pts" / "m.pt", weights_only=True)
    assert ckpt["epoch"] == 0 and ckpt["step"] == 1 and "opt_state" in ckpt


@pytest.mark.parametrize("flag", [["--data-parallel", "2"], ["--graph-parallel", "2", "--model", "avg"],
                                  ["--config", "c.json"], ["--preset", "mnist"]])
def test_train_mnist_refuses_unported_flags(flag, tmp_path):
    """``--data-parallel`` and ``--graph-parallel``, refused before they were
    ported, run (``tests/test_torch_dist_train.py``,
    ``tests/test_torch_dist_gp_mesh.py``) and refuse what the JAX trainer
    refuses with its messages: a batch the data ranks cannot split, a
    graph-parallel model other than lap or dirac; ``--config`` and
    ``--preset``, refused before they were ported, are taken
    (``tests/test_torch_config.py`` holds each preset to the JAX package's
    resolution)."""
    if flag[0] in ("--config", "--preset"):
        config_flag_taken(ttrain.parser, flag, tmp_path, lambda a: ttrain.refuse_unported(a, "train_mnist"))
        return
    if flag[0] == "--data-parallel":
        with pytest.raises(SystemExit, match="batch size 3 not divisible by --data-parallel 2"):
            ttrain.main(_argv(tmp_path, *flag, "--batch-size", "3"))
        return
    with pytest.raises(SystemExit, match="--graph-parallel supports the lap and dirac models"):
        ttrain.main(_argv(tmp_path, *flag))


def test_train_mnist_needs_a_card_unless_told(monkeypatch, tmp_path):
    """Without ``--device cpu`` it runs on ``cuda`` and raises with no card;
    without data it exits as the VAE trainer does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(argv)
    with pytest.raises(SystemExit, match="--synthetic N or --data-path"):
        ttrain.main(["--device", "cpu", "--result-dir", str(tmp_path)])
