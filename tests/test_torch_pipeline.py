"""The port's host input pipeline on the CPU: ``prefetch`` and
``prefetch_over`` (as ``tests/test_pipeline.py`` holds the JAX package's),
``OperatorCache`` against the JAX package's on the same owners, the pack
cache's pass-through past its budget, the metric accumulator and fetcher,
the host route of the normal, ARAP, mesh-MNIST and VAE trainers against
their device-store route (bit for bit), and FAUST sl1 and cel past the
device budget, the JAX trainer's host path: the pair's padded cost against
JAX's ``aggregate_G`` and padding (0 ulp), the first update against the JAX
trainer's host path (which JAX takes on one device when it counts more than
one process), and its two exits.

Tolerances of the first update (the fast path's, ``tests/test_torch_train.py``):
the loss and the test pass within 1e-4 of JAX's (fp32 trunks, sums in
another order); the parameters after one Adam update within 3e-7 (two fp32
ulps) of JAX's where both packages' steps are lr, to 5e-5 of it, in one
direction.  Adam's first step moves a parameter by lr times ``g / (|g| +
eps)``, so that is where |g| > 2e-4 in both; it must cover 70% of the
parameters (71.5% under sl1, whose gradients are small; 99.2% under cel).
The rest are held within 2 lr only: this trunk's fp32 gradients on scan 1
lie 20-60% from fp64 in both packages (``test_torch_faust_modes.
test_loss_step_matches_jax``), which moves a step of a small gradient by up
to its whole size."""

import json
import pathlib
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.cli import train_correspondence as jtrain
from surfacenetworks_tpu.data import OperatorCache as JOperatorCache
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu_torch.cli import common as tcommon
from surfacenetworks_tpu_torch.cli import train_arap, train_correspondence as ttrain, train_mnist, train_normal, train_vae
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import pipeline
from surfacenetworks_tpu_torch.train import checkpoint as tckpt

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
FAUST = FIXTURES / "faust"
STEP_RTOL = 1e-4
ADAM_ATOL = 3e-7
LR = 1e-3
SAT = 5e-5
SATURATED_SHARE = 0.7  # of the parameters: 0.715 under sl1 (its gradients are small), 0.992 under cel


def test_prefetch_order_and_overlap():
    produced = []

    def make(i):
        produced.append(i)
        time.sleep(0.01)
        return i * i

    assert list(pipeline.prefetch(make, 10, depth=2)) == [i * i for i in range(10)]
    assert produced == list(range(10))


def test_prefetch_propagates_worker_exception():
    def make(i):
        if i == 3:
            raise ValueError("boom at 3")
        return i

    got = []
    with pytest.raises(ValueError, match="boom at 3"):
        for x in pipeline.prefetch(make, 10, depth=2):
            got.append(x)
    assert got == [0, 1, 2]


def test_prefetch_early_exit_unblocks_worker():
    started = threading.active_count()
    for _ in pipeline.prefetch(lambda i: np.zeros(1024), 1000, depth=2):
        break  # the consumer stops at once; the worker must not block on the full queue
    deadline = time.time() + 5.0
    while threading.active_count() > started and time.time() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= started


def test_prefetch_over_draws_on_the_worker_thread():
    class Sampler:
        def __init__(self):
            self.n, self.threads = 0, set()

        def next_batch(self):
            self.n += 1
            self.threads.add(threading.current_thread().name)
            return [self.n]

    s = Sampler()
    assert list(pipeline.prefetch_over(s, lambda batch: batch[0] * 10, 4)) == [10, 20, 30, 40]
    assert s.n == 4 and s.threads == {"snx-prefetch"}


@pytest.mark.parametrize("case", ["hits", "invalidation", "budget"])
def test_operator_cache_matches_jax(case):
    """The same calls on the port's cache and the JAX package's (values of
    the same bytes: a tensor and an array): the same values back, hits,
    misses, bytes, ``stats()`` lines and warnings; past the budget both
    pass through and warn once."""
    owners = [np.arange(5) + i for i in range(3)]
    budget = 2 * 4000 if case == "budget" else 8 << 30
    caches = {"port": pipeline.OperatorCache(budget), "jax": JOperatorCache(budget)}
    made = {name: [] for name in caches}

    def calls(name):
        cache = caches[name]

        def build(i):
            def make():
                made[name].append(i)
                return torch.full((1000,), float(i)) if name == "port" else np.full(1000, float(i), np.float32)
            return make

        seq = list(owners)
        if case == "invalidation":
            seq = seq + [owners[0], np.array(owners[1])] + seq  # a fresh object for owner 1's value
        elif case != "budget":
            seq = seq + seq
        else:
            seq = seq + seq + seq
        got = [float(np.asarray(cache.get((o,), ("k",), build(int(o[0])))).sum()) for o in seq]
        return got

    with warnings.catch_warnings(record=True) as wport:
        warnings.simplefilter("always")
        got_port = calls("port")
    with warnings.catch_warnings(record=True) as wjax:
        warnings.simplefilter("always")
        got_jax = calls("jax")
    assert got_port == got_jax
    assert made["port"] == made["jax"]
    p, j = caches["port"], caches["jax"]
    assert (p.hits, p.misses, p.bytes) == (j.hits, j.misses, j.bytes)
    assert p.stats() == j.stats()
    assert [str(w.message) for w in wport] == [str(w.message) for w in wjax]
    assert len(wport) == (1 if case == "budget" else 0)


def test_packed_samples_pass_through_past_the_budget():
    """A pack cache over its budget repacks each sample at each use, warns
    once and holds no pack; the batches are the cached ones' bits."""
    from surfacenetworks_tpu_torch.data import Buckets, datasets, laplacian_batch

    samples = datasets.synthetic_normal_dataset(3, n_points=120, seed=0)
    buckets = Buckets.for_samples(samples)
    builds = []

    def build(s):
        builds.append(id(s))
        return laplacian_batch([s], buckets)

    kept, passing = pipeline.PackedSamples(build), pipeline.PackedSamples(build, budget_bytes=0)
    ref = kept.batch(samples)
    kept.batch(samples)
    assert len(builds) == 3 and kept.cache.hits == 3
    with pytest.warns(UserWarning, match="OperatorCache budget"):
        got = passing.batch(samples)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no second warning
        passing.batch(samples)
    assert len(builds) == 9 and passing.cache.bytes == 0 and passing.cache.hits == 0
    assert torch.equal(got.inputs, ref.inputs) and torch.equal(got.operator.fwd.vals, ref.operator.fwd.vals)


def test_metric_accumulator_and_fetcher():
    """Device sums in step order, fetched once; the fetcher one step late."""
    acc = pipeline.MetricAccumulator(max_inflight=2)
    vals = [torch.tensor(v) for v in (0.1, 0.2, 0.3, 0.4)]
    ref = torch.zeros(())
    for v in vals:
        acc.add(v, 2 * v)
        ref = ref + v
    assert acc.sums() == (float(ref), float(2 * ref)) and acc.n == 4
    assert acc.means() == (float(ref) / 4, float(2 * ref) / 4)
    fetch = tcommon.MetricFetcher()
    assert fetch.push(vals[0]) is None
    assert fetch.push(vals[1]) == (float(vals[0]),)
    assert fetch.flush() == (float(vals[1]),) and fetch.flush() is None


def _recorded(trainer, kw=None):
    """Wrap ``trainer.update`` to record each update's outputs."""
    seen = []
    update = trainer.update

    def rec(batch, *a, **k):
        out = update(batch, *a, **k)
        seen.append(torch.stack(list(out) if isinstance(out, tuple) else [out]).clone())
        return out

    trainer.update = rec
    return seen


def _normal(tmp_path, store):
    argv = ["--device", "cpu", "--data-path", str(FIXTURES / "objs"), "--layer", "2", "--batch-size", "2",
            "--num-updates", "3", "--num-epoch", "1", "--result-dir", str(tmp_path)]
    return train_normal.NormalTrainer(train_normal.parser.parse_args(argv + ([] if store else ["--no-device-store"])),
                                      log=lambda _: None)


def _arap(tmp_path, store):
    argv = ["--device", "cpu", "--data-path", str(FIXTURES / "arap"), "--layer", "2", "--batch-size", "4",
            "--num-epoch", "1", "--num-updates", "3", "--result-dir", str(tmp_path)]
    return train_arap.ArapTrainer(train_arap.parser.parse_args(argv + ([] if store else ["--no-device-store"])),
                                  log=lambda _: None)


def _mnist(tmp_path, store, monkeypatch):
    argv = ["--device", "cpu", "--data-path", str(FIXTURES / "mnist_plus.np"), "--layer", "2", "--batch-size", "2",
            "--num-epoch", "1", "--result-dir", str(tmp_path)]
    if not store:  # the classifier has no flag for it: its host route is taken past the device budget
        monkeypatch.setattr(train_mnist.DeviceDataset, "build", classmethod(lambda cls, *a, **k: None))
    return train_mnist.MnistTrainer(train_mnist.parser.parse_args(argv), log=lambda _: None)


def _vae(tmp_path, store):
    argv = ["--device", "cpu", "--data-path", str(FIXTURES / "mnist_plus.np"), "--num-layers", "2", "--batch-size",
            "2", "--num-epoch", "1", "--result-dir", str(tmp_path)]
    return train_vae.VaeTrainer(train_vae.parser.parse_args(argv + ([] if store else ["--no-device-store"])),
                                log=lambda _: None)


@pytest.mark.parametrize("name", ["normal", "arap", "mnist", "vae"])
def test_host_route_equals_store_route(name, tmp_path, monkeypatch):
    """The host route (batches built on the prefetch thread, the draws
    there too) and the device-store route: the same draws, so every
    update's losses and the epoch's means bit for bit."""
    runs = {}
    for store in (True, False):
        if name == "normal":
            trainer = _normal(tmp_path / str(store), store)
        elif name == "arap":
            trainer = _arap(tmp_path / str(store), store)
        elif name == "mnist":
            with monkeypatch.context() as m:
                trainer = _mnist(tmp_path / str(store), store, m)
        else:
            trainer = _vae(tmp_path / str(store), store)
        assert (trainer.store is None) == (not store)
        seen = _recorded(trainer)
        means = trainer.train_epoch(0)
        runs[store] = (torch.stack(seen), means)
    assert len(runs[True][0]) >= 2
    assert torch.equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]


def test_pair_cost_matches_jax():
    """Every ordered pair of the FAUST fixtures: the host path's padded
    ``[N, N]`` cost against JAX's ``aggregate_G`` padded as its
    ``assemble_pair`` pads it, to 0 ulp."""
    trainer = ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(
        ["--datapath", str(FAUST), "--device", "cpu", "--layer", "2", "--loss", "sl1"]), log=lambda _: None)
    N = trainer.N
    data = [jdatasets.load_faust_npz(str(p)) for p in sorted(FAUST.glob("*.npz"))]
    for ia in range(len(data)):
        for ib in range(len(data)):
            sa, sb = data[ia], data[ib]
            real = jlosses.aggregate_G(*(jnp.asarray(a) for a in (sa["G"], sa["label"], sa["label_inv"], sb["G"],
                                                                    sb["label"], sb["label_inv"])))
            ref = jnp.zeros((N, N), jnp.float32).at[: real.shape[0], : real.shape[1]].set(real)
            ref = np.asarray(ref.at[:, real.shape[1]:].set(1e9))
            got = trainer.assemble_pair(ia, ib)["GAB"].numpy()
            assert got.dtype == ref.dtype and np.array_equal(got, ref), (ia, ib)


@pytest.fixture(scope="module")
def start_checkpoint(tmp_path_factory):
    """Parameters both trainers resume from, with no optimizer state (so
    the update is Adam's first): the JAX trainer's fast path after one dcel
    update (layer 2), moved off its initial values."""
    from surfacenetworks_tpu.train import checkpoint as jckpt

    d = tmp_path_factory.mktemp("start")
    jtrain.main(["--datapath", str(FAUST), "--layer", "2", "--num-updates", "1", "--num-epoch", "1",
                 "--result-dir", str(d), "--deser-option", "no"])
    path = d / "params_only.msgpack"
    jckpt.save_checkpoint(str(path), jckpt.load_checkpoint(str(d / "pts" / "test_state.msgpack"))["params"])
    return path


def _flags(loss, result_dir, ckpt):
    return ["--datapath", str(FAUST), "--layer", "2", "--num-updates", "1", "--num-epoch", "1", "--xz-rotate",
            "--loss", loss, "--result-dir", str(result_dir), "--deser-path", str(ckpt)]


@pytest.mark.parametrize("loss", ["sl1", "cel"])
def test_host_path_first_update_matches_jax(loss, start_checkpoint, tmp_path, monkeypatch):
    """``--loss sl1|cel`` past the device budget (monkeypatched below the
    fixtures' 115 KB), both trainers resuming from one JAX checkpoint: the
    first update's loss, the rotation draws (made on the prefetch thread,
    then the test pass's), the test pass and the parameters after the
    update against the JAX trainer's host path."""
    monkeypatch.setattr(ttrain, "DEVICE_BUDGET_BYTES", 1 << 10)
    with monkeypatch.context() as m:
        m.setattr(jax, "process_count", lambda *a, **k: 2)  # the JAX trainer's host path on one device
        jtrain.main(_flags(loss, tmp_path / "jax", start_checkpoint))
    hist = ttrain.main(_flags(loss, tmp_path / "port", start_checkpoint) + ["--device", "cpu"])
    jrec = [json.loads(line) for line in (tmp_path / "jax" / "log" / "test.metrics.jsonl").read_text().splitlines()]
    jtrain_loss = next(r["loss"] for r in jrec if r["split"] == "train")
    jtest = next(r for r in jrec if r["split"] == "test")
    assert abs(hist["train_loss"][0] - jtrain_loss) <= STEP_RTOL * abs(jtrain_loss), (hist["train_loss"], jtrain_loss)
    for k, v in jtest.items():
        if k not in ("epoch", "split", "time"):
            assert abs(hist["test"][0][k] - v) <= STEP_RTOL * max(abs(v), 1.0), (k, hist["test"][0][k], v)
    start = params_from_flax(tckpt.load_checkpoint(str(start_checkpoint))["params"])
    ref = params_from_flax(tckpt.load_checkpoint(str(tmp_path / "jax" / "pts" / "test_state.msgpack"))["params"])
    got = tckpt.load_checkpoint(str(tmp_path / "port" / "pts" / "test_state.pt"))["params"]
    assert set(got) == set(ref)
    saturated = []
    for k in ref:
        g, r, s0 = (np.asarray(t, np.float64) for t in (got[k], ref[k], start[k]))
        err = np.abs(g - r)
        # both steps lr within 5e-5 of it (|grad| above 2e-4, 2e4 x Adam's eps) and in one direction
        sat = ((np.abs(g - s0) > (1 - SAT) * LR) & (np.abs(r - s0) > (1 - SAT) * LR)
               & (np.sign(g - s0) == np.sign(r - s0)))
        assert (err[sat] <= ADAM_ATOL).all(), (k, err[sat].max())
        assert (err <= 2 * LR + ADAM_ATOL).all(), (k, err.max())
        saturated.append(sat.ravel())
    assert np.concatenate(saturated).mean() >= SATURATED_SHARE, np.concatenate(saturated).mean()


@pytest.mark.parametrize("flag", [["--smooth-reg", "0.1"], ["--eval-only"]])
def test_host_path_exits_as_jax(flag, tmp_path, monkeypatch):
    """On the host path ``--smooth-reg`` and ``--eval-only`` exit with the
    JAX trainer's messages."""
    monkeypatch.setattr(ttrain, "DEVICE_BUDGET_BYTES", 1 << 10)
    argv = ["--datapath", str(FAUST), "--layer", "2", "--loss", "cel", "--result-dir", str(tmp_path), *flag]
    msg = "--smooth-reg requires the single-device fast path" if flag[0] == "--smooth-reg" else (
        "--eval-only needs the single-device fast path")
    with monkeypatch.context() as m:
        m.setattr(jax, "process_count", lambda *a, **k: 2)
        with pytest.raises(SystemExit, match=msg):
            jtrain.main(argv + ["--result-dir", str(tmp_path / "jax")])
    with pytest.raises(SystemExit, match=msg):
        ttrain.main(argv + ["--device", "cpu"])
