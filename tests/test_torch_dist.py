"""The port's distributed runtime on the CPU against the JAX package.

* The host partition code (``partition_ell`` with ELL and BSR interiors,
  ``stack_partitioned`` with floors, ``prepartition_ell``,
  ``suggest_halo``, the bandwidth and block-size errors) gives JAX's arrays
  bit for bit.
* ``partitioned_spmm``, forward and backward, at 2 and 4 ranks with ELL and
  BSR interiors, equals JAX's ``make_partitioned_spmm`` on the conftest's
  virtual CPU devices on the same seeded inputs (fp32, within 1e-6 of the
  largest element: the same slot sums, XLA's gather-sum in its own order).
* The sharded ``GraphBatchNorm`` (plain and masked) and ``global_average``
  on (2, 2) and (1, 4) grids equal the JAX layers inside ``shard_map``
  under ``parallel_context.sharded_axes`` (the graph-parallel body of
  ``tests/test_dist.py``'s partitioned layer), forward and backward, fp64
  within 1e-10.
* ``initialize_multihost`` fails loudly (``--multihost`` itself:
  ``tests/test_torch_multihost.py``); ``make_mesh`` refuses a grid
  larger than its devices; the backend follows the devices; a rank that
  raises fails ``launch``; ``train_normal.main --data-parallel 2`` runs its
  ranks end to end, rank 0 writing the log and the checkpoint; the JAX
  trainers' refusals exit with their messages.

The ranks run in ``tests/_torch_dist_worker.py`` (four gloo ranks started
once for the file, under a hard timeout that kills them)."""

import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as P

from surfacenetworks_tpu import parallel_context as jpc
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.data.batching import rcm_reorder_sample as jrcm
from surfacenetworks_tpu.dist import edge_partition as jep
from surfacenetworks_tpu.dist import graph_parallel as jgp
from surfacenetworks_tpu.dist import make_mesh as jmake_mesh
from surfacenetworks_tpu.nn import layers as jlayers
from surfacenetworks_tpu_torch.dist import edge_partition as tep
from surfacenetworks_tpu_torch.dist import graph_parallel as tgp
from surfacenetworks_tpu_torch.dist import mesh_setup

from torch_parity import assert_close

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_dist_worker.py"
PSPMM_RTOL = 1e-6
LAYER_RTOL = 1e-10
WORKER_TIMEOUT_S = 120


def _banded(n: int, bw: int, seed: int) -> sp.csr_matrix:
    """A seeded banded operator with a full diagonal (bandwidth ``bw``)."""
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(n), np.arange(-bw, bw + 1), indexing="ij")
    j = i + j
    keep = (j >= 0) & (j < n) & ((rng.random(j.shape) < 0.25) | (j == i))
    L = sp.csr_matrix((rng.normal(size=keep.sum()).astype(np.float32), (i[keep], j[keep])), shape=(n, n))
    L.sum_duplicates()
    return L


def _mesh_laplacians(n: int = 3):
    """RCM-ordered Laplacians of seeded blob meshes (the JAX package's data)."""
    from surfacenetworks_tpu import geometry as jgeo

    out = []
    for s in range(n):
        V, F = jdatasets.random_blob_mesh(np.random.default_rng(s), 120 + 17 * s)
        sample = {"V": V, "F": F, "L": jgeo.igl_style_laplacian(V, F, hack=1.0), "input": V, "target": V}
        out.append(jrcm(sample)["L"])
    return out


FIELDS = ("cols", "vals", "bnd_rows", "bnd_cols", "bnd_vals", "bsr_cols", "bsr_vals")


def _same_ell(t, j, what):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        if b is None:
            assert a is None, (what, f)
            continue
        a = a.numpy()
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")
    assert (t.halo, t.n_parts, t.axis) == (j.halo, j.n_parts, j.axis), what


@pytest.mark.parametrize("n_parts,interior", [(2, "ell"), (4, "ell"), (2, "bsr"), (4, "bsr")])
def test_host_partition_matches_jax(n_parts, interior):
    """``partition_operator`` (both directions), ``suggest_halo`` and
    ``matrix_bandwidth`` on a banded operator, bit for bit."""
    L = _banded(512, 21, seed=n_parts)
    halo = tep.suggest_halo(L)
    assert halo == jep.suggest_halo(L) and tep.matrix_bandwidth(L) == jep.matrix_bandwidth(L) == 21
    t = tep.partition_operator(L, n_parts, halo=halo, k=32, interior_fmt=interior)
    j = jep.partition_operator(L, n_parts, halo=halo, k=32, interior_fmt=interior)
    _same_ell(t.fwd, j.fwd, "fwd")
    _same_ell(t.bwd, j.bwd, "bwd")


@pytest.mark.parametrize("interior", ["ell", "bsr"])
def test_prepartition_and_stack_match_jax(interior):
    """``prepartition_ell`` (dataset-wide halo, ``min_mb``/``min_kb``
    floors) on RCM-ordered mesh Laplacians, then ``stack_partitioned`` of a
    batch with the floors, and ``partition_batch_operator``: JAX's arrays
    bit for bit."""
    Ls = _mesh_laplacians()
    n_rows = 256
    tops, tfloors = tgp.prepartition_ell(Ls, 2, n_rows=n_rows, k=16, interior_fmt=interior)
    jops, jfloors = jgp.prepartition_ell(Ls, 2, n_rows=n_rows, k=16, interior_fmt=interior)
    assert tfloors == jfloors
    for t, j in zip(tops, jops):
        _same_ell(t.fwd, j.fwd, "fwd")
    ts = tep.stack_partitioned([tops[2], tops[0]], **tfloors)
    js = jep.stack_partitioned([jops[2], jops[0]], **jfloors)
    _same_ell(ts.fwd, js.fwd, "stacked fwd")
    _same_ell(ts.bwd, js.bwd, "stacked bwd")
    tb = tgp.partition_batch_operator(Ls[:2], 2, n_rows, interior_fmt=interior)
    jb = jgp.partition_batch_operator(Ls[:2], 2, n_rows, interior_fmt=interior)
    _same_ell(tb.fwd, jb.fwd, "batch fwd")


def test_partition_errors_match_jax():
    """The bandwidth above the halo, a partition not a multiple of the BSR
    block, too few ELL slots and an indivisible row count raise as in JAX."""
    L = _banded(512, 21, seed=1)
    for kwargs, msg in (({"halo": 16, "k": 32}, "bandwidth 21 exceeds halo 16"),
                        ({"halo": 24, "k": 32, "n_rows": 384, "interior_fmt": "bsr"}, "divisible by block size"),
                        ({"halo": 24, "k": 4}, "smaller than max row degree"),
                        ({"halo": 24, "k": 32, "n_rows": 513}, "not divisible by 2 partitions")):
        for mod in (tep, jep):
            with pytest.raises(ValueError, match=msg):
                mod.partition_ell(L, 2, **kwargs)


def _run_worker(spec: dict, tmp) -> None:
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen([sys.executable, str(WORKER), str(path), str(tmp)], cwd=tmp, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"the ranks did not finish in {WORKER_TIMEOUT_S} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-6000:]


PSPMM_CASES = [(2, "ell"), (4, "ell"), (2, "bsr"), (4, "bsr")]
LAYER_CASES = [((2, 2), False), ((2, 2), True), ((1, 4), False)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(7)
    L = _banded(512, 21, seed=3)
    np.savez(tmp / "pspmm.npz", data=L.data, indices=L.indices, indptr=L.indptr, shape=np.asarray(L.shape),
             halo=24, k=32, x=rng.normal(size=(512, 16)).astype(np.float32),
             g=rng.normal(size=(512, 16)).astype(np.float32))
    B, N, C = 4, 64, 8
    mask = np.ones((B, N, 1))
    mask[1, 50:] = 0
    mask[3, 40:] = 0
    np.savez(tmp / "layers.npz", x=rng.normal(size=(B, N, C)) * 3 + 1, mask=mask,
             scale=rng.normal(size=C), bias=rng.normal(size=C), gy=rng.normal(size=(B, N, C)),
             gga=rng.normal(size=(B, 1, C)))
    cases = [{"name": f"pspmm_{n}_{fmt}", "kind": "pspmm", "n_data": 1, "n_graph": n, "fmt": fmt,
              "input": str(tmp / "pspmm.npz")} for n, fmt in PSPMM_CASES]
    cases += [{"name": f"layers_{nd}x{ng}_{masked}", "kind": "layers", "n_data": nd, "n_graph": ng,
               "masked": masked, "input": str(tmp / "layers.npz")} for (nd, ng), masked in LAYER_CASES]
    _run_worker({"ranks": 4, "timeout": 60, "cases": cases}, tmp)
    return tmp


@pytest.mark.parametrize("n_parts,interior", PSPMM_CASES)
def test_partitioned_spmm_matches_jax(n_parts, interior, ranks):
    """Each rank's rows of ``L x`` and of the backward ``L^T g`` (the
    stored transpose, partitioned alike) against JAX's
    ``make_partitioned_spmm`` and its VJP on ``n_parts`` virtual devices."""
    f = np.load(ranks / "pspmm.npz")
    L = sp.csr_matrix((f["data"], f["indices"], f["indptr"]), shape=tuple(f["shape"]))
    op = jep.partition_operator(L, n_parts, halo=24, k=32, interior_fmt=interior)
    mesh = jmake_mesh(n_data=1, n_graph=n_parts, devices=jax.devices()[:n_parts])
    pspmm = jep.make_partitioned_spmm(mesh)
    with mesh:
        op_d = jep.shard_partitioned(mesh, op)
        x_d = jep.shard_rows(mesh, jnp.asarray(f["x"]))
        def fwd_bwd(x, g):
            y, vjp = jax.vjp(lambda v: pspmm(op_d, v), x)
            return y, vjp(g)[0]

        y, x_bar = jax.jit(fwd_bwd)(x_d, jnp.asarray(f["g"]))
    y, x_bar = np.asarray(y), np.asarray(x_bar)
    got_y = np.concatenate([np.load(ranks / f"pspmm_{n_parts}_{interior}_r{r}.npz")["y"] for r in range(n_parts)])
    got_x = np.concatenate([np.load(ranks / f"pspmm_{n_parts}_{interior}_r{r}.npz")["x_bar"]
                            for r in range(n_parts)])
    assert_close(got_y, y, PSPMM_RTOL, "forward")
    assert_close(got_x, x_bar, PSPMM_RTOL, "backward")
    Ld = L.toarray().astype(np.float64)
    assert_close(got_y, Ld @ f["x"], 1e-5, "forward against L x in fp64")


@pytest.mark.parametrize("grid,masked", LAYER_CASES)
def test_sharded_layers_match_jax(grid, masked, ranks):
    """Batch norm (statistics over the global batch x vertex rows, two
    passes) and the global average (masked sums over the vertex axis) on
    a ``grid`` of ranks, forward and backward, against the JAX layers in
    ``shard_map`` under ``sharded_axes('graph', 'data')``; fp64.  The
    global average's cotangent enters once (on the graph axis's first
    rank), as the JAX output, replicated over 'graph', takes it once."""
    nd, ng = grid
    f = np.load(ranks / "layers.npz")
    mesh = jmake_mesh(n_data=nd, n_graph=ng, devices=jax.devices()[: nd * ng])
    bn = jlayers.GraphBatchNorm(f["x"].shape[-1], masked=masked)

    def body(params, x, m):
        with jpc.sharded_axes(vertex_axis="graph", batch_axis="data"):
            return bn.apply({"params": params}, x, m), jlayers.global_average(x, m)

    with jax.enable_x64(True):
        fn = jax.shard_map(body, mesh=mesh, in_specs=(P(), P("data", "graph"), P("data", "graph")),
                           out_specs=(P("data", "graph"), P("data")))
        params = {"scale": jnp.asarray(f["scale"]), "bias": jnp.asarray(f["bias"])}
        def fwd_bwd(p, x, m, gy, gga):
            out, vjp = jax.vjp(lambda q, v: fn(q, v, m), p, x)
            return out, vjp((gy, gga))

        (y, ga), (p_bar, x_bar) = jax.jit(fwd_bwd)(params, *(jnp.asarray(f[k]) for k in ("x", "mask", "gy", "gga")))
        y, ga, x_bar = np.asarray(y), np.asarray(ga), np.asarray(x_bar)
        p_bar = {k: np.asarray(v) for k, v in p_bar.items()}
    B, N, _ = f["x"].shape
    got = {r: np.load(ranks / f"layers_{nd}x{ng}_{masked}_r{r}.npz") for r in range(nd * ng)}
    for r, res in got.items():
        d, g = divmod(r, ng)
        bs, ns = slice(d * B // nd, (d + 1) * B // nd), slice(g * N // ng, (g + 1) * N // ng)
        assert_close(res["y"], y[bs, ns], LAYER_RTOL, f"rank {r} batch norm")
        assert_close(res["ga"], ga[bs], LAYER_RTOL, f"rank {r} global average")
        assert_close(res["x_bar"], x_bar[bs, ns], LAYER_RTOL, f"rank {r} backward")
    for k in ("scale", "bias"):
        assert_close(sum(res[f"{k}_bar"] for res in got.values()), p_bar[k], LAYER_RTOL, f"{k} gradient")


def test_initialize_multihost_fails_loudly(monkeypatch):
    """A misconfigured bootstrap raises (a refused connection at the
    rendezvous, missing or partial coordinator flags, an address without a
    port); only a process group already up is a no-op; the ranks agree on
    the backend from the device identities each posts."""
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise RuntimeError("Failed to connect to coordinator 127.0.0.1:1234")

    monkeypatch.setattr(dist, "rendezvous", refuse)
    with pytest.raises(RuntimeError, match="Failed to connect"):
        mesh_setup.initialize_multihost("tcp://127.0.0.1:1234", 0, 2, torch.device("cpu"))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="needs all of"):
        mesh_setup.multihost_process("127.0.0.1:1234")
    with pytest.raises(SystemExit, match="torchrun's environment"):
        mesh_setup.multihost_process()
    with pytest.raises(SystemExit, match="is not host:port"):
        mesh_setup.multihost_process("127.0.0.1", 2, 0)
    assert mesh_setup.multihost_process("127.0.0.1:1234", 2, 1) == ("tcp://127.0.0.1:1234", 2, 1, None)
    assert mesh_setup.choose_backend_of(["a", "b"]) == "nccl" and mesh_setup.choose_backend_of(["a", "a"]) == "gloo"
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    assert mesh_setup.initialize_multihost("tcp://127.0.0.1:1234", 0, 2, torch.device("cpu")) == "gloo"  # no-op


def test_mesh_and_backend_rules(monkeypatch):
    """``make_mesh`` refuses a grid larger than its devices (as the JAX
    mesh asserts) and more than one rank without a process group; the
    backend is gloo on the CPU or on a repeated card, nccl on cards of
    their own; a one-rank grid needs no process group; ranks on the card
    are refused when fewer cards are visible."""
    with pytest.raises(ValueError, match="needs 4 devices, 2 given"):
        mesh_setup.make_mesh(2, 2, devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="needs torch.distributed initialised"):
        mesh_setup.make_mesh(2, 1, devices=["cpu", "cpu"])
    one = mesh_setup.make_mesh(1, 1, devices=["cpu"])
    assert (one.size, one.rank, one.backend, one.graph.size, one.data.size) == (1, 0, "gloo", 1, 1)
    assert mesh_setup.choose_backend(["cpu", "cpu"]) == "gloo"
    assert mesh_setup.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert mesh_setup.choose_backend(["cuda:0", "cuda:0"]) == "gloo"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit, match="2 ranks need 2 CUDA devices, 1 visible"):
            mesh_setup.default_devices("cuda", 2)


def _fail_on_rank_one(mesh):
    import time

    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    time.sleep(120)  # rank 0 would go on for minutes: the failure must end it
    return "unreachable"


def test_a_failing_rank_fails_the_launch():
    """A rank that raises makes ``launch`` raise with its error (the
    trainers then exit nonzero), and the other rank is ended at once, not
    waited for."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        mesh_setup.launch(_fail_on_rank_one, 2, device="cpu", timeout_s=30, threads=1)
    assert time.perf_counter() - t0 < 100


def test_train_normal_main_runs_ranks(tmp_path):
    """``main --data-parallel 2`` on the CPU starts two ranks; rank 0
    writes the log (the grid's line among it) and the checkpoint, and
    ``main`` returns its history."""
    from surfacenetworks_tpu_torch.cli import train_normal as ttrain

    hist = ttrain.main(["--device", "cpu", "--data-path", str(REPO / "tests" / "fixtures" / "objs"), "--layer", "2",
                        "--batch-size", "2", "--num-epoch", "1", "--num-updates", "2", "--data-parallel", "2",
                        "--result-dir", str(tmp_path)])
    (loss, mad), = hist["train"]
    assert np.isfinite(loss) and np.isfinite(mad) and len(hist["test"]) == 1
    log = (tmp_path / "log" / "debug.log").read_text()
    assert "rank grid: 2 data x 1 graph ranks over gloo" in log and log.count("Train 0, loss") == 1
    assert torch.load(tmp_path / "pts" / "debug_normal_state.pt", weights_only=True)["step"] == 2


REFUSED = [
    ("train_normal", ["--graph-parallel", "2", "--model", "dirac", "--operator-format", "bsr"], "supports ell or bsr"),
    ("train_normal", ["--graph-parallel", "2", "--model", "cas"], "supports the lap, dirac and gat models"),
    ("train_normal", ["--data-parallel", "2", "--batch-size", "2", "--rotate-augment", "--no-device-store"],
     "needs the device-store fast path"),
    ("train_normal", ["--graph-parallel", "2", "--model", "avg"], "supports the lap, dirac and gat models"),
    ("train_normal", ["--graph-parallel", "2", "--operator-format", "dense"], "supports ell or bsr"),
    ("train_normal", ["--data-parallel", "2", "--model", "cas"], "does not support the cascade model"),
    ("train_arap", ["--graph-parallel", "2", "--dense"], "partitions sparse operators; drop --dense"),
    ("train_mnist", ["--graph-parallel", "2", "--model", "avg"], "supports the lap and dirac models"),
    ("train_vae", ["--graph-parallel", "2", "--data-parallel", "2"], "mutually exclusive here"),
    ("train_correspondence", ["--graph-parallel", "2", "--model", "amp"], "supports the lap and dir trunks"),
    ("train_arap", ["--graph-parallel", "2", "--model", "gcn"], "supports the lap and dir models"),
    ("train_mnist", ["--graph-parallel", "2", "--data-parallel", "2"], "mutually exclusive here"),
    ("train_correspondence", ["--graph-parallel", "2", "--smooth-reg", "0.1"], "requires the single-device fast path"),
    ("train_correspondence", ["--multihost", "--smooth-reg", "0.1"], "requires the single-device fast path"),
]


@pytest.mark.parametrize("name,flags,msg", REFUSED, ids=[f"{n}-{'-'.join(f)}" for n, f, _ in REFUSED])
def test_still_refused_flags_exit(name, flags, msg):
    """The JAX trainers' refusals of flag combinations exit with their
    messages (the port runs every flag now: none is refused as unported);
    ``--data-parallel 1`` and ``--graph-parallel 1`` mean off."""
    import importlib

    mod = importlib.import_module(f"surfacenetworks_tpu_torch.cli.{name}")
    refuse = mod.check_parallel if name == "train_normal" else (
        (lambda a: mod.refuse_unported(a, name)) if name in ("train_mnist", "train_vae") else mod.refuse_unported)
    with pytest.raises(SystemExit, match=msg):
        refuse(mod.parser.parse_args(flags))
    refuse(mod.parser.parse_args(["--data-parallel", "1"] if name != "train_correspondence" else []))
    refuse(mod.parser.parse_args(["--graph-parallel", "1"]))


def test_train_loop_steps():
    """``train/loop.py``: ``make_train_step`` is the trainer's update
    (forward, loss, backward, the scheduled optimizer step, the count);
    ``make_dp_train_step`` on a one-rank grid takes the same step bit for
    bit; ``make_eval_step`` returns the loss and changes nothing;
    ``check_finite`` raises on a non-finite metric."""
    import copy

    from surfacenetworks_tpu_torch.data import Buckets, datasets, laplacian_batch
    from surfacenetworks_tpu_torch.dist import make_dp_train_step
    from surfacenetworks_tpu_torch.models import LapDeepModel, init_weights
    from surfacenetworks_tpu_torch.train import losses, optim
    from surfacenetworks_tpu_torch.train.loop import TrainState, check_finite, make_eval_step, make_train_step

    samples = datasets.synthetic_normal_dataset(2, 60, seed=0, operator="lap")
    batch = laplacian_batch(samples, Buckets.for_samples(samples), fmt="ell")
    model = init_weights(LapDeepModel(3, 3, layers=2), torch.Generator().manual_seed(0))

    def apply_fn(m, b):
        return m(b.operator, b.mask, b.inputs)

    def loss_fn(out, b):
        return losses.normal_cosine_loss(out, b.mask, b.targets), {"mad": losses.mean_angle_deviation(out, b.mask,
                                                                                                     b.targets)}

    schedule = optim.epoch_halving_schedule(1e-3, 1, 0, 1)
    states = []
    for _ in range(2):
        m = copy.deepcopy(model)
        states.append(TrainState(m, optim.adam(m.parameters(), schedule), schedule))
    one = make_train_step(apply_fn, loss_fn)(states[0], batch)
    dp = make_dp_train_step(apply_fn, loss_fn, mesh_setup.make_mesh(1, 1, devices=["cpu"]))(states[1], batch)
    assert states[0].step == states[1].step == 1 and torch.equal(one["loss"], dp["loss"])
    for a, b in zip(states[0].model.parameters(), states[1].model.parameters()):
        assert torch.equal(a, b)
    before = [p.detach().clone() for p in states[0].model.parameters()]
    ev = make_eval_step(apply_fn, loss_fn)(states[0].model, batch)
    assert set(ev) == {"loss", "mad"} and all(torch.equal(a, b) for a, b in zip(before, states[0].model.parameters()))
    check_finite(ev)
    with pytest.raises(FloatingPointError):
        check_finite({"loss": torch.tensor(float("nan"))})
