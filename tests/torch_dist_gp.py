"""Shared cases and checks of the graph-parallel trainer tests
(``tests/test_torch_dist_gp_train.py`` and ``tests/test_torch_dist_gp_mesh.py``),
which hold the port's graph-parallel steps against its single-device step
and against the JAX package's graph-parallel step; the cases, the
tolerances and why are in ``test_torch_dist_gp_train.py``'s docstring."""

import functools
import glob
import json
import os
import pathlib
import random
import signal
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import PartitionSpec as P

from surfacenetworks_tpu import native as jnative
from surfacenetworks_tpu import parallel_context as jpc
from surfacenetworks_tpu.cli import train_arap as jarap
from surfacenetworks_tpu.cli import train_normal as jnormal
from surfacenetworks_tpu.cli.common import EpochSampler as JEpochSampler
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.dist import dirac_partition as jdp
from surfacenetworks_tpu.dist import edge_partition as jep
from surfacenetworks_tpu.dist import graph_parallel as jgp
from surfacenetworks_tpu.dist import make_mesh
from surfacenetworks_tpu.models import SiameseModel as JSiameseModel
from surfacenetworks_tpu.models import mnist_models as jmnist
from surfacenetworks_tpu.models import normal_models as jmodels
from surfacenetworks_tpu.models.vae import DirVAE as JDirVAE
from surfacenetworks_tpu.models.vae import LapVAE as JLapVAE
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.models import DirDeepModel, GatDeepModel, SiameseModel
from surfacenetworks_tpu_torch.models import arap_models as tarap
from surfacenetworks_tpu_torch.models import mnist_models as tmnist
from surfacenetworks_tpu_torch.models import vae as tvae

from torch_parity import ADAM_EPS, NULL_ATOL, assert_close, hold_grads, random_params, state64

REPO = pathlib.Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures"
WORKER = REPO / "tests" / "_torch_dist_worker.py"
LR = 1e-3
FP64_LOSS, FP64_GRAD, FP64_PARAM = 1e-12, 1e-9, 1e-9
# a flipped first Adam step moves an element by exactly 2 lr; its fp32 parameters round once more
FP32_LOSS, FP32_PARAM = 3e-5, 2 * LR + 1e-7
# the cosine loss of DirDeepModel's outputs (see the module docstring)
FP64_DIRAC_LOSS, FP64_DIRAC_GRAD = 1e-9, 1e-7
DIRAC_NULL = {"rn1.bn_fc1.fc.bias", "rn1.bn_fc1.bn.bias"}
JAX_RTOL = 1e-6
WORKER_TIMEOUT_S = 120
G = 2
KW = 0.5  # the worker's KLD weight
DROPOUT_KEY, SAMPLE_KEY = 9, 11

NORMAL = ["--data-path", str(FIX / "objs"), "--layer", "2", "--batch-size", "2", "--num-updates", "1",
          "--num-epoch", "1", "--debug", "--graph-parallel", str(G)]
ARAP = ["--data-path", str(FIX / "arap"), "--layer", "2", "--batch-size", "4", "--num-updates", "1", "--num-epoch", "1",
        "--graph-parallel", str(G)]
MNIST = ["--data-path", str(FIX / "mnist_plus.np"), "--batch-size", "4", "--num-epoch", "1", "--graph-parallel", str(G)]
FAUST = ["--datapath", str(FIX / "faust"), "--layer", "2", "--num-updates", "1", "--num-epoch", "1", "--xz-rotate",
         "--xy-rotate", "--deser-option", "no", "--graph-parallel", str(G)]

CASES = {
    "normal_dirac": ("normal", 1, G, NORMAL + ["--model", "dirac"]),
    "normal_gat": ("normal", 1, G, NORMAL + ["--model", "gat"]),
    "normal_dirac_dp2": ("normal", 2, G, NORMAL + ["--model", "dirac", "--data-parallel", "2"]),
    "arap_lap": ("arap", 1, G, ARAP),
    "arap_dir": ("arap", 1, G, ARAP + ["--model", "dir"]),
    "mnist_lap": ("mnist", 1, G, MNIST + ["--layer", "2", "--model", "lap"]),
    "mnist_dirac": ("mnist", 1, G, MNIST + ["--layer", "1", "--model", "dirac"]),
    "vae_lap": ("vae", 1, G, MNIST + ["--num-layers", "2", "--model", "lap"]),
    "vae_dirac": ("vae", 1, G, MNIST + ["--num-layers", "1", "--model", "dirac"]),
    "faust_lap": ("correspondence", 1, G, FAUST + ["--model", "lap", "--operator-format", "ell"]),
    "faust_bsr": ("correspondence", 1, G, FAUST + ["--model", "lap", "--operator-format", "bsr"]),
    "faust_dir": ("correspondence", 1, G, FAUST + ["--model", "dir"]),
}
EXTRA = {
    "normal_dirac_host": ("normal", 1, G, CASES["normal_dirac"][3] + ["--no-device-store"]),
    "normal_dirac_local_bn": ("normal", 1, G, CASES["normal_dirac"][3]),
    # sharded paths held to the single-device step only (JAX's GP paths take them too)
    "faust_lap_remat": ("correspondence", 1, G, CASES["faust_lap"][3] + ["--remat"]),
    "normal_dirac_bf16": ("normal", 1, G, CASES["normal_dirac"][3] + ["--bf16"]),
    "mnist_lap_bf16": ("mnist", 1, G, CASES["mnist_lap"][3] + ["--bf16"]),
}
# each extra run's model, weights and draws are those of the case it varies
BASE = {"normal_dirac_dp2": "normal_dirac", "normal_dirac_host": "normal_dirac", "normal_dirac_local_bn": "normal_dirac",
        "normal_dirac_bf16": "normal_dirac", "faust_lap_remat": "faust_lap", "mnist_lap_bf16": "mnist_lap"}
BF16 = {"normal_dirac_bf16", "mnist_lap_bf16"}  # a bf16 model's fp32 step alone: it computes in bf16 anyway
# A bf16 step's loss: the sharded steps' fp32 rule (3e-5) holds for normal Dirac (bit-identical to one device) but not for
# the classifier, 2.3e-4 off (measured): its activations round to bf16 after statistics summed in another order,
# and an element that lands on the other side of a rounding boundary moves by a bf16 unit.  Its loss is held to
# bf16's unit roundoff, 2**-9, below the rank-local batch-norm mutant's 1.1e-2 (chip_smoke.py's reading).
BF16_LOSS = 2.0**-9
JAX_CASES = [c for c in sorted(CASES) if c != "normal_dirac_dp2"]


def _flag(argv: list, name: str, default=None):
    return argv[argv.index(name) + 1] if name in argv else default


def _depth(case: str) -> int:
    argv = CASES[case][3]
    return int(_flag(argv, "--layer", _flag(argv, "--num-layers", 2)))


def _family(case: str) -> str:
    return {"correspondence": "faust"}.get(CASES[case][0], CASES[case][0])


# ---------------------------------------------------------------------------
# the JAX side: data in the JAX trainers' graph-parallel order, and models
# ---------------------------------------------------------------------------


def _sort_faces(s: dict, keys=("dirac",)) -> dict:
    s["F"] = np.asarray(s["F"])[jdp.sort_faces_for_partition(s["F"])]
    for k in keys:
        s[k] = None
    return s


def _normal_data(model: str):
    args = jnormal.parser.parse_args(NORMAL + ["--model", model])
    random.seed(args.seed)
    train, test = jnormal.load_samples(args, lambda _: None)
    train = [jbat.rcm_reorder_sample(s) for s in train]
    test = [jbat.rcm_reorder_sample(s) for s in test]
    if model == "dirac":
        train = [_sort_faces(s) for s in train]
        test = [_sort_faces(s) for s in test]
    tier = jbat.BucketSet.for_samples(train + test, n_tiers=1, multiple=8 * G).tiers[-1]
    return train, test, tier


def _mnist_data(dirac: bool, vae: bool):
    data = jdatasets.load_mnist_mesh_pickle(str(FIX / "mnist_plus.np"))
    data = [jbat.rcm_reorder_sample(s) for s in data]
    if dirac:
        data = [_sort_faces(s, ("dirac", "flat_dirac")) for s in data]
    sep = max(1, int(len(data) * 0.8))
    buckets = jbat.Buckets.for_samples(data, multiple=8 * G)
    first = JEpochSampler(data[:sep], 4, seed=17).next_batch()
    return data, first, buckets


def _faust_data(model: str, bsr: bool):
    data = [jdatasets.load_faust_npz(f) for f in sorted(glob.glob(str(FIX / "faust" / "*.npz")))]
    data = [jbat.rcm_reorder_sample(s) for s in data]
    if model == "dir":
        data = [_sort_faces(s) for s in data]
    return data, jbat.Buckets.for_samples(data, multiple=(128 if bsr else 8) * G)


def _arap_data(model: str):
    seqs = [jbat.rcm_reorder_sequence(s) for s in jarap.load_sequences(jarap.parser.parse_args(ARAP))]
    if model == "dir":
        for seq in seqs:
            fperm = jdp.sort_faces_for_partition(seq[0]["F"])
            for f in seq:
                f["F"] = np.asarray(f["F"])[fperm]
                f.pop("dirac", None)
    buckets = jbat.Buckets.for_samples([{"V": s[0]["V"], "F": s[0]["F"]} for s in seqs], multiple=8 * G)
    return seqs, buckets


def _models(case: str):
    """(JAX module, port module, a plain JAX batch's init arguments)."""
    fam, argv = _family(case), CASES[case][3]
    model = _flag(argv, "--model", "lap")
    if fam == "normal":
        train, _, tier = _normal_data(model)
        jb = (jbat.dirac_batch if model == "dirac" else jbat.laplacian_batch)(train[:2], tier)
        jm = (jmodels.DirDeepModel if model == "dirac" else jmodels.GatDeepModel)(3, 3, 2)
        tm = (DirDeepModel if model == "dirac" else GatDeepModel)(3, 3, 2)
        return jm, tm, (_tree(jb.operator), jnp.asarray(jb.mask), jnp.asarray(jb.inputs)), {}
    if fam == "arap":
        seqs, buckets = _arap_data(model)
        jb = jbat.arap_batch(seqs, [(0, 0)], buckets, model="dirac" if model == "dir" else "lap", fmt="ell")
        return (jarap.MODELS[model](layers=2), tarap.MODELS[model](layers=2),
                (_tree(jb.operator), jnp.asarray(jb.mask), jnp.asarray(jb.inputs)), {})
    if fam == "mnist":
        data, first, buckets = _mnist_data(model == "dirac", False)
        jb = jbat.mnist_batch(first, buckets, model=model)
        return ((jmnist.DirModel if model == "dirac" else jmnist.Model)(layers=_depth(case)),
                tmnist.MODELS[model](layers=_depth(case)),
                (jnp.asarray(jb.inputs), _tree(jb.operator), jnp.asarray(jb.mask)), {"deterministic": True})
    if fam == "vae":
        data, first, buckets = _mnist_data(model == "dirac", True)
        jb = jbat.vae_batch(first, buckets, model=model)
        return ((JDirVAE if model == "dirac" else JLapVAE)(num_layers=_depth(case)),
                tvae.MODELS[model](num_layers=_depth(case)),
                (jnp.asarray(jb.inputs), jnp.asarray(jb.aux["flat_inputs"]), _tree(jb.operator),
                 _tree(jb.aux["flat_operator"]), jnp.asarray(jb.mask)), {})
    data, buckets = _faust_data(model, False)
    key = "dirac" if model == "dir" else "lap"
    jb = jbat.correspondence_batch(data[0], buckets, model=key, fmt="ell")
    op = (_tree(jb.operator), jnp.asarray(jb.mask))
    return JSiameseModel(model=model, layers=2), SiameseModel(model, 2), (op, op, jnp.asarray(jb.inputs),
                                                                           jnp.asarray(jb.inputs)), {}


def _tree(op):
    return jax.tree_util.tree_map(jnp.asarray, op)


def _params(case: str):
    """Seeded flax params of the case's model and the port's ``state_dict``
    of them."""
    jm, tm, args, kw = _models(case)
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1), "dropout": jax.random.key(2)}
    shapes = jax.eval_shape(lambda: jm.init(rngs, *args, **kw))["params"]
    params = random_params(shapes, 31)
    return params, params_from_flax(jax.tree_util.tree_map(np.asarray, params), like=tm)


def _jax_draw(case: str, params) -> np.ndarray:
    """JAX's dropout keep mask (mesh-MNIST) or noise (VAE) of the first
    batch, from its single-device fp64 forward with the key its
    graph-parallel step draws from."""
    fam, model = _family(case), _flag(CASES[case][3], "--model")
    data, first, buckets = _mnist_data(model == "dirac", fam == "vae")
    with jax.enable_x64(True):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        if fam == "mnist":
            jb = jbat.mnist_batch(first, buckets, model=model)
            jm = (jmnist.DirModel if model == "dirac" else jmnist.Model)(layers=_depth(case))

            def dropped(p_):
                _, st = jm.apply({"params": p_}, jnp.asarray(jb.inputs, jnp.float64), _tree(jb.operator),
                                 jnp.asarray(jb.mask, jnp.float64), deterministic=False,
                                 rngs={"dropout": jax.random.key(DROPOUT_KEY)}, capture_intermediates=True,
                                 mutable=["intermediates"])
                return st["intermediates"]["head"]["Dropout_0"]["__call__"][0]

            return (np.asarray(jax.jit(dropped)(p)) != 0).astype(np.float64)
        jb = jbat.vae_batch(first, buckets, model=model)
        jm = (JDirVAE if model == "dirac" else JLapVAE)(num_layers=_depth(case))
        normal = jax.random.normal

        def noise(p_):
            drawn = []

            def recorded(*a, **k):  # the noise itself, not (z - mu) / std, which loses digits where std is small
                drawn.append(normal(*a, **k))
                return drawn[-1]

            with mock.patch.object(jax.random, "normal", recorded):
                jm.apply({"params": p_}, jnp.asarray(jb.inputs, jnp.float64),
                         jnp.asarray(jb.aux["flat_inputs"], jnp.float64), _tree(jb.operator),
                         _tree(jb.aux["flat_operator"]), jnp.asarray(jb.mask, jnp.float64),
                         rngs={"sample": jax.random.key(SAMPLE_KEY)})
            (eps,) = drawn
            return eps

        return np.asarray(jax.jit(noise)(p))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _run_worker(spec: dict, tmp) -> None:
    """The worker under a hard timeout; on expiry its whole process group
    (the ranks included) is killed."""
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


def run_cases(tmp, names: list):
    """The worker over ``names`` (of CASES and EXTRA); returns
    ``load(name, rank=0)``, a case's results on a rank, with ``.params``
    (each model's flax parameters) and ``.tmp``."""
    params, cases = {}, []
    for name in names:
        trainer, nd, ng, argv = {**CASES, **EXTRA}[name]
        base = BASE.get(name, name)
        if base not in params:
            params[base] = _params(base)
            np.savez(tmp / f"{base}_state.npz", **{k: v.numpy() for k, v in params[base][1].items()})
        case = {"name": name, "trainer": trainer, "n_data": nd, "n_graph": ng, "argv": argv,
                "state": str(tmp / f"{base}_state.npz")}
        if trainer in ("mnist", "vae"):
            np.savez(tmp / f"{name}_draw.npz", draw=_jax_draw(base, params[base][0]))
            case["draw"] = str(tmp / f"{name}_draw.npz")
        if name.endswith("local_bn"):
            case["mutant"] = "local_bn"
        if name in BF16:
            case["dtypes"] = ["32"]
        cases.append(case)
    _run_worker({"ranks": 4, "timeout": 60, "cases": cases}, tmp)

    def load(name, rank=0):
        return dict(np.load(tmp / f"{name}_r{rank}.npz"))

    load.params = {k: v[0] for k, v in params.items()}
    load.tmp = tmp
    return load


def _keys(r):
    return sorted(k[2:-2] for k in r if k.startswith("p.") and k.endswith("64"))


def _bounds(case: str):
    """(fp64 loss rtol, fp64 gradient rtol, null gradient leaves)."""
    if BASE.get(case, case) == "normal_dirac":
        return FP64_DIRAC_LOSS, FP64_DIRAC_GRAD, DIRAC_NULL
    return FP64_LOSS, FP64_GRAD, set()


def _grads(r, prefix: str = "") -> dict:
    return {k: r[f"{prefix}g.{k}64"] for k in _keys(r)}


def state0(runs, case: str) -> dict:
    return dict(np.load(runs.tmp / f"{BASE.get(case, case)}_state.npz"))


def _hold_update(r, new: dict, grads: dict, state: dict, case: str, rtol, what: str) -> None:
    """The fp64 parameters after the first Adam update against ``new``
    (after ``grads``): every element the update of its own gradient within
    1e-12, and within ``rtol(k) * max|new[k]|`` of ``new`` wherever the
    first update is well conditioned, ``|g| >= sqrt(lr eps max|g| /
    max|p|)`` of the decayed gradient (``torch_parity.hold_adam_update``'s
    rule); at least 90% of the elements are."""
    wd = 0.0 if {**CASES, **EXTRA}[case][0] == "normal" else 1e-5
    held = total = 0
    for k in _keys(r):
        p0, got, ref = state[k].astype(np.float64), r[f"p.{k}64"], new[k]
        g_own, g_ref = r[f"g.{k}64"] + wd * p0, grads[k] + wd * p0
        assert_close(got, p0 - LR * g_own / (np.abs(g_own) + ADAM_EPS), 1e-12, f"{what}: {k} after Adam")
        scale = max(float(np.abs(ref).max()), 1e-30)
        ok = np.abs(g_ref) >= np.sqrt(LR * ADAM_EPS * float(np.abs(g_ref).max()) / scale)
        held, total = held + int(ok.sum()), total + ok.size
        if ok.any():
            err = float(np.abs(got - ref)[ok].max())
            assert err <= rtol(k) * scale, f"{what}: parameter {k}: {err:.3e} > {rtol(k):g} * {scale:.3e}"
    assert held >= 0.9 * total, f"{what}: only {held} of {total} elements have a well-conditioned first update"


def hold_single(r, what, case: str, state: dict):
    loss_rtol, grad_rtol, null = _bounds(case)
    assert abs(float(r["loss64"]) - float(r["ref.loss64"])) <= loss_rtol * abs(float(r["ref.loss64"])), what
    hold_grads(_grads(r), _grads(r, "ref."), grad_rtol, null, f"{what}: fp64 gradient")
    _hold_update(r, {k: r[f"ref.p.{k}64"] for k in _keys(r)}, _grads(r, "ref."), state, case,
                 lambda k: max(FP64_PARAM, grad_rtol), f"{what}: fp64")
    for k in _keys(r):
        np.testing.assert_allclose(r[f"p.{k}32"], r[f"ref.p.{k}32"], rtol=0, atol=FP32_PARAM,
                                   err_msg=f"{what}: fp32 parameter {k}")
    assert abs(float(r["loss32"]) - float(r["ref.loss32"])) <= FP32_LOSS * abs(float(r["ref.loss32"])), what


def hold_single_fp32(r, what, loss_rtol: float = FP32_LOSS):
    """The sharded steps' fp32 rules alone: the loss within ``loss_rtol`` (3e-5)
    relative, every parameter within 2 lr + 1e-7 of the single-device
    step's."""
    keys = sorted(k[2:-2] for k in r if k.startswith("p.") and k.endswith("32"))
    assert keys
    for k in keys:
        np.testing.assert_allclose(r[f"p.{k}32"], r[f"ref.p.{k}32"], rtol=0, atol=FP32_PARAM,
                                   err_msg=f"{what}: fp32 parameter {k}")
    assert abs(float(r["loss32"]) - float(r["ref.loss32"])) <= loss_rtol * abs(float(r["ref.loss32"])), what


def hold_single_device(case, runs):
    """One update on every rank's rows equals the update alone on the whole
    batch (see the module docstring for the tolerances; a ``--bf16`` run by
    the fp32 rules alone), and every rank of the grid holds the same
    parameters afterwards, bit for bit."""
    _, nd, ng, _ = {**CASES, **EXTRA}[case]
    r0 = runs(case)
    if case in BF16:
        hold_single_fp32(r0, case, FP32_LOSS if case.startswith("normal") else BF16_LOSS)
    else:
        hold_single(r0, case, case, state0(runs, case))
    tags = ("32",) if case in BF16 else ("64", "32")
    for rank in range(1, nd * ng):
        rk = runs(case, rank)
        for k in sorted(k[2:-2] for k in r0 if k.startswith("p.") and k.endswith("32")):
            for tag in tags:
                np.testing.assert_array_equal(rk[f"p.{k}{tag}"], r0[f"p.{k}{tag}"], err_msg=f"rank {rank} {k}")
        assert float(rk["loss32"]) == float(r0["loss32"])


# ---------------------------------------------------------------------------
# against JAX's graph-parallel steps
# ---------------------------------------------------------------------------


def _value_and_grad(objective, params):
    """``jax.value_and_grad(objective)(params)``, compiled at XLA's lowest
    backend optimisation level: the references' compile time halves and
    their fp64 sums stay far inside the 1e-6 they are held to."""
    fn = jax.jit(jax.value_and_grad(objective)).lower(params).compile(
        compiler_options={"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return fn(params)


@functools.partial(jax.jit, static_argnames=("wd",))
def _adam64(params, grads, wd=0.0):
    """optax's first update as the trainers build it: Adam at LR (ARAP's
    halving schedule is LR at its first step), coupled L2 ``wd``."""
    tx = joptim.adam(LR, weight_decay=wd) if wd else joptim.adam(LR)
    upd, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, upd)


def _gmesh():
    return make_mesh(n_data=1, n_graph=G, devices=jax.devices()[:G])


def _sharded_step(model_apply, op, arrays: dict, loss_of, params, wd: float, out_rows: bool = True):
    """JAX's graph-parallel step in fp64: ``model_apply(p, op, mask,
    inputs, *extra)`` inside ``make_graph_sharded_apply`` on the placed
    batch, ``loss_of(out, arrays)`` on the global output, its gradient and
    optax's Adam."""
    mesh = _gmesh()
    apply = jgp.make_graph_sharded_apply(mesh, model_apply, out_vertex_sharded=out_rows)
    arrays = {k: np.asarray(v, np.float64) for k, v in arrays.items()}
    op_d, placed = jgp.place_graph_batch(mesh, op, {k: arrays[k] for k in ("mask", "inputs")})

    def objective(p):
        return loss_of(apply(p, op_d, placed["mask"], placed["inputs"]), arrays)

    loss, g = _value_and_grad(objective, params)
    return float(loss), state64(g), state64(_adam64(params, g, wd))


def _jax_normal(case: str, names: list, params):
    model = _flag(CASES[case][3], "--model")
    train, test, tier = _normal_data(model)
    by_name = {s["name"]: s for s in train}
    samples = [by_name[n] for n in names]
    items = train + test
    if model == "dirac":
        ops, floors = jgp.prepartition_dirac([jnative.dirac_coeffs(s["V"], s["F"]) for s in items], G,
                                             tier.n_vertices, tier.n_faces, max_valence=tier.max_valence)
        part = dict(zip([s["name"] for s in items], ops))
        jb = jbat.dirac_batch(samples, tier, operator=jdp.stack_partitioned_dirac([part[n] for n in names], **floors))
        jm = jmodels.DirDeepModel(3, 3, 2)
    else:
        ops, floors = jgp.prepartition_ell([s["L"] for s in items], G, n_rows=tier.n_vertices, k=tier.ell_k)
        part = dict(zip([s["name"] for s in items], ops))
        jb = jbat.laplacian_batch(samples, tier, operator=jep.stack_partitioned([part[n] for n in names], **floors))
        jm = jmodels.GatDeepModel(3, 3, 2)
    return _sharded_step(lambda p, o, mk, x: jm.apply({"params": p}, o, mk, x), jb.operator,
                         {"mask": jb.mask, "inputs": jb.inputs, "targets": jb.targets},
                         lambda out, a: jlosses.normal_cosine_loss(out, a["mask"], a["targets"]), params, 0.0)


def _jax_arap(case: str, names: list, params):
    model = _flag(CASES[case][3], "--model", "lap")
    seqs, buckets = _arap_data(model)
    picks = [tuple(int(v) for v in n.strip("()").split(",")) for n in names]
    frames = [(si, fi) for si, seq in enumerate(seqs) for fi in range(min(10, len(seq)))
              if model == "dir" or "L" in seq[fi]]
    if model == "dir":
        ops, floors = jgp.prepartition_dirac([jnative.dirac_coeffs(seqs[si][fi]["V"], seqs[si][fi]["F"])
                                              for si, fi in frames], G, buckets.n_vertices, buckets.n_faces,
                                             max_valence=buckets.max_valence)
        stack = jdp.stack_partitioned_dirac
    else:
        ops, floors = jgp.prepartition_ell([seqs[si][fi]["L"] for si, fi in frames], G, n_rows=buckets.n_vertices,
                                           k=buckets.ell_k)
        stack = jep.stack_partitioned
    part = dict(zip(frames, ops))
    op = stack([part[(si, off + 1)] for si, off in picks], **floors)
    jb = jbat.arap_batch(seqs, picks, buckets, model="dirac" if model == "dir" else "lap", operator=op)
    jm = jarap.MODELS[model](layers=2)

    def loss_of(out, a):
        return jlosses.smooth_l1_sum(out * a["mask"], a["targets"], a["inputs"].shape[0])

    return _sharded_step(lambda p, o, mk, x: jm.apply({"params": p}, o, mk, x), jb.operator,
                         {"mask": jb.mask, "inputs": jb.inputs, "targets": jb.targets}, loss_of, params, 1e-5)


def _mnist_parts(model: str, data: list, buckets, keys):
    """Each sample's operators under ``keys`` partitioned once with
    dataset-wide halos and floors, as the JAX trainers partition them."""
    out = []
    for key in keys:
        if model == "dirac":
            ops, floors = jgp.prepartition_dirac([jbat._dirac_coeffs_of(s, key) for s in data], G, buckets.n_vertices,
                                                 buckets.n_faces, max_valence=buckets.max_valence)
            out.append((dict(zip(map(id, data), ops)), floors, jdp.stack_partitioned_dirac))
        else:
            ops, floors = jgp.prepartition_ell([s[key] for s in data], G, n_rows=buckets.n_vertices, k=buckets.ell_k)
            out.append((dict(zip(map(id, data), ops)), floors, jep.stack_partitioned))
    return out


def _stacked(parts, samples):
    return [stack([by_id[id(s)] for s in samples], **floors) for by_id, floors, stack in parts]


def _jax_mnist(case: str, inputs: np.ndarray, params):
    model = _flag(CASES[case][3], "--model")
    data, first, buckets = _mnist_data(model == "dirac", False)
    (op,) = _stacked(_mnist_parts(model, data, buckets, ["dirac" if model == "dirac" else "L"]), first)
    jb = jbat.mnist_batch(first, buckets, model=model, operator=op)
    np.testing.assert_array_equal(np.asarray(jb.inputs), inputs, err_msg="the first batch")
    jm = (jmnist.DirModel if model == "dirac" else jmnist.Model)(layers=_depth(case))
    targets = jnp.asarray(jb.targets)
    return _sharded_step(
        lambda p, o, mk, x: jm.apply({"params": p}, x, o, mk, deterministic=False,
                                     rngs={"dropout": jax.random.key(DROPOUT_KEY)}),
        jb.operator, {"mask": jb.mask, "inputs": jb.inputs}, lambda out, a: jlosses.nll_loss(out, targets), params,
        1e-5, out_rows=False)


def _jax_vae(case: str, inputs: np.ndarray, params):
    """The JAX trainer's graph-parallel VAE step: encoder and decoder in one
    ``shard_map``, the row outputs sharded and the latent statistics
    replicated."""
    model = _flag(CASES[case][3], "--model")
    data, first, buckets = _mnist_data(model == "dirac", True)
    keys = ["dirac", "flat_dirac"] if model == "dirac" else ["L", "flat_L"]
    op, fop = _stacked(_mnist_parts(model, data, buckets, keys), first)
    jb = jbat.vae_batch(first, buckets, model=model, operator=op, flat_operator=fop)
    np.testing.assert_array_equal(np.asarray(jb.inputs), inputs, err_msg="the first batch")
    jm = (JDirVAE if model == "dirac" else JLapVAE)(num_layers=_depth(case))
    mesh = _gmesh()
    row = P(None, "graph")

    def local(p, rng, x, fx, o, fo, mk):
        with jpc.sharded_axes(vertex_axis="graph"):
            return jm.apply({"params": p}, x, fx, o, fo, mk, rngs={"sample": rng})

    apply = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(), row, row, row, row, row),
                          out_specs=(row, row, P(), P(), P()))
    x, fx, mask = (jnp.asarray(np.asarray(a, np.float64)) for a in (jb.inputs, jb.aux["flat_inputs"], jb.mask))

    def objective(p):
        rm, rl, z, mu, lv = apply(p, jax.random.key(SAMPLE_KEY), x, fx, _tree(op), _tree(fop), mask)
        bce, kld = jlosses.vae_elbo_terms(rm, rl, mask, x, z, mu, lv)
        return bce + kld * KW

    loss, g = _value_and_grad(objective, params)
    return float(loss), state64(g), state64(_adam64(params, g, 1e-5))


def _rotation(txz: float, txy: float) -> np.ndarray:
    c1, s1, c2, s2 = np.cos(txz), np.sin(txz), np.cos(txy), np.sin(txy)
    rxz = np.array([[c1, 0, s1], [0, 1, 0], [-s1, 0, c1]])
    rxy = np.array([[c2, s2, 0], [-s2, c2, 0], [0, 0, 1]])
    return rxz @ rxy


def _jax_faust(case: str, r: dict, params):
    """JAX's graph-parallel trunk (``make_graph_sharded_apply`` of
    ``SiameseModel.trunk``) on both shapes, the logits of the gathered
    features and dcel against the pair's target (the worker's, the host
    argmin JAX's host path also takes); the BSR case on ELL interiors."""
    argv = CASES[case][3]
    model = _flag(argv, "--model")
    data, buckets = _faust_data(model, _flag(argv, "--operator-format") == "bsr")
    N = buckets.n_vertices
    ia, ib = (int(v) for v in r["pair"])
    rots = [float(v) for v in r["rots"]]
    jm = JSiameseModel(model=model, layers=2)
    mesh = _gmesh()
    trunk = jgp.make_graph_sharded_apply(mesh, lambda p, o, mk, x: jm.apply({"params": p}, o, mk, x,
                                                                          method=lambda m, o_, k, x_: m.trunk(o_, k, x_)))
    shapes = []
    for i, (txz, txy) in ((ia, rots[:2]), (ib, rots[2:])):
        s = data[i]
        if model == "dir":
            op = jgp.partition_batch_dirac([jnative.dirac_coeffs(s["V"], s["F"])], G, N, buckets.n_faces,
                                           max_valence=buckets.max_valence)
        else:
            halo = min(jep.suggest_halo(s["L"]), N // G)
            op = jgp.partition_batch_operator([s["L"]], G, n_rows=N, halo=halo, k=buckets.ell_k)
        jb = jbat.correspondence_batch(s, buckets, model="dirac" if model == "dir" else "lap", fmt="ell", operator=op)
        inputs = np.asarray(jb.inputs, np.float64) @ _rotation(txz, txy)
        shapes.append(jgp.place_graph_batch(mesh, op, {"mask": np.asarray(jb.mask, np.float64), "inputs": inputs}))
    target = jnp.asarray(r["target"])

    def objective(p):
        fa, fb = (trunk(p, o, a["mask"], a["inputs"]) for o, a in shapes)
        return jlosses.corr_delta_cross_entropy_from_target(jnp.einsum("bnc,bmc->bnm", fa, fb)[0], target)

    loss, g = _value_and_grad(objective, params)
    return float(loss), state64(g), state64(_adam64(params, g, 1e-5))


def hold_against_jax(case, runs):
    """The port's fp64 graph-parallel step against the JAX package's on the
    same batch and weights (on the conftest's virtual CPU devices, under
    ``enable_x64``): the loss, every gradient and the parameters after one
    Adam update within 1e-6."""
    r = runs(case)
    fam = _family(case)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), runs.params[case])
        if fam == "normal":
            loss, g, new = _jax_normal(case, [str(n) for n in r["names"]], p64)
        elif fam == "arap":
            loss, g, new = _jax_arap(case, [str(n) for n in r["names"]], p64)
        elif fam == "mnist":
            loss, g, new = _jax_mnist(case, r["inputs"], p64)
        elif fam == "vae":
            loss, g, new = _jax_vae(case, r["inputs"], p64)
        else:
            loss, g, new = _jax_faust(case, r, p64)
    def rel(a, b):
        return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-30))

    # the VAE: the port's single-device fp64 step itself lies up to 1.2e-6 (one leaf's gradient) and 3e-9 (the
    # loss) from JAX's on this batch; the sharded step may be no farther from JAX's than that, +1e-9.  The gap is
    # JAX's: its fp64 VAE step casts to fp32 inside (the encoder's pooled features before the latent heads, the
    # decoder's fc_mu output before the flat inputs are added, values and cotangents alike); with those casts
    # replayed in the port every leaf agrees to 6e-12 (tests/test_torch_vae.py::test_vae_fp64_step_leaf_by_leaf)
    vae = fam == "vae"
    grad_tol = {k: max(JAX_RTOL, rel(r[f"ref.g.{k}64"], g[k]) + FP64_GRAD) if vae else JAX_RTOL for k in _keys(r)}
    loss_tol = max(JAX_RTOL, rel(r["ref.loss64"], loss) + FP64_LOSS) if vae else JAX_RTOL
    assert_close(float(r["loss64"]), loss, loss_tol, f"{case}: loss")
    null, top = _bounds(case)[2], max(float(np.abs(v).max()) for v in g.values())
    for k in _keys(r):
        if k in null:  # zero in exact arithmetic
            assert max(np.abs(g[k]).max(), np.abs(r[f"g.{k}64"]).max()) <= NULL_ATOL * top, f"{case}: {k} not zero"
        else:
            assert_close(r[f"g.{k}64"], g[k], grad_tol[k], f"{case}: gradient {k}")
    _hold_update(r, new, g, state0(runs, case), case, lambda k: grad_tol[k], case)
