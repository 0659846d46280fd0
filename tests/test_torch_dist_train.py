"""The port's data-parallel and graph-parallel trainers on the CPU, held
against its single-device step and against the JAX package's DP/GP step.

The ranks run in ``tests/_torch_dist_worker.py`` (it imports only the
port): four gloo ranks started once for this file, every case on the first
ranks of that group, inputs and outputs through ``.npz`` files, the whole
run under a hard timeout that kills the ranks.  Cases: ``train_normal``
(LapDeepModel, 2 layers, batch 2, the fixture meshes) at ``--data-parallel
2``, ``--graph-parallel 2`` with ELL and BSR interiors, both on a 2 x 2
grid, ``--no-device-store`` beside the device store, a rank-local
batch-norm mutant; ``train_arap``, ``train_mnist`` and ``train_vae`` at
``--data-parallel 2`` (batch 4); ``train_normal --data-parallel 2
--rotate-augment`` on the device store (the rotations drawn for the global
batch and sliced; the host route refuses the flag, as JAX's does).  Each
rank takes one update on its shard
of the first global batch, in fp64 and in fp32; rank 0 also takes it alone
on the whole batch (for ``--graph-parallel``: the same RCM-ordered, padded
rows through the unpartitioned ELL operator).

Tolerances: fp64 against the single-device step, the loss to 1e-12 and
every gradient to 1e-9 relative to its largest element, the parameters
after one Adam update to 1e-9 absolute (the same sums in another order);
fp32, the loss to 3e-5 relative (measured at most 1.03e-5, the VAE's ELBO)
and every parameter within 2 x lr of the single-device one (Adam's first
step is +-lr wherever the gradient is far above its eps, so an element
whose fp32 gradient sits at rounding level may step either way).  Against
JAX (``make_dp_train_step``, ``make_graph_sharded_apply`` on the conftest's
virtual CPU devices, fp64 under ``enable_x64``): the loss, the gradients
and the parameters after optax's Adam to 1e-6.  JAX's BSR interior sums in
fp32 by design, so the BSR case is held against JAX's ELL-interior run on
the same rows.  The mesh-MNIST and VAE steps draw their dropout masks and
noise inside JAX's step; they are held to the port's single-device step,
which ``tests/test_torch_mnist.py`` and ``tests/test_torch_vae.py`` hold to
JAX's.  The rank-local batch-norm mutant must fail the single-device check.
"""

import json
import os
import pathlib
import random
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from surfacenetworks_tpu.cli import train_arap as jarap
from surfacenetworks_tpu.cli import train_normal as jnormal
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.dist import graph_parallel as jgp
from surfacenetworks_tpu.dist import edge_partition as jep
from surfacenetworks_tpu.dist import make_dp_train_step, make_mesh, replicate, shard_batch
from surfacenetworks_tpu.models import normal_models as jmodels
from surfacenetworks_tpu.train import TrainState
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.models import LapDeepModel
from surfacenetworks_tpu_torch.models import arap_models as tarap

from torch_parity import assert_close, perturbed_params, state64

REPO = pathlib.Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures"
WORKER = REPO / "tests" / "_torch_dist_worker.py"
LR = 1e-3
FP64_LOSS, FP64_GRAD, FP64_PARAM = 1e-12, 1e-9, 1e-9
FP32_LOSS, FP32_PARAM = 3e-5, 2 * LR
JAX_RTOL = 1e-6
WORKER_TIMEOUT_S = 150

NORMAL = ["--data-path", str(FIX / "objs"), "--layer", "2", "--batch-size", "2", "--num-updates", "1",
          "--num-epoch", "1", "--debug"]
ARAP = ["--data-path", str(FIX / "arap"), "--layer", "2", "--batch-size", "4", "--num-updates", "1", "--num-epoch", "1"]
MNIST = ["--data-path", str(FIX / "mnist_plus.np"), "--batch-size", "4", "--num-epoch", "1"]

CASES = {
    "normal_dp2": ("normal", 2, 1, NORMAL + ["--operator-format", "ell", "--data-parallel", "2"]),
    "normal_dp2_rotate": ("normal", 2, 1, NORMAL + ["--operator-format", "ell", "--data-parallel", "2",
                                                    "--rotate-augment"]),
    "normal_gp2_ell": ("normal", 1, 2, NORMAL + ["--graph-parallel", "2"]),
    "normal_gp2_bsr": ("normal", 1, 2, NORMAL + ["--graph-parallel", "2", "--operator-format", "bsr"]),
    "normal_dp2_gp2": ("normal", 2, 2, NORMAL + ["--graph-parallel", "2", "--data-parallel", "2"]),
    "arap_dp2": ("arap", 2, 1, ARAP + ["--data-parallel", "2"]),
    "mnist_dp2": ("mnist", 2, 1, MNIST + ["--layer", "2", "--data-parallel", "2"]),
    "vae_dp2": ("vae", 2, 1, MNIST + ["--num-layers", "2", "--data-parallel", "2"]),
}
EXTRA = {
    "normal_gp2_host": ("normal", 1, 2, CASES["normal_gp2_ell"][3] + ["--no-device-store"]),
    "normal_dp2_host": ("normal", 2, 1, CASES["normal_dp2"][3] + ["--no-device-store"]),
    "normal_dp2_local_bn": ("normal", 2, 1, CASES["normal_dp2"][3]),
}
JAX_CASES = ["normal_dp2", "normal_dp2_rotate", "normal_gp2_ell", "normal_gp2_bsr", "normal_dp2_gp2", "arap_dp2"]


def _normal_params():
    """Perturbed flax params of LapDeepModel-2 (the JAX tree) on a fixture batch."""
    args = jnormal.parser.parse_args(NORMAL)
    random.seed(args.seed)
    train, test = jnormal.load_samples(args, lambda _: None)
    b = jbat.BucketSet.for_samples(train + test, n_tiers=1).tiers[-1]
    jb = jbat.laplacian_batch(train[:2], b, fmt="ell")
    op = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    model = jmodels.LapDeepModel(3, 3, layers=2)
    return perturbed_params(model.init(jax.random.key(0), op, jnp.asarray(jb.mask), jnp.asarray(jb.inputs))["params"],
                            31)


def _arap_params():
    args = jarap.parser.parse_args(ARAP)
    seqs = jarap.load_sequences(args)
    b = jbat.Buckets.for_samples([{"V": s[0]["V"], "F": s[0]["F"]} for s in seqs])
    jb = jbat.arap_batch(seqs, [(0, 0)], b, model="lap", fmt="ell")
    op = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    model = jarap.MODELS["lap"](layers=2)
    return perturbed_params(model.init(jax.random.key(0), op, jnp.asarray(jb.mask), jnp.asarray(jb.inputs))["params"],
                            31), seqs, b


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    jparams = _normal_params()
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams), like=LapDeepModel(3, 3, layers=2))
    np.savez(tmp / "normal_state.npz", **{k: v.numpy() for k, v in state.items()})
    aparams, aseqs, abuckets = _arap_params()
    astate = params_from_flax(jax.tree_util.tree_map(np.asarray, aparams), like=tarap.MODELS["lap"](layers=2))
    np.savez(tmp / "arap_state.npz", **{k: v.numpy() for k, v in astate.items()})
    cases = []
    for name, (trainer, nd, ng, argv) in {**CASES, **EXTRA}.items():
        case = {"name": name, "trainer": trainer, "n_data": nd, "n_graph": ng, "argv": argv}
        if trainer in ("normal", "arap"):
            case["state"] = str(tmp / f"{trainer}_state.npz")
        if name.endswith("local_bn"):
            case["mutant"] = "local_bn"
        cases.append(case)
    _run_worker({"ranks": 4, "timeout": 60, "cases": cases}, tmp)

    def load(name, rank=0):
        return dict(np.load(tmp / f"{name}_r{rank}.npz"))

    load.jax = {"normal": jparams, "arap": (aparams, aseqs, abuckets)}
    return load


def _keys(r):
    return sorted(k[2:-2] for k in r if k.startswith("p.") and k.endswith("64"))


def _hold_single(r, what):
    assert abs(float(r["loss64"]) - float(r["ref.loss64"])) <= FP64_LOSS * abs(float(r["ref.loss64"])), what
    for k in _keys(r):
        assert_close(r[f"g.{k}64"], r[f"ref.g.{k}64"], FP64_GRAD, f"{what}: fp64 gradient {k}")
        np.testing.assert_allclose(r[f"p.{k}64"], r[f"ref.p.{k}64"], rtol=0, atol=FP64_PARAM,
                                   err_msg=f"{what}: fp64 parameter {k}")
        np.testing.assert_allclose(r[f"p.{k}32"], r[f"ref.p.{k}32"], rtol=0, atol=FP32_PARAM,
                                   err_msg=f"{what}: fp32 parameter {k}")
    assert abs(float(r["loss32"]) - float(r["ref.loss32"])) <= FP32_LOSS * abs(float(r["ref.loss32"])), what


@pytest.mark.parametrize("case", sorted(CASES))
def test_dist_step_matches_single_device(case, runs):
    """One update on every rank's shard equals the update alone on the whole
    batch (see the module docstring for the tolerances), and every rank of
    the grid holds the same parameters afterwards, bit for bit."""
    _, nd, ng, _ = CASES[case]
    r0 = runs(case)
    _hold_single(r0, case)
    for rank in range(1, nd * ng):
        rk = runs(case, rank)
        for k in _keys(r0):
            np.testing.assert_array_equal(rk[f"p.{k}64"], r0[f"p.{k}64"], err_msg=f"rank {rank} {k}")
            np.testing.assert_array_equal(rk[f"p.{k}32"], r0[f"p.{k}32"], err_msg=f"rank {rank} {k}")
        assert float(rk["loss32"]) == float(r0["loss32"])


def test_rank_local_batch_norm_is_refused(runs):
    """A data-parallel step whose batch norms take rank-local statistics
    computes another model: the single-device check refuses it."""
    r = runs("normal_dp2_local_bn")
    with pytest.raises(AssertionError):
        _hold_single(r, "rank-local batch norm")
    assert abs(float(r["loss64"]) - float(r["ref.loss64"])) > 1e-3 * abs(float(r["ref.loss64"]))


@pytest.mark.parametrize("pair", [("normal_gp2_host", "normal_gp2_ell"), ("normal_dp2_host", "normal_dp2")])
def test_device_store_and_host_routes_agree(pair, runs):
    """``--no-device-store`` (each batch built on the host, cut to the
    rank's shard and uploaded) gives the device store's step bit for bit."""
    a, b = runs(pair[0]), runs(pair[1])
    for key in [k for k in a if not k.startswith("ref.") and k != "names"]:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _adam64(params, grads, wd=0.0):
    tx = joptim.adam(LR, weight_decay=wd) if wd else joptim.adam(LR)
    upd, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, upd)


def _jax_normal(case, names, jparams, rotation=None):
    """JAX's DP or GP fp64 step on the batch ``names``: (loss, grads, new
    params) as ``state_dict`` keys; with ``rotation`` (``[B, 3, 3]``, the
    global batch's) the inputs and targets rotated first, as the JAX
    trainer's ``_maybe_rotate``."""
    _, nd, ng, argv = CASES[case]
    args = jnormal.parser.parse_args(argv)
    random.seed(args.seed)
    train, test = jnormal.load_samples(args, lambda _: None)
    gp = ng > 1
    interior = "bsr" if "bsr" in argv else "ell"
    if gp:
        train = [jbat.rcm_reorder_sample(s) for s in train]
        test = [jbat.rcm_reorder_sample(s) for s in test]
    multiple = (128 if interior == "bsr" else 8) * ng if gp else 8
    tier = jbat.BucketSet.for_samples(train + test, n_tiers=1, multiple=multiple).tiers[-1]
    by_name = {s["name"]: s for s in train}
    samples = [by_name[n] for n in names]
    model = jmodels.LapDeepModel(3, 3, layers=2)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jparams)
        if gp:
            # JAX's BSR interior sums in fp32 by design: its ELL interior on the same rows
            ops, floors = jgp.prepartition_ell([s["L"] for s in train + test], ng, n_rows=tier.n_vertices,
                                               k=tier.ell_k, interior_fmt="ell")
            pop = {s["name"]: o for s, o in zip(train + test, ops)}
            op = jep.stack_partitioned([pop[n] for n in names], **floors)
            jb = jbat.laplacian_batch(samples, tier, operator=op)
            mesh = make_mesh(n_data=nd, n_graph=ng, devices=jax.devices()[: nd * ng])
            batch_axis = "data" if nd > 1 else None
            apply = jgp.make_graph_sharded_apply(mesh, lambda p, o, mk, x: model.apply({"params": p}, o, mk, x),
                                                 batch_axis=batch_axis)
            arrs = {k: np.asarray(getattr(jb, k), np.float64) for k in ("mask", "inputs", "targets")}
            op_d, arrs = jgp.place_graph_batch(mesh, jb.operator, arrs, batch_axis=batch_axis)

            def objective(p):
                out = apply(p, op_d, arrs["mask"], arrs["inputs"])
                return jlosses.normal_cosine_loss(out, arrs["mask"], arrs["targets"])

            loss, g = jax.jit(jax.value_and_grad(objective))(p64)
            new = _adam64(p64, g)
        else:
            jb = jbat.laplacian_batch(samples, tier, fmt="ell")
            mesh = make_mesh(n_data=nd, n_graph=1, devices=jax.devices()[:nd])
            state = replicate(mesh, TrainState.create(p64, joptim.adam(LR)))

            def dp_apply(p, b):
                return model.apply({"params": p}, b["operator"], b["mask"], b["inputs"])

            def dp_loss(out, b):
                return jlosses.normal_cosine_loss(out, b["mask"], b["targets"]), {}

            arrs = {k: jnp.asarray(getattr(jb, k), jnp.float64) for k in ("mask", "inputs", "targets")}
            if rotation is not None:
                R = jnp.asarray(rotation, jnp.float64)
                arrs["inputs"] = jnp.einsum("bnc,bcd->bnd", arrs["inputs"], R)
                arrs["targets"] = jnp.einsum("bnc,bcd->bnd", arrs["targets"], R)
            b = shard_batch(mesh, {"operator": jax.tree_util.tree_map(jnp.asarray, jb.operator), **arrs})
            new_state, metrics = make_dp_train_step(dp_apply, dp_loss, mesh, donate=False)(state, b)
            loss, new = metrics["loss"], new_state.params
            g = jax.jit(jax.grad(lambda p: dp_loss(dp_apply(p, b), b)[0]))(p64)
        return float(loss), state64(g), state64(new)


def _jax_arap(names, jax_state):
    params, seqs, buckets = jax_state
    picks = [tuple(int(v) for v in n.strip("()").split(",")) for n in names]
    jb = jbat.arap_batch(seqs, picks, buckets, model="lap", fmt="ell")
    model = jarap.MODELS["lap"](layers=2)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        mesh = make_mesh(n_data=2, n_graph=1, devices=jax.devices()[:2])
        sched = joptim.epoch_halving_schedule(LR, 1, 50, 10)
        state = replicate(mesh, TrainState.create(p64, joptim.adam(sched, weight_decay=1e-5)))

        def dp_apply(p, b):
            out = model.apply({"params": p}, b["operator"], b["mask"], b["inputs"])
            return out * jnp.broadcast_to(b["mask"], out.shape)

        def dp_loss(out, b):
            return jlosses.smooth_l1_sum(out, b["targets"], b["inputs"].shape[0]), {}

        b = shard_batch(mesh, {"operator": jax.tree_util.tree_map(jnp.asarray, jb.operator),
                               **{k: jnp.asarray(getattr(jb, k), jnp.float64) for k in ("mask", "inputs", "targets")}})
        new_state, metrics = make_dp_train_step(dp_apply, dp_loss, mesh, donate=False)(state, b)
        g = jax.jit(jax.grad(lambda p: dp_loss(dp_apply(p, b), b)[0]))(p64)
        return float(metrics["loss"]), state64(g), state64(new_state.params)


@pytest.mark.parametrize("case", JAX_CASES)
def test_dist_step_matches_jax(case, runs):
    """The port's fp64 DP/GP step against the JAX package's DP/GP step on
    the same batch and weights (``make_dp_train_step`` /
    ``make_graph_sharded_apply`` over the virtual CPU devices, under
    ``enable_x64``): the loss, every gradient and the parameters after one
    Adam update within 1e-6.  ``--rotate-augment`` on the device store
    hands JAX's DP step the rotations the ranks drew (the global batch's;
    each rank rotates its slice)."""
    r = runs(case)
    names = [str(n) for n in r["names"]]
    if case.startswith("arap"):
        loss, g, new = _jax_arap(names, runs.jax["arap"])
    else:
        loss, g, new = _jax_normal(case, names, runs.jax["normal"], r.get("rotation"))
    assert_close(float(r["loss64"]), loss, JAX_RTOL, f"{case}: loss")
    for k in _keys(r):
        assert_close(r[f"g.{k}64"], g[k], JAX_RTOL, f"{case}: gradient {k}")
        assert_close(r[f"p.{k}64"], new[k], JAX_RTOL, f"{case}: parameter {k}")
