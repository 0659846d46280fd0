"""The FAUST trainer's trunks and the modules under them against the JAX
package on the CPU: the amp pyramid and the intrinsic Laplacian (exactly:
indices, values, flips), the sl1 and cel losses on a padded cost (value and
gradient), and the whole siamese step of each trunk the port added (amp,
avg, mlp, dir, and lap with ``--remat``) on the committed FAUST scans.

Each step is held as ``test_torch_train.test_siamese_step_matches_jax``
holds the lap trunk's: flax weights moved off init by seeded noise and
converted in; both packages in fp64 (JAX under ``enable_x64``): features,
objective (dcel over the full logits + 0.1 x both shapes' smoothness
terms), every gradient within 1e-6 of ``max|ref|``, and the port's parameters
after one Adam update within 1e-6 of optax's update of the same
gradients; the trainer's own fp32 ``update``: its objective
the objective, the features and every gradient no farther (relative
Frobenius) from the fp64 step than 2x JAX's own fp32
distance from it, plus 1e-6, each distance summed over three rotations of
the inputs (``ROTATIONS``), and the parameters after the update equal
optax's Adam of the port's gradients (3e-7 absolute).  The Mlp trunk's
biases before its last batch norm have a zero gradient in exact
arithmetic: those are held to 1e-12 of the largest gradient in fp64 and to
1e-4 of it in fp32."""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.geometry import intrinsic as jintrinsic
from surfacenetworks_tpu.models import SiameseModel as JSiameseModel
from surfacenetworks_tpu.sparse import stack_operators as jstack_operators
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.cli import train_correspondence as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import datasets as tdatasets
from surfacenetworks_tpu_torch.geometry import graph_ops as tgraph_ops
from surfacenetworks_tpu_torch.geometry import intrinsic as tintrinsic
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as torch_optim

from torch_parity import assert_close, hold_grads, perturbed_params, rel_fro, to_jax

RTOL = 1e-5
FP64_RTOL = 1e-6
ADAM_ATOL = 3e-7
NULL_FP32 = 1e-4
FAUST = pathlib.Path(__file__).parent / "fixtures" / "faust"


def _meshes():
    """A perturbed plane (a Delaunay triangulation of seeded points, z
    moved by seeded noise), a blob mesh with obtuse pairs, and a synthetic
    FAUST-like scan: (name, V, F)."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 1, size=(60, 2))
    V = np.concatenate([pts, 0.3 * rng.normal(size=(60, 1))], axis=1)
    plane = ("perturbed plane", V, np.asarray(Delaunay(pts).simplices, np.int32))
    blob = ("blob", *jdatasets.random_blob_mesh(np.random.default_rng(10), 120))
    scan = tdatasets.synthetic_correspondence_dataset(1, n_points=200, seed=3)[0]
    return [plane, blob, ("synthetic scan", scan["V"], scan["F"])]


def _same_csr(got, ref, what):
    got, ref = got.tocsr(), ref.tocsr()
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    np.testing.assert_array_equal(got.indptr, ref.indptr, err_msg=what)
    np.testing.assert_array_equal(got.indices, ref.indices, err_msg=what)
    np.testing.assert_array_equal(got.data, ref.data, err_msg=what)


@pytest.mark.parametrize("mesh", [0, 1, 2], ids=["plane", "blob", "scan"])
def test_intrinsic_laplacian_matches_jax(mesh):
    """The flipped faces, their intrinsic lengths and the flip count, and
    the Laplacian, bit for bit; the blob and the scan need flips."""
    name, V, F = _meshes()[mesh]
    jF, jL, jflips = jintrinsic.intrinsic_delaunay(V, F)
    tF, tL, tflips = tintrinsic.intrinsic_delaunay(V, F)
    assert tflips == jflips and (tflips > 0 or name == "perturbed plane"), (name, tflips, jflips)
    np.testing.assert_array_equal(tF, jF)
    np.testing.assert_array_equal(tL, jL)
    _same_csr(tintrinsic.intrinsic_laplacian(V, F), jintrinsic.intrinsic_laplacian(V, F), name)


@pytest.mark.parametrize("mesh", [1, 2], ids=["blob", "scan"])
def test_amp_pyramid_matches_jax(mesh):
    """Every level of the pyramid of the mesh's igl-style Laplacian, bit
    for bit (float32 throughout)."""
    name, V, F = _meshes()[mesh]
    L = jgeo.igl_style_laplacian(V, F, hack=1.0)
    got, ref = tgraph_ops.amp_pyramid(L, levels=3), jgeo.amp_pyramid(L, levels=3)
    assert len(got) == len(ref) == 3
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == np.float32
        _same_csr(g, r, f"{name} level {k}")


@pytest.mark.parametrize("loss", ["sl1", "cel"])
def test_corr_losses_match_jax(loss):
    """Value and gradient on a padded cost as the trainer builds it: 0 on
    rows past A's vertices, 1e9 on columns past B's; sl1's values near 1e9
    are summed in fp32, so it is held relative to its size."""
    rng = np.random.default_rng(21)
    N, na, nb = 96, 80, 72
    GAB = np.zeros((N, N), np.float32)
    GAB[:na, :nb] = rng.uniform(0, 3, size=(na, nb))
    GAB[:, nb:] = 1e9
    logits = rng.normal(scale=2.0, size=(N, N)).astype(np.float32)
    jfn, tfn = {"sl1": (jlosses.corr_smooth_l1, tlosses.corr_smooth_l1),
                "cel": (jlosses.corr_softmin_cross_entropy, tlosses.corr_softmin_cross_entropy)}[loss]
    jval, jgrad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(GAB)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    tval = tfn(t, torch.from_numpy(GAB))
    tval.backward()
    assert_close(tval.detach().numpy(), jval, RTOL, "value")
    assert_close(t.grad.numpy(), jgrad, RTOL, "gradient")


# trunk cases: (flags, layers); amp at 5 layers reaches its third level
TRUNK_CASES = {"amp": (["--model", "amp"], 5), "avg": (["--model", "avg"], 3), "mlp": (["--model", "mlp"], 3),
               "dir": (["--model", "dir"], 3), "lap remat": (["--remat"], 3)}


def jax_pair(key: str, dtype=None):
    """The JAX trainer's data for scans 0 and 1 under operator key ``key``
    in ELL (amp: the pyramid, every level at the widest row): batches,
    smoothness patterns and the pair's dcel target."""
    data = [jdatasets.load_faust_npz(str(p)) for p in sorted(FAUST.glob("*.npz"))]
    if key == "amp":
        for s in data:
            s["L_pyr"] = jgeo.amp_pyramid(s["L"], levels=3)
    buckets = jbat.Buckets.for_samples(data, multiple=8)
    if key == "amp":
        kmax = max(int(np.diff(Lk.tocsr().indptr).max()) for s in data for Lk in s["L_pyr"])
        buckets.ell_k = buckets.ell_k_t = max(buckets.ell_k, kmax)
    N = buckets.n_vertices
    batches = [jbat.correspondence_batch(s, buckets, model=key, fmt="ell", op_dtype=dtype) for s in data[:2]]
    regs = [jstack_operators([jbat._fixed_k_operator(s["L"], buckets, N)]) for s in data[:2]]
    (GA, lA, liA), (GB, lB, liB) = (b.targets for b in batches)
    agg = np.asarray(jlosses.aggregate_G(*(jnp.asarray(a) for a in (GA, lA, liA, GB, lB, liB))))
    GAB = np.zeros((N, N), np.float32)
    GAB[: agg.shape[0], : agg.shape[1]] = agg
    GAB[:, agg.shape[1]:] = 1e9
    return batches, regs, np.argmin(GAB, axis=-1).astype(np.int32)


def jops(batch):
    """A JAX batch's ``(operator, mask)`` as device arrays."""
    return jax.tree_util.tree_map(jnp.asarray, batch.operator), jnp.asarray(batch.mask)


def mlp_null(layers: int) -> set:
    """The Mlp trunk's parameters whose gradient is zero in exact
    arithmetic: per-channel constants that its batch norms remove."""
    return {"trunk.conv1.fc.bias"} | {f"trunk.rn{i}.fc{j}.fc.bias" for i in range(layers) for j in (0, 1)}


# the rotations (xz of A, xy of A, xz of B, xy of B) the fp32 step is held at
ROTATIONS = [(0.7, 0.0, 2.3, 0.0), (0.5, 0.0, 1.1, 0.0), (1.9, 0.0, 0.4, 0.0)]


def jax_step(jmodel, ops, jregs, head):
    """JAX's features, objective (``head(logits)`` + 0.1 x both smoothness
    terms) and gradient at ``(params, xa, xb)`` (the rotated inputs),
    jitted."""
    def run(p, xa, xb):
        def feats(q):
            return jmodel.apply({"params": q}, ops[0], ops[1], xa, xb, method=JSiameseModel.features)

        def obj(q):
            fa, fb = feats(q)
            loss = head(jnp.einsum("bnc,bmc->bnm", fa, fb)[0])
            return loss + 0.1 * (jlosses.corr_feature_smoothness(jregs[0], fa)
                                 + jlosses.corr_feature_smoothness(jregs[1], fb))

        loss, grads = jax.value_and_grad(obj)(p)
        return feats(p), loss, grads
    return jax.jit(run)


@pytest.mark.parametrize("case", list(TRUNK_CASES))
def test_trunk_step_matches_jax(case):
    """fp64 at the first of ROTATIONS; the fp32 objective, features and
    gradients at each of them, their distances from fp64 summed over the
    three: where ``L x`` or ``D x`` cancels on these scans, fp32 rounding
    is amplified to 1e-3-3e-2 of a gradient in both packages, and one
    draw's ratio of the two distances is a coin toss (the dir trunk's read
    2.55 at the first rotation and 0.29-1.12 at four others)."""
    check_step(*TRUNK_CASES[case])


def check_step(flags: list, layers: int, loss: str = "dcel", fp32_grads: bool = True) -> None:
    """The trainer (``flags``, ``layers``, ``--loss loss``, ELL, the full
    logits head, ``--smooth-reg 0.1``) on scans 0 and 1 against the JAX
    package's step, as the module docstring sets out; without
    ``fp32_grads`` the fp32 gradients are held finite and non-zero only."""
    argv = ["--datapath", str(FAUST), "--device", "cpu", "--layer", str(layers), "--operator-format", "ell",
            "--smooth-reg", "0.1", "--lr", "1e-3", "--num-updates", "1", "--num-epoch", "1", "--loss", loss,
            *flags]
    trainer = ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(argv), log=lambda _: None)
    assert not trainer.use_stream
    key = trainer.model_key
    batches, regs, target = jax_pair(key)
    np.testing.assert_array_equal(trainer.pair_target(0, 1).numpy(), target)
    GAB = trainer.aggregate_padded(trainer.dev_sample(0), trainer.dev_sample(1))
    if loss == "dcel":
        jhead = lambda lg: jlosses.corr_delta_cross_entropy_from_target(lg, jnp.asarray(target))
        tkw = {}
    else:
        jGAB = jnp.asarray(GAB.numpy())
        jhead = lambda lg: {"sl1": jlosses.corr_smooth_l1, "cel": jlosses.corr_softmin_cross_entropy}[loss](lg, jGAB)
        tkw = {"loss_fn": ttrain.LOSSES[loss], "GAB": GAB}
    da, db = trainer.dev_sample(0), trainer.dev_sample(1)
    if key == "amp":
        assert len(da["op"]) == 3 and all(o.fwd.k == trainer.buckets.ell_k for o in da["op"])
        assert trainer.buckets.ell_k > 16 and da["reg_op"].fwd.k == trainer.buckets.ell_k
    null = mlp_null(layers) if "mlp" in flags else set()

    jmodel = JSiameseModel(model=trainer.args.model, layers=layers, remat=trainer.args.remat)
    jops32 = [jops(b) for b in batches]
    x0 = jnp.asarray(batches[0].inputs)
    params = perturbed_params(jmodel.init(jax.random.key(0), jops32[0], jops32[0], x0, x0)["params"], 15)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    model64 = copy.deepcopy(trainer.model).double()
    jregs = [jax.tree_util.tree_map(jnp.asarray, r) for r in regs]

    def rotated(dtype, rots):
        return [np.asarray(b.inputs, np.float64 if dtype == torch.float64 else np.float32)
                @ ttrain.rot_matrix(rots[2 * i], rots[2 * i + 1], "cpu", dtype).numpy() for i, b in enumerate(batches)]

    def as_state(tree, like_dtype=np.float32):
        return {k: v.numpy().astype(like_dtype) for k, v in
                params_from_flax(jax.tree_util.tree_map(np.asarray, tree), like=trainer.model).items()}

    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        run64 = jax_step(jmodel, [(op, jnp.asarray(m, jnp.float64)) for op, m in jops32], jregs, jhead)
        ref64 = [run64(jp64, *(jnp.asarray(x) for x in rotated(torch.float64, r))) for r in ROTATIONS]
        (jfa64, jfb64), jloss64, jg64 = ref64[0]
        ref64 = [(np.asarray(fa), np.asarray(fb), float(l), as_state(g, np.float64)) for (fa, fb), l, g in ref64]
    d64 = [{**d, "inputs": d["inputs"].double(), "mask": d["mask"].double()} for d in (da, db)]
    with torch.no_grad():
        rm64 = [ttrain.rot_matrix(ROTATIONS[0][2 * i], ROTATIONS[0][2 * i + 1], "cpu", torch.float64)
                for i in range(2)]
        tfa64, tfb64 = model64.features(*((d["op"], d["mask"]) for d in d64),
                                        *(d["inputs"] @ R for d, R in zip(d64, rm64)))
    assert_close(tfa64.numpy(), jfa64, FP64_RTOL, "fp64 features A")
    assert_close(tfb64.numpy(), jfb64, FP64_RTOL, "fp64 features B")
    opt64 = torch_optim.adam(model64.parameters(), 1e-3, weight_decay=1e-5)
    kw64 = {k: (v.double() if k == "GAB" else v) for k, v in tkw.items()}
    loss64 = ttrain.train_step(model64, opt64, d64[0], d64[1], ROTATIONS[0], trainer.pair_target(0, 1), 0.1, False,
                               **kw64)
    assert_close(loss64.numpy(), jloss64, FP64_RTOL, "fp64 objective")
    g64 = {k: p.grad.numpy() for k, p in model64.named_parameters()}
    hold_grads(g64, ref64[0][3], FP64_RTOL, null, "fp64 grad")
    # Adam's first step is lr g / (|g| + 1e-8): where |g| nears 1e-8 it
    # magnifies a gradient's last bits, so it is held on the port's own
    # gradients, which are held above
    opt = joptim.adam(1e-3, weight_decay=1e-5)
    with jax.enable_x64(True):
        p64 = {k: jnp.asarray(v, jnp.float64) for k, v in state.items()}
        upd, _ = opt.update({k: jnp.asarray(v) for k, v in g64.items()}, opt.init(p64), p64)
        new64 = optax.apply_updates(p64, upd)
    for k, p in model64.named_parameters():
        assert_close(p.detach().numpy(), np.asarray(new64[k]), FP64_RTOL, f"fp64 after Adam {k}")

    # fp32: each rotation's features and gradients, the trainer's own update at the first
    run32 = jax_step(jmodel, jops32, jregs, jhead)
    dist = {"port": {}, "jax": {}}
    for r, rots in reversed(list(enumerate(ROTATIONS))):
        (jfa, jfb), jloss, jg = run32(to_jax(params), *(jnp.asarray(x) for x in rotated(torch.float32, rots)))
        jg = as_state(jg)
        with torch.no_grad():
            rm = [ttrain.rot_matrix(rots[2 * i], rots[2 * i + 1], "cpu") for i in range(2)]
            tfa, tfb = trainer.model.features((da["op"], da["mask"]), (db["op"], db["mask"]),
                                              da["inputs"] @ rm[0], db["inputs"] @ rm[1])
        if r == 0:
            loss = trainer.update(0, 1, rots)
        else:
            trainer.model.zero_grad(set_to_none=True)
            loss = ttrain.objective(trainer.model, da, db, rots, trainer.pair_target(0, 1), 0.1, False, **tkw)
            loss.backward()
        tg = {k: p.grad.numpy().copy() for k, p in trainer.model.named_parameters()}
        fa64, fb64, loss64, g64 = ref64[r]
        held = [k for k in tg if k not in null] if fp32_grads else []
        for name, got, ref in (("objective", (float(loss.detach()), float(jloss)), loss64),
                               ("features A", (tfa, jfa), fa64), ("features B", (tfb, jfb), fb64),
                               *((k, (tg[k], jg[k]), g64[k]) for k in held)):
            for who, val in zip(("port", "jax"), got):
                dist[who][name] = dist[who].get(name, 0.0) + rel_fro(val, ref)
        top = max(float(np.linalg.norm(g)) for g in g64.values())
        for k, g in tg.items():
            assert np.isfinite(g).all(), k
            if k in null:
                assert np.linalg.norm(g) <= NULL_FP32 * top, f"fp32 grad {k}: {np.linalg.norm(g):.3e}, not zero"
            else:
                assert (g != 0).any(), f"{k}: no gradient"
    for name, d in dist["port"].items():
        bound = 2 * dist["jax"][name] + 1e-6
        assert d <= bound, f"fp32 {name}: {d:.3e} from fp64 over {len(ROTATIONS)} rotations > {bound:.3e}"
    opt = joptim.adam(1e-3, weight_decay=1e-5)
    upd, _ = opt.update(to_jax(tg), opt.init(to_jax(state)), to_jax(state))
    new = optax.apply_updates(to_jax(state), upd)
    for k, p in trainer.model.named_parameters():
        err = float(np.abs(p.detach().numpy() - np.asarray(new[k])).max())
        assert err <= ADAM_ATOL, f"{k}: after one Adam update max|err|={err:.3e}"
