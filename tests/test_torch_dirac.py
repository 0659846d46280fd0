"""The port's Dirac family against the JAX package on the CPU: the Dirac
coefficients and the scipy pair, the packed and unpacked tables, the
structured applies and their backwards, the packed-valence overflow added by
a gather, ``DirResNet2``, ``DirDeepModel`` and ``DirModelToFace``, Dirac
batches and the device dataset, Dirac ``.npz`` samples read without the JAX
package, and the normal trainer with ``--model dirac`` on
``tests/fixtures/objs``.

Tolerances, stated per case: host tables and batches exact (the same NumPy
code); applies in fp64 within 1e-10 of ``max|ref|``, in fp32 each element
within 1e-5 of its own ``sum |q| |x|`` (the terms summed there, which cancel
where the areas are small); models in fp64 within 1e-8 of ``max|ref|``
(JAX under ``enable_x64``); the trainer's fp64 step within 1e-6 and its fp32
loss within 1e-4 of JAX's."""

import copy
import json
import pathlib
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu import native as jnative
from surfacenetworks_tpu import sparse as jsps
from surfacenetworks_tpu.cli import preprocess as jpreprocess
from surfacenetworks_tpu.cli import train_normal as jtrain
from surfacenetworks_tpu.cli.common import EpochSampler as JEpochSampler
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.models import normal_models as jmodels
from surfacenetworks_tpu.nn import blocks as jblocks
from surfacenetworks_tpu.train import checkpoint as jckpt
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch import geometry as tgeo
from surfacenetworks_tpu_torch import sparse as tsps
from surfacenetworks_tpu_torch.cli import train_normal as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import batching as tbat
from surfacenetworks_tpu_torch.data import datasets as tdatasets
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples
from surfacenetworks_tpu_torch.models import normal_models as tmodels
from surfacenetworks_tpu_torch.nn import blocks as tblocks
from surfacenetworks_tpu_torch.sparse import ops as tops
from surfacenetworks_tpu_torch.train import optim as toptim

from torch_parity import assert_close, perturbed_params, to_jax

OBJS = pathlib.Path(__file__).parent / "fixtures" / "objs"
FP64_RTOL = 1e-10  # applies in fp64, of max|ref|
ELEM_RTOL = 1e-5  # applies in fp32, of each element's sum |q| |x|
SCIPY_RTOL = 1e-6  # fp64 applies against the scipy pair, of each element's sum (DiA rounds to fp32)
MODEL_RTOL = 1e-8  # models in fp64
# DirDeepModel's head is ELU(conv2(v) in fp32) in both packages (JAX's
# ``astype(float32)``): the two libraries' fp32 ELUs differ by an ulp, and
# every gradient flows back through that fp32 cotangent (measured at most
# 1.8e-8 of max|ref|).
HEAD_FP32_RTOL = 1e-7
STEP_FP64_RTOL = 1e-6
STEP_FP32_RTOL = 1e-4
TABLES = ("faces", "q_fv", "vf_face", "q_vf", "q_bwd_v", "q_bwd_f", "ov_rows", "ov_face", "q_ov_vf", "q_ov_bwd_v")


def _objs():
    return sorted(str(p) for p in OBJS.rglob("*.obj"))


def _mesh(kind: str):
    """float64 vertices and faces: a fixture mesh or a seeded blob."""
    if kind == "fixture":
        return jgeo.load_obj(_objs()[5])
    n = {"blob60": 60, "blob150": 150}[kind]
    return jdatasets.random_blob_mesh(np.random.default_rng(n), n)


def _same_coeffs(got, ref) -> None:
    for f in ("F", "q_fv", "vf_face", "vf_corner", "q_vf", "q_bwd_v", "q_bwd_f"):
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.n_vertices, got.n_faces) == (ref.n_vertices, ref.n_faces)


def _same_tables(got: tsps.DiracOperator, ref) -> None:
    for f in TABLES:
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("kind", ["fixture", "blob60", "blob150"])
def test_dirac_coeffs_pair_and_tables_match_jax(kind):
    """``dirac_coeffs`` against the JAX package's NumPy version and its
    native C++ one, ``dirac`` (both matrices), and the padded tables of
    ``dirac_from_coeffs`` unpacked and packed (the bucket's packing, and a
    tight one), alone and stacked: all exact."""
    V, F = _mesh(kind)
    c = tgeo.dirac_coeffs(V, F)
    _same_coeffs(c, jgeo.dirac_coeffs(V, F))
    _same_coeffs(c, jnative.dirac_coeffs(V, F))
    for got, ref in zip(tgeo.dirac(V, F), jgeo.dirac(V, F)):
        assert (got != ref).nnz == 0 and got.shape == ref.shape
    n, m = V.shape[0], F.shape[0]
    base, ov = tbat._dirac_packing([{"F": F}])
    assert (base, ov) == jbat._dirac_packing([{"F": F}])
    for kw in ({}, {"base_valence": base, "n_overflow": ov}, {"base_valence": 4}):
        t = tsps.dirac_from_coeffs(c, n_vertices=n + 6, n_faces=m + 4, max_valence=16, **kw)
        j = jsps.dirac_from_coeffs(jgeo.dirac_coeffs(V, F), n_vertices=n + 6, n_faces=m + 4, max_valence=16, **kw)
        _same_tables(t, j)
        assert (t.ov_map is None) == (kw == {})
        _same_tables(tsps.stack_dirac([t, t]), jsps.stack_dirac([j, j]))


def test_packing_and_buckets_match_jax():
    """``_dirac_packing`` and ``Buckets.for_samples`` over the fixture
    meshes, the blobs and a mix, at multiples 8 and 128."""
    fixtures = [{"V": v, "F": f} for v, f in map(jgeo.load_obj, _objs())]
    blobs = [dict(zip("VF", _mesh(k))) for k in ("blob60", "blob150")]
    for samples in (fixtures, blobs, fixtures + blobs):
        assert tbat._dirac_packing(samples) == jbat._dirac_packing(samples)
        for multiple in (8, 128):
            t, j = tbat.Buckets.for_samples(samples, multiple), jbat.Buckets.for_samples(samples, multiple)
            for f in ("n_vertices", "n_faces", "max_valence", "dirac_base_valence", "dirac_overflow"):
                assert getattr(t, f) == getattr(j, f), f
            assert t.dirac_kwargs() == j.dirac_kwargs()


def test_quaternion_algebra_matches_jax():
    """The applies' slot contraction (``_gather_apply``: one gather of every
    slot, one product with ``L(q)``) against ``quaternion_matrix`` and the
    JAX package's ``quaternion_mul`` summed over the slots (fp64, 1e-12 of
    max|ref|), batched and not."""
    rng = np.random.default_rng(5)
    B, R, S, N, C = 2, 7, 3, 9, 24
    idx = rng.integers(0, N, size=(B, R, S))
    q, x = rng.normal(size=(B, R, S, 4)), rng.normal(size=(B, N, C))
    g = np.stack([x[b][idx[b]] for b in range(B)]).reshape(B, R, S, 4, C // 4)
    got = tops._gather_apply(torch.from_numpy(idx), torch.from_numpy(q), torch.from_numpy(x)).numpy()
    ref = np.einsum("brsij,brsjc->bric", tgeo.quaternion_matrix(q), g).reshape(B, R, C)
    assert_close(got, ref, 1e-12, "_gather_apply vs quaternion_matrix")
    with jax.enable_x64(True):
        jref = np.asarray(jsps.quaternion_mul(jnp.asarray(q), jnp.asarray(g)).sum(axis=2)).reshape(B, R, C)
    assert_close(got, jref, 1e-12, "_gather_apply vs the JAX quaternion_mul")
    one = tops._gather_apply(torch.from_numpy(idx[0]), torch.from_numpy(q[0]), torch.from_numpy(x[0])).numpy()
    assert_close(one, ref[0], 1e-12, "_gather_apply unbatched")


def _batched_ops(packed: bool):
    """Two meshes of different size in one 160 x 310 bucket, with each
    package's tables, and the scipy pairs (float64 coefficients)."""
    meshes = [_mesh("blob60"), _mesh("blob150")]
    kw = {"base_valence": 4, "n_overflow": 152} if packed else {}
    t = tsps.stack_dirac([tsps.dirac_from_coeffs(tgeo.dirac_coeffs(V, F), 160, 310, 16, **kw) for V, F in meshes])
    j = jsps.stack_dirac([jsps.dirac_from_coeffs(jgeo.dirac_coeffs(V, F), 160, 310, 16, **kw) for V, F in meshes])
    return meshes, t, jax.tree_util.tree_map(jnp.asarray, j), [tgeo.dirac(V, F) for V, F in meshes]


def _quaternion_apply(M, x: np.ndarray) -> np.ndarray:
    """A scipy Dirac matrix ``[4R, 4S]`` on ``x [S, C]`` in quaternion layout."""
    return (M @ x.reshape(-1, x.shape[-1] // 4)).reshape(-1, x.shape[-1])


def _elementwise(got, ref, scale, rtol, what):
    err = np.abs(np.asarray(got, np.float64) - ref)
    worst = float((err / (scale + 1e-300)).max())
    assert np.all(err <= rtol * scale + 1e-30), f"{what}: worst error {worst:.3e} of sum |q| |x|"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("packed", [False, True])
def test_dirac_applies_match_jax(packed, dtype):
    """``dirac_apply_vf`` and ``dirac_apply_fv`` on a padded batch of two
    meshes, forward and gradient, against ``jax.vjp`` of the JAX package's
    functions: fp64 within 1e-10 of ``max|ref|``, fp32 each element within
    1e-5 of its own ``sum |q| |x|``.  In fp64 also against the scipy pair:
    ``Di``, ``Di^T`` exactly to 1e-10, ``DiA``, ``DiA^T`` within 1e-6 of
    each element's sum (the pair's DiA is area-rescaled in fp64, the tables
    in fp32).  Padded rows are zero."""
    meshes, top, jop, pairs = _batched_ops(packed)
    rng = np.random.default_rng(7)
    C = 16
    for side, tfn, jfn, n_in, n_out in (("vf", tsps.dirac_apply_vf, jsps.dirac_apply_vf, 160, 310),
                                        ("fv", tsps.dirac_apply_fv, jsps.dirac_apply_fv, 310, 160)):
        x = rng.normal(size=(2, n_in, C)).astype(dtype)
        w = rng.normal(size=(2, n_out, C)).astype(dtype)
        xt = torch.from_numpy(x).requires_grad_()
        y = tfn(top, xt)
        y.backward(torch.from_numpy(w))
        with jax.enable_x64(dtype == "float64"):
            jy, jg = jax.jit(lambda a, c: (lambda y, vjp: (y, vjp(c)[0]))(*jax.vjp(lambda b: jfn(jop, b), a)))(
                jnp.asarray(x), jnp.asarray(w))
            jy, jg = np.asarray(jy), np.asarray(jg)
        got_y, got_g = y.detach().numpy(), xt.grad.numpy()
        assert got_y.dtype == np.dtype(dtype) and got_g.dtype == np.dtype(dtype)
        for b, (V, F) in enumerate(meshes):
            n, m = V.shape[0], F.shape[0]
            D = pairs[b][0] if side == "vf" else pairs[b][1]
            rows_in, rows_out = (n, m) if side == "vf" else (m, n)
            assert not got_y[b, rows_out:].any() and not got_g[b, rows_in:].any()
            x64, w64 = x[b, :rows_in].astype(np.float64), w[b, :rows_out].astype(np.float64)
            absD = abs(D)
            fwd_scale = _quaternion_apply(absD, np.abs(x64))
            bwd_scale = _quaternion_apply(absD.T.tocsr(), np.abs(w64))
            if dtype == "float64":
                assert_close(got_y[b], jy[b], FP64_RTOL, f"{side} forward, mesh {b}")
                assert_close(got_g[b], jg[b], FP64_RTOL, f"{side} gradient, mesh {b}")
                rtol = FP64_RTOL if side == "vf" else SCIPY_RTOL
                _elementwise(got_y[b, :rows_out], _quaternion_apply(D, x64), fwd_scale, rtol, f"{side} vs scipy")
                _elementwise(got_g[b, :rows_in], _quaternion_apply(D.T.tocsr(), w64), bwd_scale, rtol,
                             f"{side} gradient vs scipy")
            else:
                _elementwise(got_y[b, :rows_out], jy[b, :rows_out], fwd_scale, ELEM_RTOL, f"{side} forward")
                _elementwise(got_g[b, :rows_in], jg[b, :rows_in], bwd_scale, ELEM_RTOL, f"{side} gradient")


def test_overflow_gather_reproduces_scatter_add():
    """The determinism mutant: the packed vertex side adds the overflow by a
    gather over ``ov_map``; it must equal the JAX package's
    ``out.at[ov_rows].add(o)`` (here ``index_add_`` on the CPU) bit for
    bit, with vertex 0 an overflow row and padded overflow rows, which
    point at row 0 and add zeros."""
    V, F = _mesh("blob150")
    op = tsps.stack_dirac([tsps.dirac_from_coeffs(tgeo.dirac_coeffs(V, F), 160, 310, 16, base_valence=4,
                                                  n_overflow=152)])
    n_real = int((op.ov_map[0] < 152).sum())
    assert op.ov_rows[0, 0] == 0 and n_real < 152 and (op.ov_rows[0, n_real:] == 0).all()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 310, 16)))
    main = tops._gather_apply(op.vf_face, op.q_vf, x)
    o = tops._gather_apply(op.ov_face, op.q_ov_vf, x)
    assert not o[0, n_real:].any()
    ref = main[0].clone().index_add_(0, op.ov_rows[0].long(), o[0])
    got = tops._vertex_side(op, op.q_vf, op.q_ov_vf, x)[0]
    assert torch.equal(got, ref)
    assert not torch.equal(main[0], ref)  # the overflow carries terms


def _state64(tree) -> dict:
    """A flax tree as ``state_dict`` keys with its values kept in fp64
    (``params_from_flax`` stores fp32)."""
    out = {}
    for key, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [k.key for k in key]
        arr = np.asarray(leaf, np.float64)
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[names[-1]]
        out[".".join(names[:-1] + [name])] = arr.T if names[-1] == "kernel" else arr
    return out


def _null_grads(case: str, layers: int) -> set:
    """Parameters whose gradient is zero in exact arithmetic: the last
    block's two output biases (its batch norm's and its Linear's) when
    conv2's 'pre' batch norm takes its output (a per-channel constant, which
    that norm subtracts), and in DirModelToFace the last Dirac block's
    vertex half, whose output nothing reads."""
    last = f"rn{layers - 1}.bn_fc1"
    if case.startswith("DirDeepModel"):
        return {f"{last}.fc.bias", f"{last}.bn.bias"}
    if case == "DirModelToFace":
        return {f"{last}.{p}" for p in ("fc.weight", "fc.bias", "bn.weight", "bn.bias")}
    return set()


def _hold_grads(got: dict, ref: dict, rtol: float, null: set, what: str) -> None:
    """Each gradient within ``rtol`` of its ``max|ref|``; those in ``null``
    at rounding level (1e-12 of the largest gradient) in both, a missing
    gradient counting as zero."""
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        g = np.zeros_like(r) if got[k] is None else got[k]
        if k in null:
            assert max(np.abs(r).max(), np.abs(g).max()) <= 1e-12 * top, f"{what} {k}: not zero"
        else:
            assert np.isfinite(g).all() and (g != 0).any(), f"{what} {k}: no gradient"
            assert_close(g, r, rtol, f"{what} {k}")


def _jax_params(jmod, *args, seed):
    return perturbed_params(jax.jit(jmod.init)(jax.random.key(0), *args)["params"], seed)


def _dirac_samples(n_points=(60, 90)):
    """Seeded blob samples with the port's coefficients of the float64
    vertices (``dirac``) and the JAX package's (``jax_dirac``)."""
    out = []
    for k, n in enumerate(n_points):
        V, F = jdatasets.random_blob_mesh(np.random.default_rng(100 + k), n)
        out.append({"V": V.astype(np.float32), "F": F, "input": V.astype(np.float32),
                    "target": jgeo.vertex_normals(V, F).astype(np.float32), "dirac": tgeo.dirac_coeffs(V, F),
                    "jax_dirac": jgeo.dirac_coeffs(V, F), "name": f"m{k}"})
    return out


def _jax_sample(s):
    out = {k: v for k, v in s.items() if k != "jax_dirac"}
    out["dirac"] = s["jax_dirac"]
    return out


def _grads64(tmod, targs, weights):
    """fp64 forward of ``tmod`` on ``targs`` (tensors require grad) and the
    gradients of ``sum(out * w)`` for params and inputs."""
    outs = tmod(*targs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.double() * torch.from_numpy(w)).sum() for o, w in zip(outs, weights))
    loss.backward()
    return [o.detach().numpy() for o in outs], {k: None if p.grad is None else p.grad.numpy()
                                                for k, p in tmod.named_parameters()}


@pytest.mark.parametrize("case", ["DirResNet2", "DirDeepModel", "DirDeepModel_dense", "DirModelToFace"])
def test_dirac_models_match_jax(case):
    """Forward and every gradient in fp64 within 1e-8 of ``max|ref|`` (the
    gradients of DirDeepModel, whose head is fp32 in both packages, within
    ``HEAD_FP32_RTOL``): the block, the 3-layer models on the structured
    tables of two padded meshes, and DirDeepModel on the dense pair; flax
    params moved off init by seeded noise, converted by
    ``params_from_flax(like=)``."""
    samples = _dirac_samples()
    buckets = tbat.Buckets.for_samples(samples)
    fmt = "dense" if case.endswith("dense") else "structured"
    tb = tbat.dirac_batch(samples, buckets, fmt=fmt)
    jb = jbat.dirac_batch([_jax_sample(s) for s in samples], jbat.Buckets.for_samples(samples), fmt=fmt)
    jop = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    top = tb.operator
    rng = np.random.default_rng(9)
    N, M = buckets.n_vertices, buckets.n_faces
    if case == "DirResNet2":
        jmod, tmod = jblocks.DirResNet2(8), tblocks.DirResNet2(8)
        v, f = rng.normal(size=(2, N, 8)), rng.normal(size=(2, M, 8))
        jargs = lambda dt: (jop, jnp.asarray(v, dt), jnp.asarray(f, dt))
        targs = [top, torch.from_numpy(v).requires_grad_(), torch.from_numpy(f).requires_grad_()]
        weights = [rng.normal(size=(2, N, 8)), rng.normal(size=(2, M, 8))]
    else:
        cls = case.split("_")[0]
        jmod, tmod = getattr(jmodels, cls)(3, 3, 3), getattr(tmodels, cls)(3, 3, 3)
        x, mask = tb.inputs.numpy().astype(np.float64), tb.mask.numpy().astype(np.float64)
        jargs = lambda dt: (jop, jnp.asarray(mask, dt), jnp.asarray(x, dt))
        targs = [top, torch.from_numpy(mask), torch.from_numpy(x).requires_grad_()]
        weights = [rng.normal(size=(2, M if cls == "DirModelToFace" else N, 3))]
    params = _jax_params(jmod, *jargs(jnp.float32), seed=11)
    tmod.load_state_dict(params_from_flax(params, like=tmod), strict=True)
    tmod.double()
    outs, grads = _grads64(tmod, targs, weights)
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)

        def objective(p, *inputs):
            a = jargs(jnp.float64)
            a = (a[0],) + inputs if case == "DirResNet2" else (a[0], a[1], inputs[0])
            o = jmod.apply({"params": p}, *a)
            o = o if isinstance(o, tuple) else (o,)
            return sum(jnp.sum(oo.astype(jnp.float64) * w) for oo, w in zip(o, weights)), o

        diff = (1, 2) if case == "DirResNet2" else (1,)
        inputs = jargs(jnp.float64)[1:] if case == "DirResNet2" else (jargs(jnp.float64)[2],)
        (_, jouts), jgrads = jax.jit(jax.value_and_grad(objective, argnums=(0,) + diff, has_aux=True))(jp, *inputs)
        jparams = _state64(jgrads[0])
        jin = [np.asarray(g) for g in jgrads[1:]]
    for k, (o, jo) in enumerate(zip(outs, jouts)):
        assert_close(o, jo, MODEL_RTOL, f"{case} output {k}")
    grad_rtol = HEAD_FP32_RTOL if case.startswith("DirDeepModel") else MODEL_RTOL
    assert all(v.dtype == np.float64 for v in jparams.values())
    _hold_grads(grads, jparams, grad_rtol, _null_grads(case, 3), f"{case} gradient")
    tin = [t.grad.numpy() for t in targs if isinstance(t, torch.Tensor) and t.requires_grad]
    for k, (g, jg) in enumerate(zip(tin, jin)):
        assert_close(g, jg, grad_rtol, f"{case} input gradient {k}")


@pytest.mark.parametrize("fmt", ["structured", "dense"])
def test_dirac_batch_and_device_store_match_jax(fmt):
    """``dirac_batch`` on two padded samples without coefficients (so both
    packages compute them from the float32 vertices) and with them: inputs,
    targets, mask, faces and the operator equal the JAX package's; the
    device dataset's index gather gives the host batch."""
    samples = _dirac_samples()
    bare = [{k: v for k, v in s.items() if k not in ("dirac", "jax_dirac")} for s in samples]
    for tsamples, jsamples in ((bare, bare), (samples, [_jax_sample(s) for s in samples])):
        buckets = tbat.Buckets.for_samples(tsamples, 128)
        tb = tbat.dirac_batch(tsamples, buckets, fmt=fmt)
        jb = jbat.dirac_batch(jsamples, jbat.Buckets.for_samples(jsamples, 128), fmt=fmt)
        for k in ("inputs", "targets", "mask", "faces"):
            np.testing.assert_array_equal(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
        assert tb.names == jb.names
        if fmt == "dense":
            for a, b in zip(tb.operator, jb.operator):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _same_tables(tb.operator, jb.operator)
    packed = PackedSamples(lambda s: tbat.dirac_batch([s], buckets, fmt=fmt))
    store = DeviceDataset.build(tsamples, packed, "cpu")
    host = packed.batch(tsamples[::-1])
    dev = store.batch(tsamples[::-1]).gather()
    assert dev.names == host.names
    flat = lambda op: list(op) if fmt == "dense" else [getattr(op, f) for f in TABLES + ("ov_map",)]
    for a, b in zip([dev.inputs, dev.targets, dev.mask] + flat(dev.operator),
                    [host.inputs, host.targets, host.mask] + flat(host.operator)):
        assert (a is None and b is None) or torch.equal(a, b)
    if fmt == "dense":  # in fp64 from float64 vertices: the scipy pair itself, padded with zeros
        V, F = _mesh("blob60")
        pair = tbat.dense_dirac_pair([{"V": V, "F": F}], V.shape[0] + 3, F.shape[0] + 5, torch.float64)
        for got, ref in zip(pair, tgeo.dirac(V, F)):
            want = np.zeros(got.shape[1:])
            want[: ref.shape[0], : ref.shape[1]] = ref.toarray()
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got[0].numpy(), want)


def test_load_normal_npz_reads_jax_dirac_samples(tmp_path):
    """The JAX package's ``cli.preprocess normal --operator dirac`` output:
    the port reads each sample's pickled coefficients into its own
    ``DiracCoeffs`` (with the JAX package and jax refused by the isolation
    test) and they equal the JAX package's; a member naming any other
    global is refused before it is called."""
    out = tmp_path / "npz"
    jpreprocess.main(["normal", "--data-path", str(OBJS), "--out", str(out), "--operator", "dirac", "--workers", "1"])
    files = tdatasets.scan_mesh_tree(str(out))
    assert len(files) == len(_objs())
    for f in files:
        got, ref = tdatasets.load_normal_npz(f), jdatasets.load_normal_npz(f)
        assert isinstance(got["dirac"], tgeo.DiracCoeffs) and "L" not in got
        _same_coeffs(got["dirac"], ref["dirac"])
        for k in ("V", "F", "input", "target"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    class Evil:
        def __reduce__(self):
            return (print, ("ran",))

    bad = tmp_path / "bad.npz"
    np.savez(bad, V=np.zeros((3, 3)), F=np.zeros((1, 3), np.int32), target=np.zeros((3, 3)),
             dirac=np.asarray(Evil(), dtype=object))
    with pytest.raises(pickle.UnpicklingError, match="refused global builtins.print"):
        tdatasets.load_normal_npz(str(bad))


def _argv(tmp_path, *extra):
    return ["--data-path", str(OBJS), "--model", "dirac", "--layer", "2", "--batch-size", "2",
            "--num-updates", "1", "--num-epoch", "1", "--result-dir", str(tmp_path), *extra]


def _jax_split(argv):
    jargs = jtrain.parser.parse_args(argv)
    random.seed(jargs.seed)
    train, test = jtrain.load_samples(jargs, lambda _: None)
    multiple = 128 if jargs.operator_format == "bsr" else 8
    return train, test, jbat.BucketSet.for_samples(train + test, n_tiers=1, multiple=multiple).tiers[-1]


def _names(samples):
    return [s["name"] for s in samples]


@pytest.mark.parametrize("fmt", ["auto", "bsr"])
def test_dirac_trainer_keeps_vertex_order_and_rounds_buckets(fmt, tmp_path):
    """With ``--model dirac`` the format flag resolves nothing and reorders
    nothing, as in the JAX trainer; ``bsr`` rounds the bucket to 128: the
    samples' vertices and coefficients and the bucket equal the JAX
    trainer's."""
    logged = []
    trainer = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv(tmp_path, "--device", "cpu",
                                                                  "--operator-format", fmt)), log=logged.append)
    jtr, jte, jbuckets = _jax_split(_argv(tmp_path, "--operator-format", fmt))
    assert trainer.fmt == "structured" and any("structured Dirac tables" in str(m) for m in logged)
    assert not any("auto ->" in str(m) for m in logged)
    for got, ref in zip(trainer.train_samples + trainer.test_samples, jtr + jte):
        assert got["name"] == ref["name"] and "rcm_perm" not in got
        np.testing.assert_array_equal(got["V"], ref["V"])
        np.testing.assert_array_equal(got["F"], ref["F"])
        _same_coeffs(got["dirac"], ref["dirac"])
    for f in ("n_vertices", "n_faces", "max_valence", "dirac_base_valence", "dirac_overflow"):
        assert getattr(trainer.buckets, f) == getattr(jbuckets, f), f
    assert trainer.buckets.n_vertices == (128 if fmt == "bsr" else 72)


def test_dirac_step_matches_jax(tmp_path):
    """The trainer with ``--model dirac`` (DirDeepModel, 2 layers, batch 2)
    on the fixture meshes: the split and six batches' order equal the JAX
    trainer's; the first batch equals the JAX package's packing; in fp64
    (JAX under ``enable_x64``, the tables fp32 in both) the loss and every
    gradient agree to 1e-6, and the parameters after one Adam update equal
    optax's Adam applied to the port's gradients to 1e-6 (against JAX's own
    update they would not: the fp32 head moves gradient elements near 0 by
    about 1e-8 of the largest, and Adam's first step ``g / (|g| + 1e-8)``
    turns that into up to the learning rate); the fp32 update's loss lies
    within 1e-4 of JAX's fp32 loss and its gradients are finite and
    non-zero."""
    trainer = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv(tmp_path, "--device", "cpu")), log=lambda _: None)
    jtr, jte, jbuckets = _jax_split(_argv(tmp_path))
    assert _names(trainer.train_samples) == _names(jtr) and _names(trainer.test_samples) == _names(jte)
    jsampler = JEpochSampler(jtr, 2, seed=17)
    assert [_names(trainer.train_sampler.next_batch()) for _ in range(6)] == \
        [_names(jsampler.next_batch()) for _ in range(6)]
    trainer.train_sampler = ttrain.EpochSampler(trainer.train_samples, 2, seed=17)
    samples = trainer.train_sampler.next_batch()
    batch = trainer.batch(samples)
    by_name = {s["name"]: s for s in jtr}
    jb = jbat.dirac_batch([by_name[n] for n in _names(samples)], jbuckets)
    for k in ("inputs", "targets", "mask"):
        np.testing.assert_array_equal(getattr(batch, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    _same_tables(batch.operator, jb.operator)

    jmodel = jmodels.DirDeepModel(3, 3, 2)
    jop = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    params = _jax_params(jmodel, jop, jnp.asarray(jb.mask), jnp.asarray(jb.inputs), seed=31)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    model64 = copy.deepcopy(trainer.model).double()

    def jrun(p, dtype):
        def objective(q):
            out = jmodel.apply({"params": q}, jop, jnp.asarray(jb.mask, dtype), jnp.asarray(jb.inputs, dtype))
            return jlosses.normal_cosine_loss(out, jnp.asarray(jb.mask, dtype), jnp.asarray(jb.targets, dtype))
        return jax.jit(jax.value_and_grad(objective))(p)

    def as_state(tree):
        return params_from_flax(jax.tree_util.tree_map(np.asarray, tree), like=trainer.model)

    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jloss64, jg64 = jrun(jp64, jnp.float64)
        jg64 = _state64(jg64)
    b64 = copy.copy(batch)
    b64.inputs, b64.targets, b64.mask = batch.inputs.double(), batch.targets.double(), batch.mask.double()
    p0 = {k: p.detach().clone() for k, p in model64.named_parameters()}
    loss64, _ = ttrain.train_step(model64, toptim.adam(model64.parameters(), 1e-3), b64)
    assert_close(loss64.numpy(), jloss64, STEP_FP64_RTOL, "fp64 loss")
    g64 = {k: p.grad.numpy() for k, p in model64.named_parameters()}
    with jax.enable_x64(True):
        tx = joptim.adam(1e-3)
        jp0 = {k: jnp.asarray(v.numpy()) for k, v in p0.items()}
        upd, _ = tx.update({k: jnp.asarray(v) for k, v in g64.items()}, tx.init(jp0), jp0)
        new64 = {k: np.asarray(v) for k, v in optax.apply_updates(jp0, upd).items()}
    _hold_grads(g64, jg64, STEP_FP64_RTOL, _null_grads("DirDeepModel", 2), "fp64 grad")
    for k, p in model64.named_parameters():
        assert_close(p.detach().numpy(), new64[k], STEP_FP64_RTOL, f"fp64 after Adam {k}")

    jloss, _ = jrun(to_jax(params), jnp.float32)
    loss, mad = trainer.update(batch)
    assert trainer.step == 1 and np.isfinite(float(mad))
    assert_close(loss.numpy(), jloss, STEP_FP32_RTOL, "fp32 loss")
    for k, p in trainer.model.named_parameters():
        assert np.isfinite(p.grad.numpy()).all() and (k in _null_grads("DirDeepModel", 2) or (p.grad != 0).any()), k


def test_train_normal_dirac_main_cpu(tmp_path):
    """The acceptance run with ``--model dirac``: one epoch of 3 updates
    writes the JAX trainer's log and metrics files and the checkpoint; a
    second run resumes from it with ``--only-forward-test``."""
    argv = ["--device", "cpu", "--model", "dirac", "--data-path", str(OBJS), "--layer", "2", "--num-epoch", "1",
            "--batch-size", "2", "--result-dir", str(tmp_path)]
    hist = ttrain.main(argv + ["--num-updates", "3"])
    (train_loss, _), = hist["train"]
    assert np.isfinite(train_loss) and len(hist["test"]) == 1
    log = (tmp_path / "log" / "debug.log").read_text()
    assert "Train 0, loss" in log and "Eval 0, loss" in log and "structured Dirac tables" in log
    records = [json.loads(x) for x in (tmp_path / "log" / "debug.metrics.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["split"]) for r in records] == [(0, "train"), (0, "test")]
    assert torch.load(tmp_path / "pts" / "debug_normal_state.pt", weights_only=True)["step"] == 3
    ttrain.main(argv + ["--deser", str(tmp_path / "pts" / "debug_normal_state.pt"), "--only-forward-test",
                        "--dump-dir", str(tmp_path / "dump"), "--result-prefix", "fwd"])
    csvs = sorted((tmp_path / "dump" / "fwd").glob("*.csv"))
    assert len(csvs) == 2 and np.loadtxt(csvs[0], delimiter=",").shape == (72, 3)


def test_dirac_trainer_resumes_from_a_jax_checkpoint(tmp_path):
    """``--deser`` of a ``.msgpack`` the JAX package saved for DirDeepModel
    (params and optax Adam state after 2 steps, epoch 4, step 2): the
    trainer starts at epoch 4 with those weights and the optimizer loaded,
    and its next update equals optax's from the same state."""
    samples = _dirac_samples((70,))
    jb = jbat.dirac_batch([_jax_sample(s) for s in samples], jbat.Buckets.for_samples(samples))
    jmodel = jmodels.DirDeepModel(3, 3, 2)
    params = to_jax(_jax_params(jmodel, jax.tree_util.tree_map(jnp.asarray, jb.operator), jnp.asarray(jb.mask),
                                jnp.asarray(jb.inputs), seed=41))
    tx = joptim.adam(1e-3)
    state = tx.init(params)
    for _ in range(2):
        _, state = tx.update(jax.tree_util.tree_map(jnp.ones_like, params), state, params)
    path = tmp_path / "jax_dirac_state.msgpack"
    jckpt.save_checkpoint(str(path), params, state, epoch=4, step=2)
    logged = []
    trainer = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv(tmp_path, "--device", "cpu", "--deser", str(path),
                                                                  "--num-epoch", "5")), log=logged.append)
    assert "Continue..." in logged and not any("not loaded" in str(m) for m in logged)
    assert (trainer.start_epoch, trainer.step) == (4, 2)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, params), like=trainer.model)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    g = {k: np.full(v.shape, 0.5, np.float32) for k, v in want.items()}
    for k, p in trainer.model.named_parameters():
        p.grad = torch.from_numpy(g[k])
    trainer.opt.step()
    jg = jax.tree_util.tree_map(lambda a: jnp.full(a.shape, 0.5, a.dtype), params)
    upd, _ = tx.update(jg, state, params)
    new = params_from_flax(jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd)), like=trainer.model)
    for k, p in trainer.model.named_parameters():
        assert_close(p.detach().numpy(), new[k].numpy(), 1e-6, f"{k} after the resumed update")
