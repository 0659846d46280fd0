"""Shared helpers of the parity tests between the JAX package and its PyTorch
port (``tests/test_torch_*.py``).  Inputs are made with numpy from a seed and
handed to both packages as arrays."""

from __future__ import annotations

import contextlib
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu import sparse as jsps
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu_torch import sparse as tsps
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.nn.blocks import MlpResNet2


def assert_close(got, ref, rtol: float, what: str = "") -> None:
    """``max|got - ref| <= rtol * max|ref|`` (fp32 results, so the error is
    measured against the size of the answer)."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max() if ref.size else 0.0
    scale = max(np.abs(ref).max() if ref.size else 0.0, 1e-30)
    assert err <= rtol * scale, f"{what}: max|err|={err:.3e} > {rtol:g} * max|ref|={scale:.3e}"


def blob_laplacian(seed: int, n_points: int):
    """A seeded blob mesh and its igl-style Laplacian (JAX package's code)."""
    V, F = jdatasets.random_blob_mesh(np.random.default_rng(seed), n_points)
    return V, F, jgeo.igl_style_laplacian(V, F, hack=1.0)


def rcm(L):
    perm = jsps.rcm_permutation(L)
    return L.tocsr()[perm][:, perm].tocsr()


def operators(L, N: int, fmt: str, batch: int = 1):
    """The same scipy operator packed by both packages, padded to N rows,
    with a leading batch axis: (JAX operator, port operator)."""
    if fmt == "dense":
        d = np.zeros((N, N), np.float32)
        d[: L.shape[0], : L.shape[1]] = L.toarray()
        d = np.stack([d] * batch)
        return jnp.asarray(d), torch.from_numpy(d)
    if fmt == "ell":
        j = jsps.stack_operators([jsps.operator_from_scipy(L, k=16, n_rows=N, n_cols=N)] * batch)
        t = tsps.stack_operators([tsps.operator_from_scipy(L, k=16, n_rows=N, n_cols=N)] * batch)
    elif fmt == "bsr":
        j = jsps.stack_bsr_operators([jsps.bsr_operator_from_scipy(L, n_rows=N, n_cols=N)] * batch)
        t = tsps.stack_bsr_operators([tsps.bsr_operator_from_scipy(L, n_rows=N, n_cols=N)] * batch)
    else:
        raise ValueError(fmt)
    return jax.tree_util.tree_map(jnp.asarray, j), t


def perturbed_params(params, seed: int, scale: float = 0.1) -> dict:
    """Flax params as nested numpy dicts, every leaf moved by seeded noise
    (so unit BN scales and zero biases do not hide a mapping error)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v) for k, v in node.items()}
        a = np.asarray(node, dtype=np.float32)
        return (a + scale * rng.normal(size=a.shape)).astype(np.float32)

    return walk(params)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def state64(tree) -> dict:
    """A flax params tree (or a gradient tree) as ``state_dict`` keys, the
    values in fp64: Dense ``kernel`` transposed to ``weight``, ``scale`` as
    ``weight``, ``bias`` as ``bias``, a bare parameter under its own name."""
    out = {}
    for key, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [k.key for k in key]
        arr = np.asarray(leaf, np.float64)
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}.get(names[-1], names[-1])
        out[".".join(names[:-1] + [name])] = arr.T if names[-1] == "kernel" else arr
    return out


NULL_ATOL = 1e-12  # of the largest gradient: a gradient that is zero in exact arithmetic


def hold_grads(got: dict, ref: dict, rtol: float, null: set, what: str) -> None:
    """The same keys; each gradient finite, non-zero and within ``rtol`` of
    its ``max|ref|``; those in ``null`` (zero in exact arithmetic) within
    NULL_ATOL of the largest gradient, in both."""
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        if k in null:
            assert max(np.abs(r).max(), np.abs(got[k]).max()) <= NULL_ATOL * top, f"{what} {k}: not zero"
        else:
            assert np.isfinite(got[k]).all() and (got[k] != 0).any(), f"{what} {k}: no gradient"
            assert_close(got[k], r, rtol, f"{what} {k}")


def rel_fro(a, b) -> float:
    """``|a - b| / |b|`` in the Frobenius norm, in fp64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def batch_as(batch, dtype):
    """A copy of a port ``MeshBatch`` with its float tensors in ``dtype``:
    inputs, mask, float targets, a dense operator, and the same in ``aux``
    (sparse operators keep their fp32 values; their applies promote)."""
    import copy

    def conv(t):
        return t.to(dtype) if isinstance(t, torch.Tensor) and t.is_floating_point() else t

    out = copy.copy(batch)
    out.inputs, out.mask, out.targets, out.operator = (conv(batch.inputs), conv(batch.mask), conv(batch.targets),
                                                       conv(batch.operator))
    if batch.aux is not None:
        out.aux = {k: conv(v) for k, v in batch.aux.items()}
    return out


def random_params(shapes, seed: int) -> dict:
    """Seeded flax-layout params for a tree of shapes (``jax.eval_shape`` of
    a module's ``init``), as nested numpy dicts, with no init compiled:
    Dense kernels normal with variance 1/fan_in, BN scales 1 and every other
    leaf (biases, a bare parameter) moved off its init by 0.1-scaled noise."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        shape = tuple(node.shape)
        if name == "kernel":
            a = rng.normal(size=shape) / np.sqrt(shape[0])
        elif name == "scale":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            a = 0.1 * rng.normal(size=shape)
        return a.astype(np.float32)

    return walk(shapes)


DIRAC_TABLES = ("faces", "q_fv", "vf_face", "q_vf", "q_bwd_v", "q_bwd_f", "ov_rows", "ov_face", "q_ov_vf",
                "q_ov_bwd_v")


def same_operator(got, ref, case: str) -> None:
    """A port operator equals the JAX package's bit for bit."""
    if case == "dense":
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    elif case == "dirac":
        for f in DIRAC_TABLES:
            a, b = getattr(got, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    else:
        for part in ("fwd", "bwd"):
            for f in ("cols", "vals"):
                np.testing.assert_array_equal(getattr(getattr(got, part), f).numpy(),
                                              np.asarray(getattr(getattr(ref, part), f)), err_msg=f"{part}.{f}")


def leaves(obj) -> list:
    """The tensors of a batch field, through operator dataclasses, tuples
    and dicts, in a fixed order."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in leaves(o)]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in leaves(obj[k])]
    return []


def same_tensors(a, b) -> None:
    """Two port batches hold equal tensors, operators and ``aux``."""
    for k in ("inputs", "targets", "mask", "operator", "aux"):
        x, y = leaves(getattr(a, k)), leaves(getattr(b, k))
        assert len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y)), k


ADAM_EPS = 1e-8


def hold_adam_update(model, ref_new: dict, ref_grads: dict, state: dict, rtol: float, lr: float = 1e-3,
                     weight_decay: float = 1e-5, null: frozenset = frozenset()) -> None:
    """The parameters of ``model`` after its first coupled-L2 Adam update
    against the reference's (``ref_new``, after the reference gradients
    ``ref_grads`` from the parameters ``state``), both in fp64.

    The first update of an element is ``lr * g / (|g| + eps)`` of its
    decayed gradient ``g``, whose slope ``lr * eps / (|g| + eps)^2`` grows
    to ``lr / eps`` at ``g = 0``.  Gradients held to ``rtol`` of their
    largest, ``G``, may differ by ``rtol * G``, which moves an element by
    up to ``lr * eps * rtol * G / g^2``; that stays within ``rtol`` of the
    largest parameter ``P`` where ``|g| >= sqrt(lr * eps * G / P)``.  So
    those elements must be within ``rtol * P`` of the reference's, at least
    90% of all elements must be among them, and every element (the
    parameters in ``null``, zero gradients in exact arithmetic, too) must
    equal the update of its own gradient (``model``'s ``.grad``) within
    1e-12 of ``P``."""
    held = total = 0
    for k, p in model.named_parameters():
        got, ref, p0 = p.detach().double().numpy(), ref_new[k], np.asarray(state[k], np.float64)
        g_own = p.grad.double().numpy() + weight_decay * p0
        assert_close(got, p0 - lr * g_own / (np.abs(g_own) + ADAM_EPS), 1e-12,
                     f"after Adam {k}, against the update of its own gradient")
        if k in null:
            continue
        g_ref = ref_grads[k] + weight_decay * p0
        scale = max(float(np.abs(ref).max()), 1e-30)
        ok = np.abs(g_ref) >= np.sqrt(lr * ADAM_EPS * float(np.abs(g_ref).max()) / scale)
        held, total = held + int(ok.sum()), total + ok.size
        err = float(np.abs(got - ref)[ok].max()) if ok.any() else 0.0
        assert err <= rtol * scale, f"after Adam {k}: max|err|={err:.3e} > {rtol:g} * max|ref|={scale:.3e}"
    assert held >= 0.9 * total, f"only {held} of {total} elements have a well-conditioned first update"


@jax.jit
def jax_adam_step(grads, params):
    """The parameters after the JAX package's first update
    (``optim.adam(1e-3, weight_decay=1e-5)``, its mesh-MNIST and VAE
    trainers' optimizer) from ``grads``, in one compiled call."""
    import optax

    from surfacenetworks_tpu.train import optim as joptim

    tx = joptim.adam(1e-3, weight_decay=1e-5)
    upd, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, upd)


def bf16_ulp(ref) -> np.ndarray:
    """One unit in the last place of each value of ``ref`` as a bf16 number
    (8 significant bits: ``2^(e - 7)`` for ``|v|`` in ``[2^e, 2^(e+1))``),
    0 where ``ref`` is 0."""
    a = np.abs(np.asarray(ref, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def assert_within(got, ref, bound, what: str = "") -> None:
    """Every element within its own bound: ``|got - ref| <= bound`` (fp64;
    1e-30 lets an element whose bound is 0 be 0)."""
    got, ref, bound = (np.asarray(a, np.float64) for a in (got, ref, bound))
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    ratio = np.abs(got - ref) / (bound + 1e-30)
    worst = np.unravel_index(int(np.argmax(ratio)), ratio.shape) if ratio.size else ()
    assert not ratio.size or ratio.max() <= 1.0, (
        f"{what}: element {worst} off by {abs(got[worst] - ref[worst]):.3e}, {ratio.max():.3f} of its bound")


def f64(t) -> np.ndarray:
    """A torch tensor (any float dtype, bf16 too) or an array as fp64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().cpu().numpy()
    return np.asarray(t, np.float64)


# ---------------------------------------------------------------------------
# bf16 parity (tests/test_torch_bf16*.py)
# ---------------------------------------------------------------------------

BF16 = jnp.bfloat16
BF16_U = 2.0**-8  # bf16's unit roundoff: one rounding moves a value by at most this share of it
# A bf16 model's output (fp32, through its fp32 head) against the JAX
# package's at dtype=bf16, relative Frobenius: the same roundings at the same
# places, fp32 sums in another order; measured at most 4.1e-3 (about U).
BF16_OUT_RTOL = 4 * BF16_U
# One unit (a layer or a block) on the same arguments as JAX's, under the
# same output cotangent: the same roundings at the same places, fp32 sums in
# another order, so a few values land a bf16 ulp apart.  Its outputs within
# 4U (measured at most 0.86U, an Mlp block); each parameter's gradient
# within 16U (measured at most 6.8U); each argument's gradient within 64U
# (measured at most 24.8U: the FAUST trunk's Avg block, whose input
# cotangent adds in bf16 the average path's constant to paths that cancel
# it, in another order than JAX's).  A zeroed or detached gradient reads 1.
UNIT_OUT_RTOL = 4 * BF16_U
UNIT_GRAD_RTOL = 16 * BF16_U
UNIT_ARG_GRAD_RTOL = 64 * BF16_U


@contextlib.contextmanager
def fp32_sums():
    """JAX at bf16 with every bf16 ``reduce_sum`` added in fp32 and rounded
    once to bf16.  XLA on the CPU adds a bf16 reduction in bf16 (a bias's
    gradient over 4,096 rows comes out 2% off), where the port adds it in
    fp32 as a GPU does; the rounding points stay JAX's.  Compiled code is
    dropped on entry and on exit."""
    from jax._src.interpreters import mlir
    from jax._src.lax import lax as jlax

    prim = jlax.reduce_sum_p
    orig = mlir._lowerings[prim]
    wide = mlir.lower_fun(lambda x, **kw: prim.bind(x.astype(jnp.float32), **kw).astype(x.dtype),
                          multiple_results=False)

    def rule(ctx, x, **kw):
        return (wide if ctx.avals_in[0].dtype == jnp.bfloat16 else orig.rule)(ctx, x, **kw)

    jax.clear_caches()
    mlir._lowerings[prim] = mlir.LoweringRuleEntry(rule, orig.inline)
    try:
        yield
    finally:
        mlir._lowerings[prim] = orig
        jax.clear_caches()


def units(model) -> list[str]:
    """The names of the modules a bf16 step is held by one at a time: each
    outermost module whose class the port's ``nn`` package defines (a layer
    or a block), in call order of ``named_modules``."""
    out: list[str] = []
    for name, mod in model.named_modules():
        if name and type(mod).__module__.startswith("surfacenetworks_tpu_torch.nn.") and not any(
                name.startswith(u + ".") for u in out):
            out.append(name)
    return out


@contextlib.contextmanager
def unit_calls(model):
    """Records every call of every unit of ``model`` while the block runs
    (a forward and its backward): the arguments, the outputs and the
    outputs' cotangents.  Yields ``(before, calls)``: ``before`` a copy of
    ``model`` as it was on entry (an optimizer step inside the block leaves
    it as it was), ``calls`` the list of records."""
    before = copy.deepcopy(model)
    calls: list[dict] = []
    handles = []

    def record(name):
        def hook(mod, args, kwargs, out):
            outs = list(out) if isinstance(out, tuple) else [out]
            rec = {"name": name, "kwargs": kwargs, "outs": [o.detach().clone() for o in outs],
                   "args": [a.detach().clone().requires_grad_(a.requires_grad) if isinstance(a, torch.Tensor) else a
                            for a in args], "cots": [None] * len(outs)}
            for i, o in enumerate(outs):
                if o.requires_grad:
                    o.register_hook(lambda g, i=i, rec=rec: rec["cots"].__setitem__(i, g.detach().clone()))
            calls.append(rec)
        return hook

    for name in units(model):
        handles.append(model.get_submodule(name).register_forward_hook(record(name), with_kwargs=True))
    try:
        yield before, calls
    finally:
        for h in handles:
            h.remove()


class _Stop(Exception):
    pass


def _jax_unit_vjp(japply, jparams, path: tuple, index: int, xs: dict, cots: list):
    """JAX's side of one unit call: the full model run by ``japply(params)``
    up to call ``index`` of the flax module at ``path``, that call's float
    arguments replaced by ``xs`` (position -> array), its outputs and the
    VJP of ``cots`` (its parameter gradients as a full tree, and one
    gradient for each of ``xs``); also the dtypes JAX's own run handed it."""
    seen = {}
    pos = sorted(xs)

    def f(p, *vals):
        n = [0]

        def icpt(next_fun, args, kwargs, ctx):
            if ctx.method_name == "__call__" and ctx.module.path == path:
                if n[0] == index:
                    seen["dtypes"] = [getattr(a, "dtype", None) for a in args]
                    args = list(args)
                    for i, v in zip(pos, vals):
                        args[i] = v
                    seen["out"] = next_fun(*args, **kwargs)
                    raise _Stop
                n[0] += 1
            return next_fun(*args, **kwargs)

        try:
            with fnn.intercept_methods(icpt):
                japply(p)
        except _Stop:
            pass
        out = seen["out"]
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def run(p, vals, cts):
        outs, vjp = jax.vjp(f, p, *vals)
        return outs, vjp(cts)

    cts = tuple(jnp.asarray(f64(c), BF16 if c.dtype == torch.bfloat16 else jnp.float32) for c in cots)
    outs, grads = jax.jit(run)(jparams, tuple(xs[i] for i in pos), cts)  # the run before the call is dead code
    return outs, grads[0], dict(zip(pos, grads[1:])), seen["dtypes"]


def _port_unit_vjp(before, rec, cots):
    """The port's side of one recorded call, re-run on a copy of its
    arguments by the unit of ``before``: its outputs, its parameter
    gradients (``state_dict`` keys of the model) and a gradient for each
    argument that needed one."""
    unit = before.get_submodule(rec["name"])
    args = [a.detach().clone().requires_grad_(a.requires_grad) if isinstance(a, torch.Tensor) else a
            for a in rec["args"]]
    out = unit(*args, **rec["kwargs"])
    outs = list(out) if isinstance(out, tuple) else [out]
    params = dict(unit.named_parameters())
    wrt = {i: a for i, a in enumerate(args) if isinstance(a, torch.Tensor) and a.requires_grad}
    g = torch.autograd.grad(outs, list(params.values()) + list(wrt.values()), cots, allow_unused=True)
    pg = {f"{rec['name']}.{k}": (torch.zeros_like(p) if gi is None else gi) for (k, p), gi in zip(params.items(), g)}
    xg = {i: (torch.zeros_like(a) if gi is None else gi) for (i, a), gi in zip(wrt.items(), g[len(params):])}
    return outs, pg, xg


def null_leaves(unit, prefix: str = "") -> set:
    """The parameters of ``unit`` (keys after ``prefix``) whose gradients
    are zero in exact arithmetic: in an Mlp block the fc0 bias adds a
    per-channel constant that its bn1 (over every row) removes (the rule of
    ``test_torch_mnist._null_grads``)."""
    return {f"{prefix}fc0.fc.bias"} if isinstance(unit, MlpResNet2) else set()


def unit_rows(what: str, before, calls, japply, jparams) -> list[dict]:
    """Every recorded unit call of a bf16 step against the flax module at
    the same path, run on the same arguments with the same output
    cotangent (run inside ``fp32_sums``): one row for each output
    and for each gradient (a parameter, or an argument that needed one),
    with the port's and JAX's values.  Each call's cotangent must be there,
    finite and non-zero (a path detached upstream of it leaves none); each
    float argument must have the dtype JAX's own run hands the module; the
    outputs and gradients keep their dtypes."""
    rows = []
    index: dict = {}
    for rec in calls:
        name, k = rec["name"], index.get(rec["name"], 0)
        index[name] = k + 1
        call = f"{what} {name}#{k}"
        assert any(c is not None for c in rec["cots"]), f"{call}: no cotangent reached it"
        cots = [torch.zeros_like(o) if c is None else c for o, c in zip(rec["outs"], rec["cots"])]
        assert all(torch.isfinite(c).all() for c in cots) and any(bool((c != 0).any()) for c in cots), \
            f"{call}: cotangent not finite or all zero"
        touts, tpg, txg = _port_unit_vjp(before, rec, cots)
        floats = {i: a for i, a in enumerate(rec["args"]) if isinstance(a, torch.Tensor) and a.is_floating_point()}
        xs = {i: jnp.asarray(f64(a), BF16 if a.dtype == torch.bfloat16 else jnp.float32) for i, a in floats.items()}
        jouts, jpg, jxg, jdtypes = _jax_unit_vjp(japply, jparams, tuple(name.split(".")), k, xs, cots)
        for i, a in floats.items():
            assert str(jdtypes[i]) == _dt(a), f"{call} argument {i}: {a.dtype}, JAX's {jdtypes[i]}"
        jpg = {key: v for key, v in state64(jpg).items() if key.startswith(name + ".")}
        assert sorted(jpg) == sorted(tpg), (call, sorted(jpg), sorted(tpg))
        null = null_leaves(before.get_submodule(name), name + ".")
        for i, (t, j) in enumerate(zip(touts, jouts)):
            assert _dt(t) == str(j.dtype), f"{call} output {i}: {t.dtype}, JAX's {j.dtype}"
            rows.append({"call": call, "leaf": f"output {i}", "kind": "out", "got": f64(t), "ref": f64(j)})
        top = max(float(np.linalg.norm(v)) for v in jpg.values())
        for key, t in tpg.items():
            assert t.dtype == torch.float32, f"{call} {key}: {t.dtype}"
            rows.append({"call": call, "leaf": key, "kind": "null" if key in null else "grad", "got": f64(t),
                         "ref": jpg[key], "top": top})
        for i, t in txg.items():
            assert t.dtype == rec["args"][i].dtype, f"{call} argument {i} gradient: {t.dtype}"
            rows.append({"call": call, "leaf": f"argument {i}", "kind": "arg", "got": f64(t), "ref": f64(jxg[i])})
    return rows


def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def check_unit_rows(rows: list[dict]) -> dict:
    """Each row finite and within its bound, relative Frobenius: an output
    within UNIT_OUT_RTOL, a parameter's gradient within UNIT_GRAD_RTOL, an
    argument's within UNIT_ARG_GRAD_RTOL, a null one (zero in exact
    arithmetic) within BF16_U of its unit's largest parameter gradient.
    Returns the largest error of each kind."""
    bounds = {"out": UNIT_OUT_RTOL, "grad": UNIT_GRAD_RTOL, "arg": UNIT_ARG_GRAD_RTOL, "null": BF16_U}
    worst = dict.fromkeys(bounds, 0.0)
    for r in rows:
        what = f"{r['call']} {r['leaf']}"
        assert np.isfinite(r["got"]).all(), f"{what}: not finite"
        if r["kind"] == "null":
            err = float(np.linalg.norm(r["got"] - r["ref"])) / r["top"]
        else:
            err = rel_fro(r["got"], r["ref"])
        assert err <= bounds[r["kind"]], f"{what}: relative error {err:.3e} > {bounds[r['kind']]:.3e}"
        worst[r["kind"]] = max(worst[r["kind"]], err)
    return worst


def hold_bf16_units(what: str, before, calls, japply, jparams) -> dict:
    """A bf16 step held unit by unit (``unit_rows``, ``check_unit_rows``),
    every gradient leaf by leaf.  The check must refuse the same rows with
    the largest parameter gradient zeroed, and with an argument's gradient
    zeroed as a detached input leaves it."""
    with fp32_sums():
        rows = unit_rows(what, before, calls, japply, jparams)
    worst = check_unit_rows(rows)
    planted = [max((r for r in rows if r["kind"] == "grad"), key=lambda r: float(np.linalg.norm(r["ref"])))]
    planted += [r for r in rows if r["kind"] == "arg"][:1]
    for r in planted:
        try:
            check_unit_rows([{**r, "got": np.zeros_like(r["got"])}])
        except AssertionError:
            continue
        raise AssertionError(f"{what}: a zeroed {r['leaf']} of {r['call']} passed")
    return worst


def hold_bf16_model(what: str, jmod16, tmod, jargs, targs, loss_t, seed: int, tcall=None) -> dict:
    """Flax ``jmod16`` (bf16) and the port's ``tmod`` (bf16) with the same
    perturbed parameters on ``jargs`` / ``targs`` (``tcall(tmod, *targs)``
    calls the port's where its argument order differs): the output, or each
    output of a tuple (fp32 in both), within BF16_OUT_RTOL; the step under
    ``loss_*(output)`` held unit by unit (``hold_bf16_units``)."""
    params = perturbed_params(jmod16.init(jax.random.key(0), *jargs)["params"], seed)
    tmod.load_state_dict(params_from_flax(params, like=tmod), strict=True)
    jout = jax.jit(lambda p: jmod16.apply({"params": p}, *jargs))(to_jax(params))
    with unit_calls(tmod) as (before, calls):
        tout = tcall(tmod, *targs) if tcall else tmod(*targs)
        loss = loss_t(tout)
        loss.backward()
    touts, jouts = (tout, jout) if isinstance(tout, tuple) else ((tout,), (jout,))
    assert all(o.dtype == torch.float32 for o in touts) and all(o.dtype == jnp.float32 for o in jouts), what
    assert loss.dtype == torch.float32 and all(p.dtype == torch.float32 for p in tmod.parameters())
    assert all(p.grad is not None and p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in tmod.parameters()), what
    e_out = max(rel_fro(f64(o), j) for o, j in zip(touts, jouts))
    assert e_out <= BF16_OUT_RTOL, f"{what}: output rel_fro {e_out:.3e} > {BF16_OUT_RTOL:.3e}"
    worst = hold_bf16_units(what, before, calls, lambda p: jmod16.apply({"params": p}, *jargs), to_jax(params))
    return {"model_out": e_out, **worst}


def bf16_mesh(n=150, N=256, batch=2, seed=3):
    """An RCM-ordered blob mesh Laplacian of ``n`` vertices, a ``[batch, N,
    1]`` mask of its rows and a seeded generator."""
    _, _, L = blob_laplacian(seed, n)
    L = rcm(L)
    rng = np.random.default_rng(seed)
    mask = np.zeros((batch, N, 1), np.float32)
    mask[:, :n] = 1.0
    return L, mask, rng


def bf16_operators(L, N, fmt, batch=2):
    """(JAX, port) operators; BSR blocks in bf16, as the trainers store them."""
    if fmt == "bsr":
        j = jsps.stack_bsr_operators([jsps.bsr_operator_from_scipy(L, n_rows=N, n_cols=N, dtype=BF16)] * batch)
        t = tsps.stack_bsr_operators([tsps.bsr_operator_from_scipy(L, n_rows=N, n_cols=N, dtype=torch.bfloat16)] * batch)
        return jax.tree_util.tree_map(jnp.asarray, j), t
    return operators(L, N, fmt, batch)


def dirac_operators(n_samples=2, seed=2):
    """The structured Dirac operators of a synthetic 60-vertex batch as both
    packages pack them, and the batch's mask."""
    from surfacenetworks_tpu.data import Buckets as JBuckets
    from surfacenetworks_tpu.data import dirac_batch as jdirac_batch
    from surfacenetworks_tpu_torch.data import Buckets, dirac_batch as tdirac_batch
    from surfacenetworks_tpu_torch.data import datasets

    js = jdatasets.synthetic_normal_dataset(n_samples, 60, seed=seed, operator="dirac")
    ts = datasets.synthetic_normal_dataset(n_samples, 60, seed=seed, operator="dirac")
    jb = jdirac_batch(js, JBuckets.for_samples(js))
    tb = tdirac_batch(ts, Buckets.for_samples(ts))
    return jax.tree_util.tree_map(jnp.asarray, jb.operator), tb.operator, np.asarray(tb.mask)
