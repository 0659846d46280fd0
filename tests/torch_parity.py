"""Shared helpers of the parity tests between the JAX package and its PyTorch
port (``tests/test_torch_*.py``).  Inputs are made with numpy from a seed and
handed to both packages as arrays."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu import sparse as jsps
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu_torch import sparse as tsps


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
