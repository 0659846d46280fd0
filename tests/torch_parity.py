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
