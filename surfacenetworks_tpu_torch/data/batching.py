"""Bucketed fixed-shape batching with masks (counterpart of
``surfacenetworks_tpu/data/batching.py``, Laplacian path only).

Batches are padded to fixed buckets: vertex count, ELL slot counts and the
BSR slot count are chosen once per dataset, exactly as in the JAX package, so
both packages pack identical operators.  Zero padding is inert: padded
vertices have mask 0 and padded operator slots have value 0.  Host arrays are
built with NumPy and returned as CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from surfacenetworks_tpu_torch import geometry as geo
from surfacenetworks_tpu_torch.sparse import (
    EllOperator,
    bsr_operator_from_scipy,
    ell_from_scipy,
    rcm_permutation,
    stack_bsr_operators,
    stack_operators,
)


def round_up(x: int, multiple: int = 8) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass
class Buckets:
    """Static shape buckets for a dataset (the Laplacian fields of the JAX
    package's ``Buckets``; the Dirac fields come with the Dirac slice)."""

    n_vertices: int
    n_faces: int = 0
    ell_k: int = 16  # Laplacian row slots
    ell_k_t: int = 16  # transpose row slots
    bsr_block: int = 128  # BSR block size
    bsr_k: int = 8  # BSR blocks per block-row

    @classmethod
    def for_samples(cls, samples, multiple: int = 8) -> "Buckets":
        nv = max(s["V"].shape[0] for s in samples)
        nf = max(s["F"].shape[0] for s in samples)
        return cls(n_vertices=round_up(nv, multiple), n_faces=round_up(nf, multiple))


@dataclasses.dataclass
class MeshBatch:
    """One padded batch: ``inputs``/``targets`` ``[B, N, C]``, ``mask``
    ``[B, N, 1]`` and the batched operator (``EllOperator``,
    ``BsrOperator`` or a dense ``[B, N, N]`` tensor).  A correspondence
    batch's ``targets`` is the host tuple ``(G, label, label_inv)``."""

    inputs: torch.Tensor
    targets: Any
    mask: torch.Tensor
    operator: Any
    faces: torch.Tensor | None = None  # [B, M, 3] (padded with 0)
    names: list | None = None


def pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], dtype=np.float32)
    out[: a.shape[0]] = a
    return out


def rcm_reorder_sample(sample: dict) -> dict:
    """Reorder a sample's vertices by reverse-Cuthill-McKee on its Laplacian,
    so the operator is banded and few BSR blocks cover it.  Faces are
    reindexed; per-vertex arrays, square operators and the geodesic matrix
    ``G`` are permuted (``G`` along both axes); ``label_inv``, whose values
    are vertex indices, is remapped; Dirac coefficients, which bake in the
    vertex order, become ``None``.  The permutation is kept as ``rcm_perm``
    (new row i holds old vertex ``rcm_perm[i]``)."""
    perm = rcm_permutation(sample["L"])
    inv = geo.invert_permutation(perm)
    n = sample["V"].shape[0]
    out = dict(sample)
    for key, val in sample.items():
        if key == "F":
            out[key] = inv[val].astype(np.int32)
        elif sp.issparse(val) and val.shape == (n, n):
            out[key] = val.tocsr()[perm][:, perm].tocsr()
        elif key in ("dirac", "flat_dirac"):
            out[key] = None
        elif key == "G":
            out[key] = val[perm][:, perm]
        elif key == "label_inv":
            out[key] = inv[val]
        elif isinstance(val, np.ndarray) and val.ndim >= 1 and val.shape[0] == n:
            out[key] = val[perm]
    out["rcm_perm"] = perm
    return out


def choose_operator_format(batch_size: int, n_vertices: int, rcm_ok: bool = False) -> str:
    """The JAX package's format rule: dense up to 2,048 vertices (and a
    128 MiB operator), BSR above it for callers that RCM-reorder, ELL
    otherwise.  Its thresholds were measured on a TPU; the port keeps them
    for parity until its own card measurements choose a default."""
    dense_bytes = batch_size * n_vertices * n_vertices * 4
    if n_vertices <= 2048 and dense_bytes <= 128 * 1024 * 1024:
        return "dense"
    if rcm_ok:
        return "bsr"
    return "ell"


def bsr_k_needed(L, block: int = 128) -> int:
    """Max distinct column blocks touched by any aligned ``block``-row band
    of ``L``: the least BSR slot count that packs it."""
    coo = L.tocoo()
    if coo.nnz == 0:
        return 1
    br = (coo.row // block).astype(np.int64)
    bc = (coo.col // block).astype(np.int64)
    pairs = np.unique(br * (1 << 32) + bc)
    counts = np.bincount((pairs >> 32).astype(np.int64))
    return int(counts.max())


def fit_bsr_k(samples_or_Ls, buckets: Buckets) -> int:
    """Size ``buckets.bsr_k`` exactly to the dataset's maximum over both
    directions (mutates ``buckets``, returns the fitted k)."""
    Ls = [s["L"] if isinstance(s, dict) else s for s in samples_or_Ls]
    block = buckets.bsr_block
    k = max(
        (max(bsr_k_needed(L, block), bsr_k_needed(L.T.tocsr(), block)) for L in Ls),
        default=1,
    )
    buckets.bsr_k = max(k, 1)
    return buckets.bsr_k


def _fixed_k_operator(L: sp.spmatrix, buckets: Buckets, N: int) -> EllOperator:
    """ELL operator with dataset-fixed slot counts for both directions."""
    csr = L.tocsr().astype(np.float32)
    fwd = ell_from_scipy(csr, k=buckets.ell_k, n_rows=N, n_cols=N)
    bwd = ell_from_scipy(csr.T.tocsr(), k=buckets.ell_k_t, n_rows=N, n_cols=N)
    return EllOperator(fwd=fwd, bwd=bwd)


def _bsr_sample_operator(L: sp.spmatrix, buckets: Buckets, N: int):
    """BSR operator with the dataset's fitted block slot count."""
    return bsr_operator_from_scipy(L, block_size=buckets.bsr_block, k=buckets.bsr_k, n_rows=N, n_cols=N)


def _dense_operator(L: sp.spmatrix, N: int) -> np.ndarray:
    out = np.zeros((N, N), dtype=np.float32)
    Ld = np.asarray(L.todense(), dtype=np.float32)
    out[: Ld.shape[0], : Ld.shape[1]] = Ld
    return out


def laplacian_batch(
    samples: list[dict],
    buckets: Buckets,
    input_key: str = "input",
    target_key: str = "target",
    fmt: str = "ell",
) -> MeshBatch:
    """Assemble a Laplacian-operator batch from per-mesh sample dicts
    (``V [n,3]``, ``F [m,3]``, ``L`` scipy sparse, ``input``, ``target``).
    ``fmt`` is ``'ell'``, ``'bsr'`` (samples RCM-ordered, ``bsr_k`` fitted),
    ``'dense'`` or ``'auto'``."""
    B = len(samples)
    N = buckets.n_vertices
    if fmt == "auto":
        fmt = choose_operator_format(B, N)
    inputs = np.stack([pad_rows(np.asarray(s[input_key], np.float32), N) for s in samples])
    targets = np.stack([pad_rows(np.asarray(s[target_key], np.float32), N) for s in samples])
    mask = np.zeros((B, N, 1), dtype=np.float32)
    for b, s in enumerate(samples):
        mask[b, : s["V"].shape[0]] = 1.0
    if fmt == "ell":
        operator = stack_operators([_fixed_k_operator(s["L"], buckets, N) for s in samples])
    elif fmt == "bsr":
        operator = stack_bsr_operators([_bsr_sample_operator(s["L"], buckets, N) for s in samples])
    elif fmt == "dense":
        operator = torch.from_numpy(np.stack([_dense_operator(s["L"], N) for s in samples]))
    else:
        raise ValueError(f"unknown operator format {fmt!r}")
    faces = None
    if buckets.n_faces > 0:
        faces = np.zeros((B, buckets.n_faces, 3), dtype=np.int32)
        for b, s in enumerate(samples):
            faces[b, : s["F"].shape[0]] = s["F"]
        faces = torch.from_numpy(faces)
    return MeshBatch(
        inputs=torch.from_numpy(inputs),
        targets=torch.from_numpy(targets),
        mask=torch.from_numpy(mask),
        operator=operator,
        faces=faces,
        names=[s.get("name") for s in samples],
    )


def correspondence_batch(sample: dict, buckets: Buckets, fmt: str = "ell") -> MeshBatch:
    """Single-shape batch (B=1) for the siamese trainer; ``targets`` is
    ``(G, label, label_inv)`` as the sample holds them.

    ``fmt='bsr'`` packs the block-sparse operator: the sample must be
    RCM-ordered (``rcm_reorder_sample``), the bucket a multiple of 128 and
    ``buckets.bsr_k`` fitted."""
    N = buckets.n_vertices
    n = sample["V"].shape[0]
    inputs = pad_rows(np.asarray(sample["input"], np.float32), N)[None]
    mask = np.zeros((1, N, 1), dtype=np.float32)
    mask[0, :n] = 1.0
    if fmt == "bsr":
        operator = stack_bsr_operators([_bsr_sample_operator(sample["L"], buckets, N)])
    elif fmt == "ell":
        operator = stack_operators([_fixed_k_operator(sample["L"], buckets, N)])
    else:
        raise ValueError(f"unknown operator format {fmt!r}: expected 'ell' or 'bsr'")
    return MeshBatch(
        inputs=torch.from_numpy(inputs),
        targets=(sample["G"], sample["label"], sample["label_inv"]),
        mask=torch.from_numpy(mask),
        operator=operator,
        names=[sample.get("name")],
    )
