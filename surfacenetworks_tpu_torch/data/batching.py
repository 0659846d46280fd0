"""Bucketed fixed-shape batching with masks (counterpart of
``surfacenetworks_tpu/data/batching.py``: the Laplacian, Dirac, cascade,
correspondence, ARAP, mesh-MNIST and VAE batches, and the size tiers of
``BucketSet``).

Batches are padded to fixed buckets: vertex and face counts, ELL slot
counts, the BSR slot count and the Dirac valence packing are chosen once per
dataset, exactly as in the JAX package, so both packages pack identical
operators.  Zero padding is inert: padded
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
from surfacenetworks_tpu_torch.geometry import coarsening
from surfacenetworks_tpu_torch.sparse import (
    EllOperator,
    bsr_operator_from_scipy,
    dirac_from_coeffs,
    ell_from_scipy,
    rcm_permutation,
    stack_bsr_operators,
    stack_dirac,
    stack_operators,
)


IN_FRAMES = 2  # an ARAP batch item's input frames
OUT_FRAMES = 40  # and the frames it predicts


def round_up(x: int, multiple: int = 8) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass
class Buckets:
    """Static shape buckets for a dataset."""

    n_vertices: int
    n_faces: int = 0
    ell_k: int = 16  # Laplacian row slots
    ell_k_t: int = 16  # transpose row slots
    max_valence: int = 16  # Dirac vertex-face incidence slots
    bsr_block: int = 128  # BSR block size
    bsr_k: int = 8  # BSR blocks per block-row
    # Packed-valence Dirac tables (``sparse.dirac_from_coeffs``): base slot
    # count about the 95th-percentile valence; the few vertices of higher
    # valence overflow into a side table of ``dirac_overflow`` rows.  0 =
    # packing off.
    dirac_base_valence: int = 0
    dirac_overflow: int = 0

    @classmethod
    def for_samples(cls, samples, multiple: int = 8) -> "Buckets":
        nv = max(s["V"].shape[0] for s in samples)
        nf = max(s["F"].shape[0] for s in samples)
        base, ov = _dirac_packing(samples)
        return cls(n_vertices=round_up(nv, multiple), n_faces=round_up(nf, multiple),
                   dirac_base_valence=base, dirac_overflow=ov)

    def dirac_kwargs(self) -> dict:
        """kwargs of ``dirac_from_coeffs`` for this bucket's packing."""
        if not self.dirac_base_valence or self.dirac_base_valence >= self.max_valence:
            return {}
        return {"base_valence": self.dirac_base_valence, "n_overflow": self.dirac_overflow}


@dataclasses.dataclass
class BucketSet:
    """Size tiers over a heterogeneous dataset (``--buckets N``): each batch
    pads to the smallest tier that fits it, one set of shapes per tier.
    All tiers share the dataset's ELL widths and Dirac packing, so operator
    tables differ only in row count.  Tiers are cut by rank over the
    samples' vertex counts and sized to each segment's maxima, as in the
    JAX package."""

    tiers: list[Buckets]  # ascending n_vertices

    @classmethod
    def for_samples(cls, samples, n_tiers: int = 3, multiple: int = 8) -> "BucketSet":
        base = Buckets.for_samples(samples, multiple=multiple)
        if n_tiers <= 1 or len(samples) < 2:
            return cls(tiers=[base])
        nv = np.asarray([s["V"].shape[0] for s in samples])
        nf = np.asarray([s["F"].shape[0] for s in samples])
        order = np.argsort(nv, kind="stable")
        tiers = []
        seen = set()
        for i in range(n_tiers):
            # cut by rank and size the tier to its segment's maxima, so no
            # sample lands just above a percentile-value boundary
            cut = int(np.ceil(len(samples) * (i + 1) / n_tiers)) - 1
            idx = order[: cut + 1]
            t_nv = round_up(int(nv[idx].max()), multiple)
            t_nf = round_up(int(nf[idx].max()), multiple)
            key = (t_nv, t_nf)
            if key in seen:
                continue
            seen.add(key)
            tiers.append(dataclasses.replace(base, n_vertices=t_nv, n_faces=t_nf))
        tiers.sort(key=lambda b: (b.n_vertices, b.n_faces))
        # the top tier covers the dataset max (bucket rounding included)
        tiers[-1] = dataclasses.replace(
            base, n_vertices=max(tiers[-1].n_vertices, base.n_vertices),
            n_faces=max(tiers[-1].n_faces, base.n_faces),
        )
        return cls(tiers=tiers)

    def select(self, samples) -> Buckets:
        """Smallest tier that fits every sample in the batch."""
        nv = max(s["V"].shape[0] for s in samples)
        nf = max(s["F"].shape[0] for s in samples)
        for t in self.tiers:
            if t.n_vertices >= nv and t.n_faces >= nf:
                return t
        return self.tiers[-1]

    def tier_index(self, samples) -> int:
        return self.tiers.index(self.select(samples))


def _dirac_packing(samples) -> tuple[int, int]:
    """(base_valence, n_overflow) from the dataset's vertex valences: base
    is the 95th percentile (at least 4, even), the overflow rows the most
    vertices above it in one sample, rounded up to 8 (8 when there are
    none: the tables still shrink whenever base < max valence)."""
    valences = []
    for s in samples:
        F = np.asarray(s["F"])
        if F.size == 0:
            continue
        valences.append(np.bincount(F.reshape(-1), minlength=int(F.max()) + 1))
    if not valences:
        return 0, 0
    allv = np.concatenate(valences)
    base = int(np.percentile(allv[allv > 0], 95))
    base = max(4, base + (base % 2))
    over = max(int((v > base).sum()) for v in valences)
    if over == 0:
        return base, 8
    return base, round_up(over, 8)


@dataclasses.dataclass
class MeshBatch:
    """One padded batch: ``inputs``/``targets`` ``[B, N, C]``, ``mask``
    ``[B, N, 1]`` and the batched operator (``EllOperator``,
    ``BsrOperator``, a dense ``[B, N, N]`` tensor, a ``DiracOperator`` or a
    dense Dirac pair).  A correspondence
    batch's ``targets`` is the host tuple ``(G, label, label_inv)``, a
    mesh-MNIST batch's the int32 labels ``[B]``.  ``aux`` holds what a
    family needs besides: the VAE's ``flat_inputs`` and ``flat_operator``."""

    inputs: torch.Tensor
    targets: Any
    mask: torch.Tensor
    operator: Any
    faces: torch.Tensor | None = None  # [B, M, 3] (padded with 0)
    names: list | None = None
    aux: dict | None = None


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


def fit_bsr_k(samples_or_Ls, buckets: Buckets | BucketSet) -> int:
    """Size ``bsr_k`` exactly to the dataset's maximum over both directions,
    in every tier of a ``BucketSet`` (mutates the buckets, returns the
    fitted k)."""
    Ls = [s["L"] if isinstance(s, dict) else s for s in samples_or_Ls]
    tiers = buckets.tiers if isinstance(buckets, BucketSet) else [buckets]
    block = tiers[0].bsr_block
    k = max(
        (max(bsr_k_needed(L, block), bsr_k_needed(L.T.tocsr(), block)) for L in Ls),
        default=1,
    )
    for t in tiers:
        t.bsr_k = max(k, 1)
    return max(k, 1)


def _fixed_k_operator(L: sp.spmatrix, buckets: Buckets, N: int) -> EllOperator:
    """ELL operator with dataset-fixed slot counts for both directions."""
    csr = L.tocsr().astype(np.float32)
    fwd = ell_from_scipy(csr, k=buckets.ell_k, n_rows=N, n_cols=N)
    bwd = ell_from_scipy(csr.T.tocsr(), k=buckets.ell_k_t, n_rows=N, n_cols=N)
    return EllOperator(fwd=fwd, bwd=bwd)


def _bsr_sample_operator(L: sp.spmatrix, buckets: Buckets, N: int, op_dtype: torch.dtype | None = None):
    """BSR operator with the dataset's fitted block slot count, its blocks
    assembled in fp32 and stored at ``op_dtype`` (bf16 under mixed
    precision, as the JAX trainers store them; default fp32)."""
    return bsr_operator_from_scipy(L, block_size=buckets.bsr_block, k=buckets.bsr_k, n_rows=N, n_cols=N,
                                   dtype=op_dtype or torch.float32)


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
    op_dtype: torch.dtype | None = None,
) -> MeshBatch:
    """Assemble a Laplacian-operator batch from per-mesh sample dicts
    (``V [n,3]``, ``F [m,3]``, ``L`` scipy sparse, ``input``, ``target``).
    ``fmt`` is ``'ell'``, ``'bsr'`` (samples RCM-ordered, ``bsr_k`` fitted),
    ``'dense'`` or ``'auto'``.  ``op_dtype`` (BSR only, as in the JAX
    package) stores the packed blocks at a narrower dtype: bf16 under
    mixed precision."""
    N = buckets.n_vertices
    inputs, targets, mask = _padded_arrays(samples, N, input_key, target_key)
    return MeshBatch(
        inputs=torch.from_numpy(inputs),
        targets=torch.from_numpy(targets),
        mask=torch.from_numpy(mask),
        operator=_lap_operator_batch([s["L"] for s in samples], buckets, N, fmt, op_dtype),
        faces=_pad_faces(samples, buckets),
        names=[s.get("name") for s in samples],
    )


def _lap_operator_batch(Ls: list, buckets: Buckets, N: int, fmt: str, op_dtype: torch.dtype | None = None):
    """The stacked Laplacian operators of a batch in ``fmt`` (``'auto'``
    resolved against the batch); BSR blocks stored at ``op_dtype``."""
    if fmt == "auto":
        fmt = choose_operator_format(len(Ls), N)
    if fmt == "ell":
        return stack_operators([_fixed_k_operator(L, buckets, N) for L in Ls])
    if fmt == "bsr":
        return stack_bsr_operators([_bsr_sample_operator(L, buckets, N, op_dtype) for L in Ls])
    if fmt == "dense":
        return torch.from_numpy(np.stack([_dense_operator(L, N) for L in Ls]))
    raise ValueError(f"unknown operator format {fmt!r}")


def _pad_faces(samples: list[dict], buckets: Buckets) -> torch.Tensor | None:
    if buckets.n_faces <= 0:
        return None
    faces = np.zeros((len(samples), buckets.n_faces, 3), dtype=np.int32)
    for b, s in enumerate(samples):
        faces[b, : s["F"].shape[0]] = s["F"]
    return torch.from_numpy(faces)


def _padded_arrays(samples: list[dict], N: int, input_key: str, target_key: str):
    """``inputs``, ``targets`` ``[B, N, C]`` and ``mask`` ``[B, N, 1]``."""
    inputs = np.stack([pad_rows(np.asarray(s[input_key], np.float32), N) for s in samples])
    targets = np.stack([pad_rows(np.asarray(s[target_key], np.float32), N) for s in samples])
    mask = np.zeros((len(samples), N, 1), dtype=np.float32)
    for b, s in enumerate(samples):
        mask[b, : s["V"].shape[0]] = 1.0
    return inputs, targets, mask


def _cascade_sample_pack(s: dict, levels: int, n_bucket: int, ell_k: int, input_key: str, target_key: str):
    """One sample's cascade pack: its input and target reordered into the
    pyramid's fine order and padded, the pyramid mask, and one ELL operator
    (``fwd`` and its stored transpose ``bwd`` at ``ell_k`` slots) per level,
    coarsest first."""
    p = coarsening.build_pyramid(s["V"], s["F"], levels, n_bucket=n_bucket)
    inp = pad_rows(coarsening.reorder_fine_data(p, np.asarray(s[input_key], np.float32)), n_bucket)
    tgt = pad_rows(coarsening.reorder_fine_data(p, np.asarray(s[target_key], np.float32)), n_bucket)
    msk = coarsening.pyramid_mask(p).astype(np.float32)
    ops = []
    for lvl in range(levels):
        L = p.levels[lvl].L
        fwd = ell_from_scipy(L, k=ell_k, n_rows=L.shape[0], n_cols=L.shape[1])
        bwd = ell_from_scipy(L.T.tocsr(), k=ell_k, n_rows=L.shape[0], n_cols=L.shape[1])
        ops.append(EllOperator(fwd=fwd, bwd=bwd))
    return inp, tgt, msk, ops


def cascade_batch(
    samples: list[dict],
    levels: int,
    n_bucket: int,
    ell_k: int = 32,
    input_key: str = "input",
    target_key: str = "target",
) -> MeshBatch:
    """Multiresolution batch for ``EfficientCascade``: per-sample Laplacian
    pyramids (``geometry.coarsening``, random-walk graph Laplacians of the
    greedily coarsened edge graphs), per-vertex data reordered into the
    pair-adjacent pyramid order.  ``operator`` is a tuple of batched
    ``EllOperator``s, one per level, coarsest first (the finest last, as
    the reference's ``Laps``); level ``i`` has ``n_bucket / 2**(levels-1-i)``
    rows."""
    packs = [_cascade_sample_pack(s, levels, n_bucket, ell_k, input_key, target_key) for s in samples]
    return MeshBatch(
        inputs=torch.from_numpy(np.stack([p[0] for p in packs])),
        targets=torch.from_numpy(np.stack([p[1] for p in packs])),
        mask=torch.from_numpy(np.stack([p[2] for p in packs])),
        operator=tuple(stack_operators([p[3][lvl] for p in packs]) for lvl in range(levels)),
        names=[s.get("name") for s in samples],
    )


def _dirac_coeffs_of(s: dict, key: str = "dirac") -> geo.DiracCoeffs:
    """The sample's Dirac coefficients under ``key`` or, when it has none,
    those of its float32 vertices (with z set to 0 for ``flat_dirac``), as
    the JAX package computes them here."""
    c = s.get(key)
    if c is not None:
        return c
    V = np.asarray(s["V"], np.float32)
    if key == "flat_dirac":
        V = V.copy()
        V[:, 2] = 0.0
    return geo.dirac_coeffs(V, s["F"])


def _dirac_sample_operator(s: dict, buckets: Buckets, N: int, M: int, key: str = "dirac"):
    """One sample's packed Dirac tables (of its ``key`` coefficients) at the
    bucket's shape and packing."""
    return dirac_from_coeffs(_dirac_coeffs_of(s, key), n_vertices=N, n_faces=M,
                             max_valence=buckets.max_valence, **buckets.dirac_kwargs())


def dense_dirac_pair(samples: list[dict], N: int, M: int, dtype: torch.dtype = torch.float32,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded dense Dirac pair ``(Di [B, 4M, 4N], DiA [B, 4N, 4M])``, the
    reference's ``--dense`` Dirac path: the scipy pair of each sample's
    ``V`` and ``F``, built in ``dtype`` on ``device`` (float64 vertices and
    ``dtype`` give the exact pair)."""
    B = len(samples)
    Di = torch.zeros(B, 4 * M, 4 * N, dtype=dtype, device=device)
    DiA = torch.zeros(B, 4 * N, 4 * M, dtype=dtype, device=device)
    for b, s in enumerate(samples):
        for out, mat in zip((Di, DiA), geo.dirac(s["V"], s["F"])):
            coo = mat.tocoo()  # from CSR: no duplicate entries
            rows, cols = (torch.from_numpy(i.astype(np.int64)).to(device) for i in (coo.row, coo.col))
            out[b, rows, cols] = torch.from_numpy(coo.data).to(device, dtype)
    return Di, DiA


def dirac_batch(
    samples: list[dict],
    buckets: Buckets,
    input_key: str = "input",
    target_key: str = "target",
    fmt: str = "structured",
) -> MeshBatch:
    """A Dirac batch: ``fmt='structured'`` (quaternion coefficient tables)
    or ``'dense'`` (the padded dense pair)."""
    N, M = buckets.n_vertices, buckets.n_faces
    inputs, targets, mask = _padded_arrays(samples, N, input_key, target_key)
    if fmt == "dense":
        operator = dense_dirac_pair(samples, N, M)
    elif fmt == "structured":
        operator = stack_dirac([_dirac_sample_operator(s, buckets, N, M) for s in samples])
    else:
        raise ValueError(f"unknown Dirac operator format {fmt!r}: expected 'structured' or 'dense'")
    return MeshBatch(
        inputs=torch.from_numpy(inputs),
        targets=torch.from_numpy(targets),
        mask=torch.from_numpy(mask),
        operator=operator,
        faces=_pad_faces(samples, buckets),
        names=[s.get("name") for s in samples],
    )


def _mesh_operator_batch(samples: list[dict], buckets: Buckets, model: str, fmt: str, flat: bool = False):
    """The stacked lifted (or ``flat``) operators of a mesh-MNIST batch:
    packed Dirac tables for ``model='dirac'``, else the Laplacian in
    ``fmt``."""
    N = buckets.n_vertices
    if model == "dirac":
        key = "flat_dirac" if flat else "dirac"
        return stack_dirac([_dirac_sample_operator(s, buckets, N, buckets.n_faces, key=key) for s in samples])
    return _lap_operator_batch([s["flat_L" if flat else "L"] for s in samples], buckets, N, fmt)


def _lifted_inputs(samples: list[dict], N: int) -> tuple[np.ndarray, np.ndarray]:
    """The lifted vertices ``[B, N, 3]`` and the mask ``[B, N, 1]``."""
    inputs = np.stack([pad_rows(np.asarray(s["V"], np.float32), N) for s in samples])
    mask = np.zeros((len(samples), N, 1), dtype=np.float32)
    for b, s in enumerate(samples):
        mask[b, : s["V"].shape[0]] = 1.0
    return inputs, mask


def mnist_batch(samples: list[dict], buckets: Buckets, model: str = "lap", fmt: str = "auto") -> MeshBatch:
    """A classification batch: the lifted vertices as inputs, the int32
    labels ``[B]`` as targets, and the lifted operator (packed Dirac tables
    for ``model='dirac'``, else the Laplacian in ``fmt``)."""
    inputs, mask = _lifted_inputs(samples, buckets.n_vertices)
    return MeshBatch(
        inputs=torch.from_numpy(inputs),
        targets=torch.from_numpy(np.asarray([s["label"] for s in samples], dtype=np.int32)),
        mask=torch.from_numpy(mask),
        operator=_mesh_operator_batch(samples, buckets, model, fmt),
        faces=_pad_faces(samples, buckets),
        names=[s.get("name") for s in samples],
    )


def vae_batch(samples: list[dict], buckets: Buckets, model: str = "lap", fmt: str = "auto") -> MeshBatch:
    """A VAE batch: the lifted vertices as inputs and as targets, the lifted
    operator, and in ``aux`` the flat inputs (z set to 0) as
    ``flat_inputs`` and the flat operator (``flat_L`` or ``flat_dirac``)
    as ``flat_operator``."""
    inputs, mask = _lifted_inputs(samples, buckets.n_vertices)
    flat_inputs = inputs.copy()
    flat_inputs[:, :, 2] = 0.0
    x = torch.from_numpy(inputs)
    return MeshBatch(
        inputs=x,
        targets=x,
        mask=torch.from_numpy(mask),
        operator=_mesh_operator_batch(samples, buckets, model, fmt),
        faces=_pad_faces(samples, buckets),
        names=[s.get("name") for s in samples],
        aux={"flat_inputs": torch.from_numpy(flat_inputs),
             "flat_operator": _mesh_operator_batch(samples, buckets, model, fmt, flat=True)},
    )


def arap_batch(sequences: list[list[dict]], picks: list[tuple[int, int]], buckets: Buckets, model: str = "lap",
               fmt: str = "ell") -> MeshBatch:
    """A temporal batch: ``picks`` holds one (sequence, frame offset) pair
    per batch item; the inputs are IN_FRAMES frames (3 channels each), the
    targets the next OUT_FRAMES, and the operator comes
    from the last input frame: its Laplacian in ``fmt`` for ``model='lap'``,
    its packed Dirac tables for ``'dirac'``.  The faces are each sequence's
    first frame's; ``names`` holds the picks."""
    B, N = len(picks), buckets.n_vertices
    inputs = np.zeros((B, N, 3 * IN_FRAMES), dtype=np.float32)
    targets = np.zeros((B, N, 3 * OUT_FRAMES), dtype=np.float32)
    mask = np.zeros((B, N, 1), dtype=np.float32)
    op_frames, faces = [], []
    for b, (ind, off) in enumerate(picks):
        seq = sequences[ind]
        n = seq[0]["V"].shape[0]
        for i in range(IN_FRAMES):
            inputs[b, :n, 3 * i : 3 * (i + 1)] = seq[off + i]["V"]
        for i in range(OUT_FRAMES):
            targets[b, :n, 3 * i : 3 * (i + 1)] = seq[off + IN_FRAMES + i]["V"]
        mask[b, :n] = 1.0
        op_frames.append(seq[off + IN_FRAMES - 1])
        faces.append({"F": seq[0]["F"]})
    if model == "dirac":
        operator = stack_dirac([_dirac_sample_operator(s, buckets, N, buckets.n_faces) for s in op_frames])
    else:
        operator = _lap_operator_batch([s["L"] for s in op_frames], buckets, N, fmt)
    return MeshBatch(inputs=torch.from_numpy(inputs), targets=torch.from_numpy(targets), mask=torch.from_numpy(mask),
                     operator=operator, faces=_pad_faces(faces, buckets), names=list(picks))


def correspondence_batch(sample: dict, buckets: Buckets, fmt: str = "ell",
                         op_dtype: torch.dtype | None = None, model: str = "lap") -> MeshBatch:
    """Single-shape batch (B=1) for the siamese trainer; ``targets`` is
    ``(G, label, label_inv)`` as the sample holds them.

    ``model`` is the trainer's operator key: ``"lap"`` packs ``sample["L"]``
    in ``fmt``; ``"amp"`` a list of fixed-K ELL operators, one per level of
    ``sample["L_pyr"]`` (``graph_ops.amp_pyramid``); ``"dirac"`` the packed
    Dirac tables (``fmt`` is not read for either).  ``fmt='bsr'`` packs the
    block-sparse operator: the sample must be RCM-ordered
    (``rcm_reorder_sample``), the bucket a multiple of 128 and
    ``buckets.bsr_k`` fitted; its blocks are stored at ``op_dtype``."""
    N = buckets.n_vertices
    n = sample["V"].shape[0]
    inputs = pad_rows(np.asarray(sample["input"], np.float32), N)[None]
    mask = np.zeros((1, N, 1), dtype=np.float32)
    mask[0, :n] = 1.0
    if model == "dirac":
        operator = stack_dirac([_dirac_sample_operator(sample, buckets, N, buckets.n_faces)])
    elif model == "amp":
        operator = [stack_operators([_fixed_k_operator(Lk, buckets, N)]) for Lk in sample["L_pyr"]]
    elif model != "lap":
        raise ValueError(f"unknown operator key {model!r}: expected 'lap', 'amp' or 'dirac'")
    elif fmt == "bsr":
        operator = stack_bsr_operators([_bsr_sample_operator(sample["L"], buckets, N, op_dtype)])
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
