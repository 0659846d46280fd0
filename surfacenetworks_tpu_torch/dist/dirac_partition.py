"""Row-partitioned Dirac operator pair with two-sided halo exchange
(counterpart of ``surfacenetworks_tpu/dist/dirac_partition.py``).

Both streams of the quaternionic pair are row-sharded over the graph axis:

* **vertex rows** (features ``v [N, C]``, tables ``vf_face`` / ``q_vf`` /
  ``q_bwd_v``) shard into ``N / n_parts`` rows a rank;
* **face rows** (features ``f [M, C]``, tables ``faces`` / ``q_fv`` /
  ``q_bwd_f``) shard into ``M / n_parts`` rows a rank;

and each apply crosses the partition boundary in one direction:

* ``Di v`` (vertices -> faces): every face gathers its 3 vertices, so a
  rank exchanges a *vertex* halo of ``halo_v`` rows with its neighbours
  before the boundary faces are applied; the backward runs the vertex rows'
  stored adjoint tables (``vf_face``, ``q_bwd_v``, ``vbnd_*``) on the face
  cotangent, which needs a *face* halo of ``halo_f`` rows;
* ``DiA f`` (faces -> vertices) is the mirror image.

Host side (a copy of the JAX package's packing, the same arrays bit for
bit): ``partition_dirac`` splits each partition's rows of each table into
*interior* rows (every used slot inside the partition's own source band;
their table indexes the LOCAL frame, with the boundary rows' coefficients
zeroed so they contribute exactly 0) and *boundary* rows (a side table of
``Mb`` rows a partition, indexing the extended frame ``[halo | local |
halo]``).  Narrow halos need the vertices RCM-ordered and the faces sorted
by their smallest vertex (``sort_faces_for_partition``); the packer
measures the need per direction and refuses a halo that is too small.  The
packed-valence overflow is not supported here (its rows are global
indices), as in the JAX package.

Device side: ``partitioned_dirac_vf`` / ``partitioned_dirac_fv`` apply a
rank's shard inside the graph-sharded context (``parallel_context``), as
the JAX functions do inside ``shard_map``.  Each forward and each backward
is the split apply of ``edge_partition``: issue the exchange
(``edge_partition._Exchange``, staged through pinned host buffers on a
gloo axis that shares a card), gather-apply the interior rows on the local
frame meanwhile (``sparse/ops.py::_gather_apply``, plain PyTorch, as the
single-device Dirac apply: the JAX applies reach no Pallas kernel), wait,
apply the boundary side table on ``[from_left | local | from_right]`` and
add it into the boundary rows with ``index_add_`` (each boundary row once).
The operator is a constant; the cotangent goes back to the primal dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from surfacenetworks_tpu_torch import parallel_context
from surfacenetworks_tpu_torch.dist.edge_partition import _Exchange, _repad_bnd, _scatter_add_rows
from surfacenetworks_tpu_torch.geometry.mesh_ops import DiracCoeffs
from surfacenetworks_tpu_torch.parallel_context import Axis
from surfacenetworks_tpu_torch.sparse.ell import dirac_from_coeffs
from surfacenetworks_tpu_torch.sparse.ops import _gather_apply

_TENSOR_FIELDS = ("faces", "q_fv", "q_bwd_f", "fbnd_rows", "fbnd_verts", "fbnd_q_fv", "fbnd_q_bwd_f", "vf_face",
                  "q_vf", "q_bwd_v", "vbnd_rows", "vbnd_face", "vbnd_q_vf", "vbnd_q_bwd_v")


@dataclasses.dataclass
class PartitionedDirac:
    """Row-sharded Dirac pair split into interior and boundary rows (see the
    module docstring); a leading batch axis on every array is allowed.
    Padded and unused slots carry zero coefficients and point at an
    in-bounds row."""

    faces: torch.Tensor  # int32 [..., M, 3], LOCAL vertex frame, boundary faces zeroed
    q_fv: torch.Tensor  # f32 [..., M, 3, 4]
    q_bwd_f: torch.Tensor  # f32 [..., M, 3, 4]
    fbnd_rows: torch.Tensor  # int32 [..., n_parts*Mbf], partition-local face rows
    fbnd_verts: torch.Tensor  # int32 [..., n_parts*Mbf, 3], extended vertex frame
    fbnd_q_fv: torch.Tensor  # f32 [..., n_parts*Mbf, 3, 4]
    fbnd_q_bwd_f: torch.Tensor  # f32 [..., n_parts*Mbf, 3, 4]
    vf_face: torch.Tensor  # int32 [..., N, Kv], LOCAL face frame, boundary vertices zeroed
    q_vf: torch.Tensor  # f32 [..., N, Kv, 4]
    q_bwd_v: torch.Tensor  # f32 [..., N, Kv, 4]
    vbnd_rows: torch.Tensor  # int32 [..., n_parts*Mbv], partition-local vertex rows
    vbnd_face: torch.Tensor  # int32 [..., n_parts*Mbv, Kv], extended face frame
    vbnd_q_vf: torch.Tensor  # f32 [..., n_parts*Mbv, Kv, 4]
    vbnd_q_bwd_v: torch.Tensor  # f32 [..., n_parts*Mbv, Kv, 4]
    halo_v: int = 0
    halo_f: int = 0
    n_parts: int = 1
    axis: str = "graph"

    def to(self, device, non_blocking: bool = False) -> "PartitionedDirac":
        return dataclasses.replace(self, **{f: getattr(self, f).to(device, non_blocking=non_blocking)
                                            for f in _TENSOR_FIELDS})


def sort_faces_for_partition(F: np.ndarray) -> np.ndarray:
    """Stable face order by smallest vertex index: after an RCM vertex
    order the face index then follows the vertex index, so both halos stay
    near the mesh's bandwidth."""
    return np.argsort(np.asarray(F).min(axis=1), kind="stable")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _halo_need(table: np.ndarray, used: np.ndarray, n_parts: int, n_src: int) -> int:
    """Smallest halo such that every used slot of every row lands inside its
    partition's extended source frame."""
    R = table.shape[0]
    part = np.arange(R) // (R // n_parts)
    off = table - part[:, None] * (n_src // n_parts)
    lo = int(np.where(used, -off, 0).max(initial=0))
    hi = int(np.where(used, off - n_src // n_parts + 1, 0).max(initial=0))
    return max(lo, hi, 0)


def _split_rows(table: np.ndarray, used: np.ndarray, n_parts: int, n_src: int, halo: int,
                coeffs: list[np.ndarray]):
    """One incidence table's rows split into interior and boundary:
    ``(int_table, int_coeffs, bnd_rows, bnd_table, bnd_coeffs)``, the
    interior in the LOCAL source frame with boundary rows (and their
    coefficients) zeroed, the boundary side table (flat ``[n_parts * Mb]``)
    in the extended frame."""
    R, S = table.shape
    n_loc_r = R // n_parts
    src_loc = n_src // n_parts
    part = np.arange(R) // n_loc_r
    ext = (table - part[:, None] * src_loc + halo).astype(np.int64)
    if used.any():
        mn, mx = int(ext[used].min()), int(ext[used].max())
        if mn < 0 or mx >= src_loc + 2 * halo:
            raise ValueError(f"halo {halo} too small for incidence span (RCM-reorder vertices "
                             "and sort faces with sort_faces_for_partition first)")
    remote = used & ((ext < halo) | (ext >= halo + src_loc))
    is_bnd = remote.any(axis=1)

    int_table = np.where(used & ~is_bnd[:, None], ext - halo, 0).astype(np.int32)
    int_coeffs = [np.where(is_bnd[:, None, None], 0.0, q).astype(np.float32) for q in coeffs]

    ext_safe = np.where(used, ext, halo).astype(np.int32)  # unused slots in bounds
    per_part = is_bnd.reshape(n_parts, n_loc_r)
    mb = int(per_part.sum(axis=1).max(initial=0))
    mb = min(_round_up(mb, 8), n_loc_r) if mb else 0
    bnd_rows = np.zeros((n_parts, mb), dtype=np.int32)
    bnd_table = np.full((n_parts, mb, S), halo, dtype=np.int32)
    bnd_coeffs = [np.zeros((n_parts, mb) + q.shape[1:], dtype=np.float32) for q in coeffs]
    for p in range(n_parts):
        rloc = np.nonzero(per_part[p])[0]
        bnd_rows[p, : rloc.size] = rloc
        bnd_table[p, : rloc.size] = ext_safe[p * n_loc_r + rloc]
        for bq, q in zip(bnd_coeffs, coeffs):
            bq[p, : rloc.size] = q[p * n_loc_r + rloc]

    def flat(a):
        return a.reshape((n_parts * mb,) + a.shape[2:])

    return int_table, int_coeffs, flat(bnd_rows), flat(bnd_table), [flat(bq) for bq in bnd_coeffs]


def partition_dirac(coeffs: DiracCoeffs, n_parts: int, n_vertices: int, n_faces: int, halo_v: int | None = None,
                    halo_f: int | None = None, max_valence: int | None = None,
                    axis: str = "graph") -> PartitionedDirac:
    """Host-side Dirac coefficients packed into a row-partitioned operator.

    ``n_vertices`` / ``n_faces`` are the padded (bucketed) sizes and must be
    divisible by ``n_parts``.  ``halo_v`` / ``halo_f`` default to the
    measured need rounded up to a multiple of 8; a given halo below the need
    raises, as does a halo wider than a partition."""
    if n_vertices % n_parts or n_faces % n_parts:
        raise ValueError(f"padded sizes ({n_vertices}, {n_faces}) not divisible by {n_parts}")
    op = dirac_from_coeffs(coeffs, n_vertices, n_faces, max_valence)
    t = {k: getattr(op, k).numpy() for k in ("faces", "q_fv", "q_bwd_f", "vf_face", "q_vf", "q_bwd_v")}
    # the bwd tables share the incidence tables, so the halo must cover
    # every slot either direction uses
    used_v = (t["q_fv"] != 0).any(-1) | (t["q_bwd_f"] != 0).any(-1)  # face rows
    used_f = (t["q_vf"] != 0).any(-1) | (t["q_bwd_v"] != 0).any(-1)  # vertex rows
    need_v = _halo_need(t["faces"].reshape(n_faces, 3), used_v, n_parts, n_vertices)
    need_f = _halo_need(t["vf_face"], used_f, n_parts, n_faces)
    halo_v = _round_up(max(need_v, 1), 8) if halo_v is None else halo_v
    halo_f = _round_up(max(need_f, 1), 8) if halo_f is None else halo_f
    if halo_v > n_vertices // n_parts or halo_f > n_faces // n_parts:
        raise ValueError(f"halos ({halo_v}, {halo_f}) exceed partition sizes "
                         f"({n_vertices // n_parts}, {n_faces // n_parts})")
    faces_int, (q_fv_int, q_bwd_f_int), fbnd_rows, fbnd_verts, (fbnd_q_fv, fbnd_q_bwd_f) = _split_rows(
        t["faces"].reshape(n_faces, 3), used_v, n_parts, n_vertices, halo_v, [t["q_fv"], t["q_bwd_f"]])
    vf_int, (q_vf_int, q_bwd_v_int), vbnd_rows, vbnd_face, (vbnd_q_vf, vbnd_q_bwd_v) = _split_rows(
        t["vf_face"], used_f, n_parts, n_faces, halo_f, [t["q_vf"], t["q_bwd_v"]])
    arrays = dict(faces=faces_int, q_fv=q_fv_int, q_bwd_f=q_bwd_f_int, fbnd_rows=fbnd_rows, fbnd_verts=fbnd_verts,
                  fbnd_q_fv=fbnd_q_fv, fbnd_q_bwd_f=fbnd_q_bwd_f, vf_face=vf_int, q_vf=q_vf_int,
                  q_bwd_v=q_bwd_v_int, vbnd_rows=vbnd_rows, vbnd_face=vbnd_face, vbnd_q_vf=vbnd_q_vf,
                  vbnd_q_bwd_v=vbnd_q_bwd_v)
    return PartitionedDirac(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()},
                            halo_v=halo_v, halo_f=halo_f, n_parts=n_parts, axis=axis)


def stack_partitioned_dirac(ops: list[PartitionedDirac], min_mbf: int = 0, min_mbv: int = 0) -> PartitionedDirac:
    """Per-mesh partitioned Dirac operators batched along a new leading axis
    (all with the same halos and partitions), the boundary side tables
    re-padded to the widest member; ``min_mbf`` / ``min_mbv`` floor the
    widths, so every batch over one dataset stacks to the same shapes."""
    first = ops[0]
    if not all(o.halo_v == first.halo_v and o.halo_f == first.halo_f and o.n_parts == first.n_parts for o in ops):
        raise ValueError("stack_partitioned_dirac: the operators' halos or partitions differ")
    n_parts = first.n_parts
    mbf = max(min_mbf, max(o.fbnd_rows.shape[0] // n_parts for o in ops))
    mbv = max(min_mbv, max(o.vbnd_rows.shape[0] // n_parts for o in ops))

    def stacked(name):
        width = mbf if name.startswith("fbnd") else mbv if name.startswith("vbnd") else None
        return torch.stack([getattr(o, name) if width is None else _repad_bnd(getattr(o, name), n_parts, width)
                            for o in ops])

    return PartitionedDirac(**{f: stacked(f) for f in _TENSOR_FIELDS}, halo_v=first.halo_v, halo_f=first.halo_f,
                            n_parts=n_parts, axis=first.axis)


def shard_partitioned_dirac(op: PartitionedDirac, index: int, batch: slice | None = None) -> PartitionedDirac:
    """Partition ``index``'s shard: its rows of every table (vertex, face
    and boundary tables alike cut along their leading row axis into
    ``n_parts``) and, batched, the mesh-batch slice ``batch``."""
    batched = op.faces.dim() == 3

    def cut(t):
        if batched and batch is not None:
            t = t[batch]
        dim = 1 if batched else 0
        n = t.shape[dim] // op.n_parts
        return t.narrow(dim, index * n, n).contiguous()

    return dataclasses.replace(op, **{f: cut(getattr(op, f)) for f in _TENSOR_FIELDS})


# ---------------------------------------------------------------------------
# device side: a rank's shard inside the graph-sharded context
# ---------------------------------------------------------------------------


def _split_apply(int_tbl, int_q, bnd_rows, bnd_tbl, bnd_q, x_loc: torch.Tensor, halo: int, n_parts: int,
                 axis: Axis | None) -> torch.Tensor:
    """The interior/boundary split apply: the exchange issued, the interior
    gather-apply on ``x_loc`` meanwhile, then the boundary side table on the
    extended frame, added into its rows."""
    need = halo > 0 and bnd_rows.shape[-1] > 0
    if need and (axis is None or axis.size != n_parts):
        raise RuntimeError(f"partitioned Dirac apply: an operator of {n_parts} partitions needs a graph axis of "
                           f"{n_parts} ranks in the sharded context, got {None if axis is None else axis.size}")
    exchange = _Exchange(x_loc, halo, axis) if need else None
    y = _gather_apply(int_tbl, int_q, x_loc)
    if exchange is None:
        return y
    from_left, from_right = exchange.wait()
    y_bnd = _gather_apply(bnd_tbl, bnd_q, torch.cat([from_left, x_loc, from_right], dim=-2))
    return _scatter_add_rows(y.contiguous(), bnd_rows, y_bnd.to(y.dtype))


def _face_side(op: PartitionedDirac, q: torch.Tensor, bnd_q: torch.Tensor, v: torch.Tensor, axis) -> torch.Tensor:
    """Faces <- vertices through the face tables (``Di v`` with ``q_fv``,
    the backward of ``DiA`` with ``q_bwd_f``): a vertex halo."""
    return _split_apply(op.faces, q, op.fbnd_rows, op.fbnd_verts, bnd_q, v, op.halo_v, op.n_parts, axis)


def _vertex_side(op: PartitionedDirac, q: torch.Tensor, bnd_q: torch.Tensor, f: torch.Tensor, axis) -> torch.Tensor:
    """Vertices <- faces through the vertex tables (``DiA f`` with ``q_vf``,
    the backward of ``Di`` with ``q_bwd_v``): a face halo."""
    return _split_apply(op.vf_face, q, op.vbnd_rows, op.vbnd_face, bnd_q, f, op.halo_f, op.n_parts, axis)


class _PartitionedVF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: PartitionedDirac, v_loc: torch.Tensor, axis: Axis | None) -> torch.Tensor:
        ctx.op, ctx.axis, ctx.dtype = op, axis, v_loc.dtype
        return _face_side(op, op.q_fv, op.fbnd_q_fv, v_loc.contiguous(), axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        op = ctx.op
        return None, _vertex_side(op, op.q_bwd_v, op.vbnd_q_bwd_v, g.contiguous(), ctx.axis).to(ctx.dtype), None


class _PartitionedFV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: PartitionedDirac, f_loc: torch.Tensor, axis: Axis | None) -> torch.Tensor:
        ctx.op, ctx.axis, ctx.dtype = op, axis, f_loc.dtype
        return _vertex_side(op, op.q_vf, op.vbnd_q_vf, f_loc.contiguous(), axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        op = ctx.op
        return None, _face_side(op, op.q_bwd_f, op.fbnd_q_bwd_f, g.contiguous(), ctx.axis).to(ctx.dtype), None


def _check(op: PartitionedDirac, x: torch.Tensor, rows: int, what: str) -> None:
    if x.shape[-1] % 4:
        raise ValueError(f"{what}: channels {x.shape[-1]} not divisible by 4")
    if op.faces.dim() != x.dim() or x.shape[-2] != rows:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not fit the operator shard's faces "
                         f"{tuple(op.faces.shape)} and incidence {tuple(op.vf_face.shape)}")


def partitioned_dirac_vf(op: PartitionedDirac, v_loc: torch.Tensor) -> torch.Tensor:
    """``Di @ v`` on a rank's row shards, inside the graph-sharded context:
    ``v_loc [..., n_loc_v, C]`` (C % 4 == 0) -> ``[..., m_loc, C]``; the
    backward exchanges a face halo."""
    _check(op, v_loc, op.vf_face.shape[-2], "partitioned_dirac_vf")
    return _PartitionedVF.apply(op, v_loc, parallel_context.vertex_reduction_axis())


def partitioned_dirac_fv(op: PartitionedDirac, f_loc: torch.Tensor) -> torch.Tensor:
    """``DiA @ f`` on a rank's row shards: ``f_loc [..., m_loc, C]`` ->
    ``[..., n_loc_v, C]``; the backward exchanges a vertex halo."""
    _check(op, f_loc, op.faces.shape[-2], "partitioned_dirac_fv")
    return _PartitionedFV.apply(op, f_loc, parallel_context.vertex_reduction_axis())
