"""Row-partitioned operators with halo exchange (counterpart of
``surfacenetworks_tpu/dist/edge_partition.py``).

One large mesh's operator rows are split contiguously over the ranks of the
graph axis and the vertex features are row-sharded alike; each SpMM needs
only the boundary band of the neighbouring partitions.  With RCM vertex
order the operator's bandwidth is O(sqrt N), so a halo of a few hundred rows
suffices.

Host side (a copy of the JAX package's packing, the same arrays bit for
bit): ``partition_ell`` splits each partition's rows in two,

* **interior rows**, every nonzero column inside the partition's own band:
  their ELL table indexes the LOCAL frame ``[0, n_loc)`` (boundary rows are
  zeroed there, so they contribute exactly +0.0);
* **boundary rows**, at least one column in a neighbour's band: a small side
  table (``bnd_rows`` / ``bnd_cols`` / ``bnd_vals``, ``Mb`` rows per
  partition, padded slots pointing at row 0 with zero values) whose columns
  index the extended frame ``[halo | local | halo]``.

``interior_fmt='bsr'`` packs each partition's interior as 128x128 block-ELL
in LOCAL block coordinates too (the partition size must be a multiple of
128).  Every array is stored over the global row dim (optionally with a
leading mesh-batch axis); ``shard_partitioned`` cuts out a rank's rows.

Device side: ``partitioned_spmm(op, x_loc)`` applies a rank's shard inside
the graph-sharded context (``parallel_context``), as the JAX function does
inside ``shard_map``: it issues the halo exchange (each rank sends its last
``halo`` rows to the next rank and its first ``halo`` rows to the previous
one; chain ends receive zeros) with ``dist.batch_isend_irecv`` on the graph
axis's group, runs the interior product on ``x_loc`` meanwhile, waits, runs
the boundary product on ``[from_left | x_loc | from_right]`` and adds it
into the boundary rows with ``index_add_``.  Each boundary row appears once
and the padded slots add 0.0 to row 0, so the sum is the same on every run.
Every local product goes through the port's kernels (``ell_matmul`` for the
ELL interior and the boundary table, ``bsr_matmul`` for a BSR interior): a
CUDA tensor launches the hand kernel or raises.  The backward applies the
identically partitioned stored transpose and casts the cotangent back to
the primal dtype.  On a staged (gloo-on-a-card) axis the exchanged rows go
through pinned host buffers: the rows to send are copied out, the interior
kernel is queued on the card, and the host then sends and waits while it
runs.  ``exchange_stats`` counts the exchanges, their rows, bytes and host
seconds.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from surfacenetworks_tpu_torch import parallel_context
from surfacenetworks_tpu_torch.parallel_context import Axis
from surfacenetworks_tpu_torch.sparse import kernels


@dataclasses.dataclass
class PartitionedEll:
    """Row-sharded ELL split into interior and boundary rows (see the module
    docstring); ``halo`` and ``n_parts`` are static, ``axis`` the name of
    the grid axis the rows are sharded over."""

    cols: torch.Tensor  # int32 [..., N, K], LOCAL frame, boundary rows zeroed
    vals: torch.Tensor  # f32 [..., N, K]
    bnd_rows: torch.Tensor  # int32 [..., n_parts*Mb], partition-local row indices
    bnd_cols: torch.Tensor  # int32 [..., n_parts*Mb, K], extended frame
    bnd_vals: torch.Tensor  # f32 [..., n_parts*Mb, K]
    bsr_cols: torch.Tensor | None = None  # int32 [..., N/bs, KB], LOCAL block frame
    bsr_vals: torch.Tensor | None = None  # f32 [..., N/bs, KB, bs, bs]
    halo: int = 0
    n_parts: int = 1
    axis: str = "graph"

    def to(self, device, non_blocking: bool = False) -> "PartitionedEll":
        def mv(t):
            return None if t is None else t.to(device, non_blocking=non_blocking)
        return dataclasses.replace(self, **{f: mv(getattr(self, f)) for f in _TENSOR_FIELDS})


_TENSOR_FIELDS = ("cols", "vals", "bnd_rows", "bnd_cols", "bnd_vals", "bsr_cols", "bsr_vals")


@dataclasses.dataclass
class PartitionedOperator:
    fwd: PartitionedEll
    bwd: PartitionedEll

    def to(self, device, non_blocking: bool = False) -> "PartitionedOperator":
        return PartitionedOperator(self.fwd.to(device, non_blocking), self.bwd.to(device, non_blocking))


def matrix_bandwidth(M: sp.spmatrix) -> int:
    """max |row - col| over nonzeros (0 for empty/diagonal matrices)."""
    coo = M.tocoo()
    if coo.nnz == 0:
        return 0
    return int(np.abs(coo.row - coo.col).max())


def suggest_halo(M: sp.spmatrix, multiple: int = 8) -> int:
    """Smallest sufficient halo for a (reordered) operator: its bandwidth,
    rounded up.  RCM-reorder first: an unordered mesh operator has
    bandwidth ~N."""
    bw = max(matrix_bandwidth(M), 1)
    return ((bw + multiple - 1) // multiple) * multiple


def _round_up_int(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def partition_ell(
    M: sp.spmatrix,
    n_parts: int,
    halo: int,
    k: int = 16,
    n_rows: int | None = None,
    axis: str = "graph",
    interior_fmt: str = "ell",
    block_size: int = 128,
) -> PartitionedEll:
    """Pack a square operator into interior/boundary row partitions.

    Requires the (reordered) matrix bandwidth to be <= halo; raises
    otherwise.  ``interior_fmt='bsr'`` also packs each partition's interior
    as LOCAL-frame block-ELL (the partition size must be a multiple of
    ``block_size``)."""
    M = M.tocsr().astype(np.float32)
    N = n_rows if n_rows is not None else M.shape[0]
    if N % n_parts:
        raise ValueError(f"padded size {N} not divisible by {n_parts} partitions")
    n_loc = N // n_parts
    if halo > n_loc:
        raise ValueError(f"halo {halo} larger than partition size {n_loc}")
    Mp = sp.csr_matrix(M)
    Mp.resize((N, N))
    Mp.sum_duplicates()
    bw = matrix_bandwidth(Mp)
    if bw > halo:
        raise ValueError(f"operator bandwidth {bw} exceeds halo {halo}; RCM-reorder first")
    csr = Mp.tocsr()
    deg = np.diff(csr.indptr)
    if deg.size and deg.max() > k:
        raise ValueError(f"ELL k={k} smaller than max row degree {deg.max()}")
    row_of = np.repeat(np.arange(N), deg)
    slot = np.arange(csr.indptr[-1]) - np.repeat(csr.indptr[:-1], deg)
    part = row_of // n_loc
    ext_col = csr.indices - part * n_loc + halo  # extended-frame column
    assert (ext_col >= 0).all() and (ext_col < n_loc + 2 * halo).all()

    # full-row ELL in extended coordinates (the boundary table's layout)
    ext_cols = np.zeros((N, k), dtype=np.int32)
    ext_vals = np.zeros((N, k), dtype=np.float32)
    ext_cols[row_of, slot] = ext_col
    ext_vals[row_of, slot] = csr.data

    # boundary = any entry outside the local band [halo, halo + n_loc)
    is_bnd = np.zeros(N, dtype=bool)
    remote = (ext_col < halo) | (ext_col >= halo + n_loc)
    is_bnd[row_of[remote]] = True

    # interior table: local-frame columns; boundary rows zeroed
    cols = np.where(is_bnd[:, None], 0, np.maximum(ext_cols - halo, 0)).astype(np.int32)
    cols = np.where(ext_vals == 0, 0, cols)  # dead slots stay in bounds
    vals = np.where(is_bnd[:, None], 0.0, ext_vals).astype(np.float32)

    # boundary side table, Mb rows per partition (shared static width)
    per_part = is_bnd.reshape(n_parts, n_loc)
    mb = int(per_part.sum(axis=1).max(initial=0))
    mb = min(_round_up_int(mb, 8), n_loc) if mb else 0
    bnd_rows = np.zeros((n_parts, mb), dtype=np.int32)
    bnd_cols = np.zeros((n_parts, mb, k), dtype=np.int32)
    bnd_vals = np.zeros((n_parts, mb, k), dtype=np.float32)
    for p in range(n_parts):
        rloc = np.nonzero(per_part[p])[0]
        bnd_rows[p, : rloc.size] = rloc
        bnd_cols[p, : rloc.size] = ext_cols[p * n_loc + rloc]
        bnd_vals[p, : rloc.size] = ext_vals[p * n_loc + rloc]

    bsr_cols = bsr_vals = None
    if interior_fmt == "bsr":
        from surfacenetworks_tpu_torch.sparse.bsr import bsr_from_scipy

        if n_loc % block_size:
            raise ValueError(
                f"interior_fmt='bsr' needs partition size {n_loc} divisible by block size {block_size}"
            )
        # per-partition interior matrix in LOCAL coordinates (boundary rows
        # are all-zero here, matching the ELL interior exactly)
        mats = []
        for p in range(n_parts):
            rows = np.repeat(np.arange(n_loc), k)
            pc = cols[p * n_loc : (p + 1) * n_loc].reshape(-1)
            pv = vals[p * n_loc : (p + 1) * n_loc].reshape(-1)
            keep = pv != 0
            mats.append(sp.coo_matrix((pv[keep], (rows[keep], pc[keep])), shape=(n_loc, n_loc)).tocsr())
        packed = [bsr_from_scipy(m, block_size=block_size) for m in mats]
        kb = max(pm.block_cols.shape[-1] for pm in packed)
        packed = [bsr_from_scipy(m, block_size=block_size, k=kb) for m in mats]
        bsr_cols = torch.cat([pm.block_cols for pm in packed], dim=0)
        bsr_vals = torch.cat([pm.block_vals for pm in packed], dim=0)
    elif interior_fmt != "ell":
        raise ValueError(f"unknown interior_fmt {interior_fmt!r}")

    return PartitionedEll(
        cols=torch.from_numpy(cols),
        vals=torch.from_numpy(vals),
        bnd_rows=torch.from_numpy(bnd_rows.reshape(n_parts * mb)),
        bnd_cols=torch.from_numpy(bnd_cols.reshape(n_parts * mb, k)),
        bnd_vals=torch.from_numpy(bnd_vals.reshape(n_parts * mb, k)),
        bsr_cols=bsr_cols,
        bsr_vals=bsr_vals,
        halo=halo,
        n_parts=n_parts,
        axis=axis,
    )


def partition_operator(
    M: sp.spmatrix,
    n_parts: int,
    halo: int,
    k: int = 16,
    n_rows: int | None = None,
    axis: str = "graph",
    interior_fmt: str = "ell",
    block_size: int = 128,
) -> PartitionedOperator:
    return PartitionedOperator(
        fwd=partition_ell(M, n_parts, halo, k, n_rows, axis, interior_fmt, block_size),
        bwd=partition_ell(M.T.tocsr(), n_parts, halo, k, n_rows, axis, interior_fmt, block_size),
    )


def _repad_bnd(arr: torch.Tensor, n_parts: int, mb: int) -> torch.Tensor:
    """Re-pad a flat per-partition boundary array ``[n_parts*mb_old, ...]``
    to a new per-partition width ``mb`` (zero-padded at each partition's
    tail)."""
    mb_old = arr.shape[0] // n_parts
    if mb_old == mb:
        return arr
    out = torch.zeros((n_parts, mb) + tuple(arr.shape[1:]), dtype=arr.dtype)
    out[:, :mb_old] = arr.reshape((n_parts, mb_old) + tuple(arr.shape[1:]))
    return out.reshape((n_parts * mb,) + tuple(arr.shape[1:]))


def stack_partitioned(ops: list[PartitionedOperator], min_mb: int = 0, min_kb: int = 0) -> PartitionedOperator:
    """Batch per-mesh partitioned operators along a new leading axis (all
    must share halo / n_parts / padded shape; boundary tables are re-padded
    to the widest member).  ``min_mb`` / ``min_kb`` floor the boundary width
    and the BSR-interior block width so every batch over one dataset stacks
    to the same shapes."""

    def stack_ell(ms: list[PartitionedEll]) -> PartitionedEll:
        assert all(m.halo == ms[0].halo and m.n_parts == ms[0].n_parts for m in ms)
        n_parts = ms[0].n_parts
        mb = max(min_mb, max(m.bnd_rows.shape[0] // n_parts for m in ms))
        bsr_cols = bsr_vals = None
        if ms[0].bsr_vals is not None:
            kb = max(min_kb, max(m.bsr_cols.shape[-1] for m in ms))

            def pad_kb(a):
                pad = [0, 0] * (a.dim() - 2) + [0, kb - a.shape[1]]  # axis 1, last-first order
                return torch.nn.functional.pad(a, pad)

            bsr_cols = torch.stack([pad_kb(m.bsr_cols) for m in ms])
            bsr_vals = torch.stack([pad_kb(m.bsr_vals) for m in ms])
        return PartitionedEll(
            cols=torch.stack([m.cols for m in ms]),
            vals=torch.stack([m.vals for m in ms]),
            bnd_rows=torch.stack([_repad_bnd(m.bnd_rows, n_parts, mb) for m in ms]),
            bnd_cols=torch.stack([_repad_bnd(m.bnd_cols, n_parts, mb) for m in ms]),
            bnd_vals=torch.stack([_repad_bnd(m.bnd_vals, n_parts, mb) for m in ms]),
            bsr_cols=bsr_cols,
            bsr_vals=bsr_vals,
            halo=ms[0].halo,
            n_parts=ms[0].n_parts,
            axis=ms[0].axis,
        )

    return PartitionedOperator(fwd=stack_ell([o.fwd for o in ops]), bwd=stack_ell([o.bwd for o in ops]))


# ---------------------------------------------------------------------------
# a rank's shard
# ---------------------------------------------------------------------------


def _shard_ell(m: PartitionedEll, index: int, batch: slice | None) -> PartitionedEll:
    """Rows ``index`` of ``m.n_parts`` of every array (and, batched, the
    mesh-batch slice ``batch``), contiguous."""
    batched = m.cols.dim() == 3

    def cut(t):
        if t is None:
            return None
        if batched and batch is not None:
            t = t[batch]
        dim = 1 if batched else 0
        n = t.shape[dim] // m.n_parts
        return t.narrow(dim, index * n, n).contiguous()

    return dataclasses.replace(m, **{f: cut(getattr(m, f)) for f in _TENSOR_FIELDS})


def shard_partitioned(op: PartitionedOperator, index: int, batch: slice | None = None) -> PartitionedOperator:
    """Partition ``index``'s shard of a (global) partitioned operator: the
    rows a rank at that position of the graph axis holds (and, for a
    batched operator, its mesh-batch slice ``batch``)."""
    return PartitionedOperator(_shard_ell(op.fwd, index, batch), _shard_ell(op.bwd, index, batch))


def shard_rows(x: torch.Tensor, n_parts: int, index: int) -> torch.Tensor:
    """Rows ``index`` of ``n_parts`` of ``x`` along its row axis (-2)."""
    n = x.shape[-2] // n_parts
    return x.narrow(-2, index * n, n).contiguous()


# ---------------------------------------------------------------------------
# device side: a rank's shard inside the graph-sharded context
# ---------------------------------------------------------------------------

exchange_stats = {"exchanges": 0, "rows": 0, "bytes": 0, "host_s": 0.0}


def reset_exchange_stats() -> None:
    exchange_stats.update(exchanges=0, rows=0, bytes=0, host_s=0.0)


class _Exchange:
    """One halo exchange in flight: the constructor issues it (the sends of
    this rank's edge rows and the receives of its neighbours'), ``wait``
    returns ``(from_left, from_right)`` on ``x``'s device, zeros at the
    chain's ends.  ``sends=(to_left, to_right)`` sends those ``[..., halo,
    C]`` tensors instead of ``x_loc``'s first and last ``halo`` rows (the
    backward of ``halo_exchange``: each halo's cotangent goes back to the
    rank that owns its rows)."""

    def __init__(self, x_loc: torch.Tensor | None, halo: int, axis: Axis,
                 sends: tuple[torch.Tensor, torch.Tensor] | None = None):
        import torch.distributed as dist

        t0 = time.perf_counter()
        send_left, send_right = sends if sends is not None else (x_loc[..., :halo, :], x_loc[..., -halo:, :])
        self.device, self.dtype = send_left.device, send_left.dtype
        shape, itemsize = send_left.shape, send_left.element_size()
        self.staged = axis.staged and send_left.is_cuda
        host = self.staged
        nxt = axis.index + 1 < axis.size
        prv = axis.index > 0
        if host:  # pinned copies out, then the interior can be queued while they land
            pin = {"pin_memory": True}
            send_right_h = torch.empty(shape, dtype=self.dtype, **pin) if nxt else None
            send_left_h = torch.empty(shape, dtype=self.dtype, **pin) if prv else None
            if nxt:
                send_right_h.copy_(send_right, non_blocking=True)
            if prv:
                send_left_h.copy_(send_left, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record()
            send_right, send_left = send_right_h, send_left_h
            alloc = {"dtype": self.dtype, "pin_memory": True}
        else:
            send_right = send_right.contiguous()
            send_left = send_left.contiguous()
            alloc = {"dtype": self.dtype, "device": self.device}
        self.from_left = torch.zeros(shape, **alloc)
        self.from_right = torch.zeros(shape, **alloc)
        ops = []
        if nxt:
            peer = axis.ranks[axis.index + 1]
            ops += [dist.P2POp(dist.isend, send_right, peer, axis.group),
                    dist.P2POp(dist.irecv, self.from_right, peer, axis.group)]
        if prv:
            peer = axis.ranks[axis.index - 1]
            ops += [dist.P2POp(dist.isend, send_left, peer, axis.group),
                    dist.P2POp(dist.irecv, self.from_left, peer, axis.group)]
        self.ops, self.reqs = ops, None
        if not host:
            self.reqs = dist.batch_isend_irecv(ops) if ops else []
        n_rows = (int(nxt) + int(prv)) * halo * int(np.prod(shape[:-2], dtype=np.int64))
        exchange_stats["exchanges"] += 1
        exchange_stats["rows"] += n_rows
        exchange_stats["bytes"] += n_rows * shape[-1] * itemsize
        exchange_stats["host_s"] += time.perf_counter() - t0

    def wait(self) -> tuple[torch.Tensor, torch.Tensor]:
        import torch.distributed as dist

        t0 = time.perf_counter()
        if self.reqs is None:  # staged: the copies out must have landed before the sends
            self.copied.synchronize()
            self.reqs = dist.batch_isend_irecv(self.ops) if self.ops else []
        for r in self.reqs:
            r.wait()
        left, right = self.from_left, self.from_right
        if self.staged:
            left = left.to(self.device, non_blocking=True)
            right = right.to(self.device, non_blocking=True)
        exchange_stats["host_s"] += time.perf_counter() - t0
        return left, right


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_loc: torch.Tensor, halo: int, axis: Axis) -> torch.Tensor:
        ctx.halo, ctx.axis = halo, axis
        left, right = _Exchange(x_loc, halo, axis).wait()
        return torch.cat([left, x_loc, right], dim=-2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h = ctx.halo
        g = g.contiguous()
        # each halo's cotangent goes back to the rank that sent its rows; the
        # chain's ends received zeros, and their cotangents are dropped
        from_prev, from_next = _Exchange(None, h, ctx.axis, sends=(g[..., :h, :], g[..., -h:, :])).wait()
        x_bar = g[..., h:-h, :].clone()
        x_bar[..., :h, :] += from_prev
        x_bar[..., -h:, :] += from_next
        return x_bar, None, None


def halo_exchange(x_loc: torch.Tensor, halo: int, axis: Axis) -> torch.Tensor:
    """``[from_left | x_loc | from_right]``: this rank's rows framed by its
    neighbours' ``halo`` edge rows (zeros at the chain's ends), as an
    autograd Function.  Its backward sends each halo's cotangent back to the
    rank that owns those rows, which adds it into its first or last ``halo``
    rows (the transpose of the exchange, what JAX differentiates through
    ``ppermute``)."""
    return _HaloExchange.apply(x_loc.contiguous(), halo, axis)


def _interior(m: PartitionedEll, x_loc: torch.Tensor) -> torch.Tensor:
    if m.bsr_vals is not None:
        xb = x_loc if m.bsr_vals.dtype == torch.bfloat16 else x_loc.to(torch.promote_types(x_loc.dtype,
                                                                                           m.bsr_vals.dtype))
        return kernels.bsr_matmul(m.bsr_cols, m.bsr_vals, xb)
    return kernels.ell_matmul(m.cols, m.vals, x_loc)


def _scatter_add_rows(y: torch.Tensor, rows: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """``y[..., rows[i], :] += upd[..., i, :]`` per batch item, in place."""
    if rows.dim() == 1:
        return y.index_add_(0, rows.long(), upd)
    B, n, c = y.shape
    flat = (rows.long() + torch.arange(B, device=rows.device)[:, None] * n).reshape(-1)
    y.view(B * n, c).index_add_(0, flat, upd.reshape(-1, c))
    return y


def _apply_local(m: PartitionedEll, x_loc: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """Interior/boundary split apply: the exchange issued, the interior
    product on ``x_loc`` meanwhile, then the boundary rows."""
    need = m.halo > 0 and m.bnd_rows.shape[-1] > 0
    if need and (axis is None or axis.size != m.n_parts):
        raise RuntimeError(f"partitioned_spmm: an operator of {m.n_parts} partitions needs a graph axis of "
                           f"{m.n_parts} ranks in the sharded context, got {None if axis is None else axis.size}")
    exchange = _Exchange(x_loc, m.halo, axis) if need else None
    y = _interior(m, x_loc)
    if exchange is None:
        return y
    from_left, from_right = exchange.wait()
    x_ext = torch.cat([from_left, x_loc, from_right], dim=-2)
    y_bnd = kernels.ell_matmul(m.bnd_cols, m.bnd_vals, x_ext)
    return _scatter_add_rows(y, m.bnd_rows, y_bnd.to(y.dtype))


class _PartitionedApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: PartitionedOperator, x_loc: torch.Tensor, axis: Axis | None) -> torch.Tensor:
        ctx.op, ctx.axis, ctx.dtype = op, axis, x_loc.dtype
        return _apply_local(op.fwd, x_loc.contiguous(), axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return None, _apply_local(ctx.op.bwd, g.contiguous(), ctx.axis).to(ctx.dtype), None


def partitioned_spmm(op: PartitionedOperator, x_loc: torch.Tensor) -> torch.Tensor:
    """``L @ x`` on a rank's row shard, inside the graph-sharded context.

    ``x_loc [..., n_loc, C]`` and ``op``'s arrays are this rank's shards
    (``shard_partitioned``); the halo band is exchanged over the context's
    vertex axis.  The backward multiplies the cotangent by the identically
    partitioned stored transpose."""
    m = op.fwd
    if m.cols.dim() != x_loc.dim() or m.cols.shape[-2] != x_loc.shape[-2]:
        raise ValueError(f"partitioned_spmm: operator shard {tuple(m.cols.shape)} and x {tuple(x_loc.shape)} "
                         f"disagree")
    return _PartitionedApply.apply(op, x_loc, parallel_context.vertex_reduction_axis())


def make_partitioned_spmm(mesh):
    """``pspmm(op, x) -> [n_loc, C]``: one apply across the graph axis's
    ranks.  Every rank passes the same GLOBAL operator and ``x [N, C]``;
    each gets back its own rows."""

    def pspmm(op: PartitionedOperator, x: torch.Tensor) -> torch.Tensor:
        g = mesh.graph_index
        op_loc = shard_partitioned(op, g).to(mesh.device)
        x_loc = shard_rows(x, op.fwd.n_parts, g).to(mesh.device)
        with parallel_context.sharded_axes(vertex_axis=mesh.graph):
            return partitioned_spmm(op_loc, x_loc)

    return pspmm
