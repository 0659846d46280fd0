"""Plain PyTorch and NumPy pieces of the references: the operators worked out
again from the benchmark's meshes, the layers of Surface Networks
(Kostrikov et al., CVPR 2018) as the reference repository defines them, the
normal loss, the initialisation recipe and Adam.

Nothing here imports the program or its kernels.  The operators are SciPy
matrices, put on the device as CSR and applied with ``torch.sparse.mm``; the layers are matrix products
and explicit sums; autograd takes the gradients.  Every matrix product runs
with TF32 off unless the caller turns it on (the control).

Semantics that a padded batch gives (as in the reference repository, which
pads every batch to one vertex count): batch norm takes its statistics over
every row of the batch, padding rows included; the global average and the
loss take only the real vertices (``mask``).  Padding rows have zero
inputs, targets and operator rows and columns.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import scipy.sparse as sp
import torch

WIDTH = 128
BN_EPS = 1e-5
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


# ---------------------------------------------------------------------------
# geometry, from (V float64, F)
# ---------------------------------------------------------------------------


def face_area(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Triangle areas from the cross product of two edges."""
    return 0.5 * np.linalg.norm(np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]]), axis=1)


def vertex_normals(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (igl ``per_vertex_normals``, area
    weighting), unit length."""
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    n = np.zeros_like(V)
    for c in range(3):
        np.add.at(n, F[:, c], fn)
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)


def cot_laplacian(V: np.ndarray, F: np.ndarray, hack: float = 1.0) -> sp.csr_matrix:
    """The reference repository's operator (``hacky_compute_laplacian``):
    ``M^-1 C`` with igl's cotangent matrix ``C`` (off the diagonal
    ``(cot a + cot b) / 2`` over each edge's two opposite angles, on it minus
    the row's sum) and the barycentric mass ``M`` (a third of each incident
    face's area); entries that are not finite or exceed 1e10 in magnitude
    become ``hack``.  Stored in float32, as the reference stores it."""
    n = V.shape[0]
    area = face_area(V, F)
    rows, cols, vals = [], [], []
    for c in range(3):
        i, j = F[:, (c + 1) % 3], F[:, (c + 2) % 3]
        u, w = V[i] - V[F[:, c]], V[j] - V[F[:, c]]
        cot = (u * w).sum(axis=1) / (2.0 * area)  # cot of the angle at corner c = <u, w> / |u x w|
        half = cot / 2.0
        rows += [i, j, i, j]
        cols += [j, i, i, j]
        vals += [half, half, -half, -half]
    C = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)).tocsr()
    mass = np.zeros(n)
    for c in range(3):
        np.add.at(mass, F[:, c], area / 3.0)
    L = (sp.diags(1.0 / mass) @ C).tocsr().astype(np.float32)
    bad = ~np.isfinite(L.data) | (np.abs(L.data) > 1e10)
    L.data[bad] = hack
    return L


def quaternion_left(q: np.ndarray) -> np.ndarray:
    """``[..., 4] -> [..., 4, 4]``: the matrix of ``x -> q x`` (Hamilton
    product) on quaternions ``(w, x, y, z)``."""
    a, b, c, d = np.moveaxis(q, -1, 0)
    return np.stack([np.stack([a, -b, -c, -d], -1), np.stack([b, a, -d, c], -1),
                     np.stack([c, d, a, -b], -1), np.stack([d, -c, b, a], -1)], -2)


def dirac_pair(V: np.ndarray, F: np.ndarray) -> tuple[sp.coo_matrix, sp.coo_matrix]:
    """The extrinsic Dirac operator of the paper on quaternion rows: ``D``
    (``4M x 4N``, faces from vertices) with block ``(i, F[i, c])`` the
    left product by ``-e / (2 A_i)``, ``e`` the pure quaternion of the edge
    opposite corner ``c`` (``V[F[i, c+1]] - V[F[i, c+2]]``); and its adjoint
    ``DA`` (``4N x 4M``) under the area inner products, block ``(j, i)`` the
    left product by ``e / (2 A_j)``, ``A_j`` a third of the areas of the
    faces at vertex ``j``.  Both in float32, as coordinate lists."""
    n, m = V.shape[0], F.shape[0]
    area = face_area(V, F)
    av = np.zeros(n)
    for c in range(3):
        np.add.at(av, F[:, c], area / 3.0)
    e = np.stack([V[F[:, (c + 1) % 3]] - V[F[:, (c + 2) % 3]] for c in range(3)], axis=1)  # [M, 3, 3]
    q = np.zeros((m, 3, 4))
    q[..., 1:] = -e / (2.0 * area)[:, None, None]
    qa = np.zeros((m, 3, 4))
    qa[..., 1:] = e / (2.0 * av[F])[..., None]
    face = np.repeat(np.arange(m), 3)
    vert = F.reshape(-1)
    k = np.arange(4)

    def blocks(Q, rows_of, cols_of, shape):
        B = quaternion_left(Q.reshape(-1, 4))  # [3M, 4, 4]
        r = (4 * rows_of[:, None, None] + k[None, :, None]).repeat(4, axis=2)
        c = (4 * cols_of[:, None, None] + k[None, None, :]).repeat(4, axis=1)
        return sp.coo_matrix((B.ravel().astype(np.float32), (r.ravel(), c.ravel())), shape=shape)

    return blocks(q, face, vert, (4 * m, 4 * n)), blocks(qa, vert, face, (4 * n, 4 * m))


# ---------------------------------------------------------------------------
# sparse applies on the device
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparsePair:
    """A batch's matrices on one block diagonal, as a CSR matrix on the
    device, and its transpose (which takes the backward)."""

    a: torch.Tensor
    at: torch.Tensor

    @classmethod
    def batch(cls, mats: list, n_rows: int, n_cols: int, device, dtype) -> "SparsePair":
        """``mats`` (SciPy, one a mesh), each padded with zero rows and
        columns to ``n_rows x n_cols``, on one block diagonal."""
        coo = [m.tocoo() for m in mats]
        rows = np.concatenate([m.row.astype(np.int64) + k * n_rows for k, m in enumerate(coo)])
        cols = np.concatenate([m.col.astype(np.int64) + k * n_cols for k, m in enumerate(coo)])
        vals = torch.from_numpy(np.concatenate([m.data for m in coo])).to(device, dtype)
        rows, cols = torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)
        shape = (len(mats) * n_rows, len(mats) * n_cols)

        def csr(r, c, size):
            with warnings.catch_warnings():  # "CSR support is in beta": a notice, printed into every run's log
                warnings.simplefilter("ignore", UserWarning)
                return torch.sparse_coo_tensor(torch.stack([r, c]), vals, size,
                                               check_invariants=False).coalesce().to_sparse_csr()

        return cls(csr(rows, cols, shape), csr(cols, rows, shape[::-1]))


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair: SparsePair, x: torch.Tensor) -> torch.Tensor:
        ctx.pair = pair
        return torch.sparse.mm(pair.a, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return None, torch.sparse.mm(ctx.pair.at, g.contiguous())


def apply(pair: SparsePair, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for ``x [B, N, C]`` against the batch's block-diagonal
    ``A`` (``B R x B N``): ``[B, R, C]``."""
    b, _, c = x.shape
    out = _Apply.apply(pair, x.reshape(-1, c).contiguous())
    return out.reshape(b, -1, c)


def apply_quaternion(pair: SparsePair, x: torch.Tensor) -> torch.Tensor:
    """A Dirac matrix on features ``x [B, S, C]`` read as ``C / 4``
    quaternions per row, channel block ``k`` (``k C/4 .. (k+1) C/4``) the
    ``k``-th component: ``x`` viewed ``[B, 4 S, C / 4]``."""
    b, s, c = x.shape
    out = apply(pair, x.reshape(b, 4 * s, c // 4))
    return out.reshape(b, -1, c)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(torch.clamp(x, max=0.0)))


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Over every (batch, row) per channel: biased variance, eps 1e-5, the
    batch's own statistics always (the reference keeps batch norm in
    training mode)."""
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(0)
    var = ((flat - mean) ** 2).mean(0)
    return (x - mean) / torch.sqrt(var + BN_EPS) * weight + bias


def linear(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    return torch.matmul(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def conv(x: torch.Tensor, p: dict, name: str, pre_bn: bool) -> torch.Tensor:
    """The reference's ``GraphConv1x1``: an optional batch norm, then the
    per-vertex linear map."""
    if pre_bn:
        x = batch_norm(x, p[f"{name}.bn.weight"], p[f"{name}.bn.bias"])
    return linear(x, p, f"{name}.fc")


def masked_mean_rows(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over each mesh's real vertices: ``[B, 1, C]``."""
    return (x * mask).sum(1, keepdim=True) / mask.sum(1, keepdim=True)


def normal_loss(out: torch.Tensor, mask: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over every real vertex of the batch of ``1 - <n, t>^2``, ``n``
    the prediction scaled to unit length."""
    n = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)
    inner = (n * target).sum(-1)
    m = mask[..., 0]
    return ((1.0 - inner**2) * m).sum() / m.sum()


# ---------------------------------------------------------------------------
# initialisation and Adam
# ---------------------------------------------------------------------------


def deep_structure(layers: int, width: int = WIDTH) -> tuple[list, list]:
    """The normal models' maps: the linear maps (name, in, out) in their
    layer order (``conv1``, two in each block, ``conv2``) and the batch
    norms (name, channels) before all but ``conv1``."""
    linears = [("conv1.fc", 3, width)]
    norms = []
    for i in range(layers):
        for j in range(2):
            linears.append((f"rn{i}.bn_fc{j}.fc", 2 * width, width))
            norms.append((f"rn{i}.bn_fc{j}.bn", 2 * width))
    linears.append(("conv2.fc", width, 3))
    norms.append(("conv2.bn", width))
    return linears, norms


def init_params(linears: list[tuple[str, int, int]], norms: list[tuple[str, int]], device) -> dict:
    """The trainer's initialisation recipe: a CPU ``torch.Generator``
    seeded 0 draws each linear map's weight ``[out, in]`` from a standard
    normal, in the order of ``linears`` (the model's layer order), scaled by
    ``1 / sqrt(in)`` (LeCun normal); biases are zero, batch-norm scales one
    and shifts zero."""
    g = torch.Generator().manual_seed(0)
    p = {}
    for name, n_in, n_out in linears:
        p[f"{name}.weight"] = torch.randn((n_out, n_in), generator=g, dtype=torch.float32) / n_in**0.5
        p[f"{name}.bias"] = torch.zeros(n_out)
    for name, n in norms:
        p[f"{name}.weight"] = torch.ones(n)
        p[f"{name}.bias"] = torch.zeros(n)
    return {k: v.to(device).requires_grad_(True) for k, v in p.items()}


def adam_step(p: dict, state: dict, lr: float, t: int) -> None:
    """One Adam update (betas 0.9 and 0.999, eps 1e-8, no weight decay)
    from each leaf's ``.grad``."""
    b1, b2 = ADAM_BETAS
    with torch.no_grad():
        for k, w in p.items():
            g = w.grad
            m, v = state.setdefault(k, (torch.zeros_like(w), torch.zeros_like(w)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            w.sub_(lr * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + ADAM_EPS))


@dataclasses.dataclass
class Steps:
    """What a run of the first steps gives: each step's loss, each leaf's
    first gradient norm and each leaf's change after the steps (norms in
    float64)."""

    losses: list
    grad_norms: dict
    change_norms: dict


def train_steps(params: dict, loss_of, batches: list, lr: float) -> Steps:
    """``len(batches)`` Adam steps of ``loss_of(params, batch)``."""
    start = {k: w.detach().clone() for k, w in params.items()}
    state: dict = {}
    losses, grad_norms = [], {}
    for t, batch in enumerate(batches, start=1):
        for w in params.values():
            w.grad = None
        loss = loss_of(params, batch)
        loss.backward()
        losses.append(float(loss.detach()))
        if t == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(w.grad.double())) for k, w in params.items()}
        adam_step(params, state, lr, t)
    change = {k: float(torch.linalg.vector_norm((params[k].detach() - start[k]).double())) for k in params}
    return Steps(losses, grad_norms, change)


def median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])

