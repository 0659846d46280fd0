"""The yardstick's arithmetic: operations and bytes counted from the
configuration's shapes and the meshes' real (unpadded) sizes, and the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
the full 700 W power limit).

Counts depend on the meshes and the model only, never on the format or the
kernels the program picks, so padding, dead block entries and work done
twice count as waste.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores: the port turns TF32 off
INDEX_BYTES = 4  # int32 column index
VALUE_BYTES = 4  # fp32
QUATERNION_BYTES = 4 * VALUE_BYTES
PEAK_FLOP_PER_S = {"float32": FP32_FLOP_PER_S}


def mesh_edges(F: np.ndarray) -> int:
    """Undirected edges of a triangle mesh."""
    e = np.sort(np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]]), axis=1)
    return int(np.unique(e, axis=0).shape[0])


def laplacian_nnz(n_vertices: int, n_edges: int) -> int:
    """Nonzeros of the cotangent Laplacian: the diagonal and both
    directions of every edge."""
    return n_vertices + 2 * n_edges


def conv_flops(rows: int, n_in: int, n_out: int, input_grad: bool = True) -> int:
    """One per-vertex linear map over ``rows`` rows, forward and backward:
    ``2 in out`` a row forward, the same again for the weights' gradient,
    and once more for the input's gradient where the input needs one."""
    return rows * 2 * n_in * n_out * (3 if input_grad else 2)


def apply_flops(nnz: int, channels: int) -> int:
    return 2 * nnz * channels


def lap_apply_bytes(n_vertices: int, nnz: int, channels: int) -> int:
    """One Laplacian apply on one mesh at its least: every nonzero's index
    and value read once, x read once, the result written once."""
    return nnz * (INDEX_BYTES + VALUE_BYTES) + 2 * n_vertices * channels * VALUE_BYTES


def dirac_apply_bytes(rows_in: int, rows_out: int, live: int, channels: int) -> int:
    """One Dirac apply on one mesh at its least: each live quaternion
    coefficient (one per face corner) and its row index read once, the
    features read once, the result written once."""
    return live * (QUATERNION_BYTES + INDEX_BYTES) + (rows_in + rows_out) * channels * VALUE_BYTES


def dirac_apply_flops(live: int, channels: int) -> int:
    """A 4 x 4 Hamilton block on ``channels / 4`` quaternions per live
    coefficient: ``2 * 16 * channels / 4``."""
    return live * 8 * channels


def bound_s(n_bytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S) -> float:
    """The least time for the work: bytes over HBM's rate or operations over
    the peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / flop_per_s)


def deep_model_flops(kind: str, layers: int, width: int, n_vertices: int, n_faces: int, n_edges: int) -> int:
    """Model operations of one training step on one mesh: every per-vertex
    (or per-face) linear map forward and backward, and ``2 nnz C`` for each
    operator apply (forward, and backward for the input's gradient).

    ``lap``: LapDeepModel, Laplacian blocks on even layers, average blocks
    on odd ones, all on vertex rows.  ``dirac``: DirDeepModel, whose Dirac
    blocks map ``[f || D v]`` on face rows and ``[v || DA f]`` on vertex
    rows; the operator is a ``4M x 4N`` matrix of ``3M`` dense 4 x 4 blocks
    applied to ``C / 4`` columns."""
    total = conv_flops(n_vertices, 3, width, input_grad=False) + conv_flops(n_vertices, width, 3)
    for i in range(layers):
        operator_layer = i % 2 == 0
        if kind == "dirac" and operator_layer:
            total += conv_flops(n_faces, 2 * width, width) + conv_flops(n_vertices, 2 * width, width)
            total += 2 * 2 * dirac_apply_flops(3 * n_faces, width)
        else:
            total += 2 * conv_flops(n_vertices, 2 * width, width)
            if kind == "lap" and operator_layer:
                total += 2 * 2 * apply_flops(laplacian_nnz(n_vertices, n_edges), width)
    return total

