"""Point sampling: Bridson Poisson-disc and mesh-MNIST mesh synthesis
(NumPy/SciPy).

Counterpart of ``surfacenetworks_tpu/geometry/sampling.py``, a verbatim copy
of the reference's ``mesh_mnist/poisson_disc.py`` (Bridson-style
grid-accelerated Poisson-disc sampling) and ``mesh_mnist/create_data.py``
(image -> lifted triangulated mesh via Poisson-disc points, bilinear
intensity interpolation, Delaunay triangulation, degenerate rejection):
given the same ``np.random.Generator``, both packages draw the same points
and build the same meshes, bit for bit.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay


def poisson_disc(
    r: float,
    extents: "tuple[float, ...] | np.ndarray",
    seed_point: "tuple[float, ...] | None" = None,
    k: int = 30,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Bridson Poisson-disc samples in the n-D box ``prod_i [0, extents[i]]``
    with minimum spacing ``r`` (dimension-generic like the reference Grid,
    poisson_disc.py:16-188; the codebase only ever uses 2-D).

    Candidates are drawn uniformly from the spherical shell ``[r, 2r)``
    around an active point (direction = normalized Gaussian, radius via the
    inverse-CDF ``(r^d + u (2r)^d - u r^d)^(1/d)``); the acceleration grid
    has cell size ``r / sqrt(d)`` so each cell holds at most one sample and
    conflict checks scan the 5^d neighborhood, vectorized over occupied
    neighbors.
    """
    rng = rng or np.random.default_rng()
    extents = np.asarray(extents, dtype=np.float64)
    d = extents.shape[0]
    cell = r / np.sqrt(d)
    gshape = tuple(int(np.ceil(e / cell)) + 1 for e in extents)
    grid = -np.ones(gshape, dtype=np.int64)
    # relative index offsets of the 5^d conflict neighborhood
    offsets = np.stack(
        np.meshgrid(*([np.arange(-2, 3)] * d), indexing="ij"), axis=-1
    ).reshape(-1, d)
    gshape_arr = np.asarray(gshape)
    points: list[np.ndarray] = []
    active: list[int] = []

    def grid_idx(p):
        return tuple((p / cell).astype(np.int64))

    def fits(p):
        idx = np.asarray(grid_idx(p)) + offsets
        ok = np.all((idx >= 0) & (idx < gshape_arr), axis=1)
        occ = grid[tuple(idx[ok].T)]
        occ = occ[occ >= 0]
        if occ.size == 0:
            return True
        neigh = np.asarray([points[j] for j in occ])
        return bool(np.min(np.linalg.norm(neigh - p, axis=1)) >= r)

    p0 = np.asarray(
        seed_point if seed_point is not None else rng.uniform(np.zeros(d), extents)
    , dtype=np.float64)
    points.append(p0)
    grid[grid_idx(p0)] = 0
    active.append(0)

    while active:
        pick = int(rng.integers(0, len(active)))
        base = points[active[pick]]
        found = False
        for _ in range(k):
            u = rng.uniform()
            rad = (r**d + u * ((2 * r) ** d - r**d)) ** (1.0 / d)
            direction = rng.normal(size=d)
            direction /= max(np.linalg.norm(direction), 1e-12)
            cand = base + rad * direction
            if np.all(cand >= 0) and np.all(cand <= extents) and fits(cand):
                grid[grid_idx(cand)] = len(points)
                active.append(len(points))
                points.append(cand)
                found = True
                break
        if not found:
            active.pop(pick)
    return np.asarray(points)


def poisson_disc_2d(
    r: float,
    width: float,
    height: float,
    seed_point: tuple[float, float] | None = None,
    k: int = 30,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """2-D convenience wrapper over :func:`poisson_disc` (the mesh-MNIST use)."""
    return poisson_disc(r, (width, height), seed_point=seed_point, k=k, rng=rng)


def bilinear_interpolate(image: np.ndarray, y: float, x: float) -> float:
    """create_data.py:27-35 convention: image row = 27 - int(x)."""
    h = image.shape[0] - 1
    xi, yi = int(x), int(y)
    f00 = image[h - xi, yi]
    f01 = image[h - xi, min(yi + 1, image.shape[1] - 1)]
    f10 = image[max(h - xi - 1, 0), yi]
    f11 = image[max(h - xi - 1, 0), min(yi + 1, image.shape[1] - 1)]
    dx, dy = x - xi, y - yi
    return float(f00 * (1 - dx) * (1 - dy) + f01 * (1 - dx) * dy + f10 * dx * (1 - dy) + f11 * dx * dy)


def image_to_mesh(
    image: np.ndarray,
    label: int,
    r: float = 1.5,
    min_points: int = 100,
    min_area: float = 1e-2,
    max_tries: int = 50,
    rng: np.random.Generator | None = None,
) -> dict | None:
    """One mesh-MNIST sample from a 28x28 intensity image
    (create_data.py:62-105): Poisson-disc >= 100 points over the 27x27
    domain, intensity lifted as z, Delaunay faces, reject meshes with tiny
    faces in either the lifted or flat configuration."""
    from surfacenetworks_tpu_torch.geometry import mesh_ops

    rng = rng or np.random.default_rng()
    extent = image.shape[0] - 1
    for _ in range(max_tries):
        pts = poisson_disc_2d(r, extent, extent, rng=rng)
        if len(pts) <= min_points:
            continue
        tri = Delaunay(pts)
        pts = tri.points
        colors = np.array([bilinear_interpolate(image, p[0], p[1]) for p in pts])
        V = np.concatenate([pts, colors[:, None] / 255.0], axis=1).astype(np.float32)
        F = np.asarray(tri.simplices, dtype=np.int32)
        areas = mesh_ops.face_areas(V, F)
        V_flat = V.copy()
        V_flat[:, 2] = 0
        areas_flat = mesh_ops.face_areas(V_flat, F)
        if areas.min() > min_area and areas_flat.min() > min_area:
            return {"V": V, "F": F, "label": int(label)}
    return None


def add_operators(sample: dict, scale: float = 27.0) -> dict:
    """Offline operator pass for one mesh-MNIST sample
    (mesh_mnist/add_laplacian.py:36-84): normalize V into the unit square
    centered at the origin (x, y only), attach cotan L and Dirac for the
    lifted and flat meshes."""
    from surfacenetworks_tpu_torch.geometry import mesh_ops

    V = np.asarray(sample["V"], np.float64) / scale
    V = V - np.array([0.5, 0.5, 0.0])
    F = np.asarray(sample["F"], np.int32)
    V_flat = V.copy()
    V_flat[:, 2] = 0
    out = {
        "V": V.astype(np.float32),
        "F": F,
        "label": sample["label"],
        "L": mesh_ops.mesh_laplacian(V, F).astype(np.float32),
        "flat_L": mesh_ops.mesh_laplacian(V_flat, F).astype(np.float32),
        "dirac": mesh_ops.dirac_coeffs(V, F),
        "flat_dirac": mesh_ops.dirac_coeffs(V_flat, F),
        "flat_V": V_flat.astype(np.float32),
    }
    return out
