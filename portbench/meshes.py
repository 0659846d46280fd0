"""The benchmark's mesh generator: points on the unit sphere, their convex
hull oriented outward, displaced by a smooth random radial field (after the
port's ``data/datasets.py::random_blob_mesh``, copied and frozen here so
that a change to the program cannot change the traffic).

The points are the Fibonacci lattice, each coordinate of each point moved
by a uniform draw of at most ``JITTER`` times the mean spacing and put back
on the sphere: triangles of even size, as a scanned and remeshed surface
has (a bounded draw: a normal one's tail still makes slivers).  The uniform
points of ``random_blob_mesh`` make hulls with triangles down to a
thousandth of the mean area, whose cotangent weights reach 1e6, and there a
training step in fp32 departs from fp64 by percents (``PERF.md``).

Every mesh of ``n`` points is closed and of genus 0: all ``n`` points lie on
the hull, so it has exactly ``n`` vertices, ``2n - 4`` faces and ``7n - 12``
Laplacian nonzeros whatever the seed.  Seeds change the geometry, never the
sizes.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial import ConvexHull

JITTER = 0.1  # the largest move of a lattice point's coordinate, in mean spacings
MIN_RADIUS = 0.5  # the radial field is kept at or above this radius


def sphere_points(rng: np.random.Generator, n_points: int) -> np.ndarray:
    i = np.arange(n_points) + 0.5
    polar, azimuth = np.arccos(1.0 - 2.0 * i / n_points), np.pi * (1.0 + 5.0**0.5) * i
    pts = np.stack([np.cos(azimuth) * np.sin(polar), np.sin(azimuth) * np.sin(polar), np.cos(polar)], axis=1)
    pts += rng.uniform(-JITTER, JITTER, size=pts.shape) * (4.0 * np.pi / n_points) ** 0.5
    return pts / np.linalg.norm(pts, axis=1, keepdims=True)


def blob_mesh(rng: np.random.Generator, n_points: int) -> tuple[np.ndarray, np.ndarray]:
    """``(V [n, 3] float64, F [2n - 4, 3] int32)``: a random smooth
    star-shaped closed mesh.  The radial field ``r = 1 + f`` (six smooth
    terms, each of amplitude up to 0.25) could pinch the surface near the
    origin, or fold it through; it is scaled down where needed so that ``r``
    stays at or above ``MIN_RADIUS``."""
    pts = sphere_points(rng, n_points)
    F = ConvexHull(pts).simplices.astype(np.int32)
    c = pts[F].mean(axis=1)
    n = np.cross(pts[F[:, 1]] - pts[F[:, 0]], pts[F[:, 2]] - pts[F[:, 0]])
    flip = (n * c).sum(axis=1) < 0
    F[flip] = F[flip][:, [0, 2, 1]]
    a = rng.uniform(-0.25, 0.25, size=6)
    x, y, z = pts.T
    f = (a[0] * np.sin(2 * x) + a[1] * np.cos(2 * y) + a[2] * np.sin(2 * z) + a[3] * np.sin(3 * x * y)
         + a[4] * np.cos(3 * y * z) + a[5] * np.sin(3 * z * x))
    if f.min() < MIN_RADIUS - 1.0:
        f = f * ((1.0 - MIN_RADIUS) / -f.min())
    return pts * (1.0 + f)[:, None], F


def mesh_rng(seed: int) -> np.random.Generator:
    """The generator of a run's meshes: any whole number seeds it (negative
    and beyond 64 bits too), and the same seed gives the same meshes."""
    return np.random.default_rng(seed % (1 << 64))


def make_meshes(seed: int, count: int, vertices) -> list[tuple[np.ndarray, np.ndarray]]:
    """``count`` meshes from ``seed``.  ``vertices`` is a mesh's vertex
    count, or a list of counts taken in turn (mesh ``i`` has
    ``vertices[i % len(vertices)]``), so that every seed has the same sizes
    and only the geometry changes."""
    sizes = list(vertices) if isinstance(vertices, list) else [vertices]
    rng = mesh_rng(seed)
    meshes = []
    for i in range(count):
        n = sizes[i % len(sizes)]
        V, F = blob_mesh(rng, n)
        if V.shape[0] != n or F.shape[0] != 2 * n - 4:
            raise RuntimeError(f"generated mesh has {V.shape[0]} vertices and {F.shape[0]} faces, "
                               f"not {n} and {2 * n - 4}")
        meshes.append((V, F))
    return meshes


def write_obj(path: str, V: np.ndarray, F: np.ndarray) -> None:
    """An ``.obj`` whose coordinates read back bit for bit (the shortest
    digits that round-trip), so the program parses the float64 vertices the
    reference uses."""
    with open(path, "w") as fh:
        fh.write("".join(f"v {x!r} {y!r} {z!r}\n" for x, y, z in V.tolist()))
        fh.write("".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in F.tolist()))


def write_meshes(root: str, meshes: list, prefix: str = "mesh") -> dict[str, int]:
    """Each mesh as ``<root>/<prefix>_<i>.obj``; returns path -> index."""
    os.makedirs(root, exist_ok=True)
    paths = {}
    for i, (V, F) in enumerate(meshes):
        path = os.path.join(root, f"{prefix}_{i:04d}.obj")
        write_obj(path, V, F)
        paths[path] = i
    return paths
