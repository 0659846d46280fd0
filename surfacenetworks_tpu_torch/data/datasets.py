"""Seeded synthetic meshes (counterpart of ``surfacenetworks_tpu/data/datasets.py``).

``random_blob_mesh`` and the ``operator="lap"`` branch of
``synthetic_normal_dataset`` are copies of the JAX package's generators, so
the same seed gives the same meshes, normals and Laplacians in both packages.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull

from surfacenetworks_tpu_torch import geometry as geo


def random_blob_mesh(rng: np.random.Generator, n_points: int = 200) -> tuple[np.ndarray, np.ndarray]:
    """Random smooth star-shaped closed mesh.

    Points are sampled on the unit sphere, triangulated by their convex hull
    (combinatorially valid for any radial displacement), then displaced by a
    random low-order smooth radial field.
    """
    pts = rng.normal(size=(n_points, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    hull = ConvexHull(pts)
    F = hull.simplices.astype(np.int32)
    # orient all faces outward (hull simplices have arbitrary orientation)
    c = pts[F].mean(axis=1)
    n = np.cross(pts[F[:, 1]] - pts[F[:, 0]], pts[F[:, 2]] - pts[F[:, 0]])
    flip = (n * c).sum(axis=1) < 0
    F[flip] = F[flip][:, [0, 2, 1]]

    a = rng.uniform(-0.25, 0.25, size=6)
    x, y, z = pts.T
    r = 1.0 + a[0] * np.sin(2 * x) + a[1] * np.cos(2 * y) + a[2] * np.sin(2 * z) + a[
        3
    ] * np.sin(3 * x * y) + a[4] * np.cos(3 * y * z) + a[5] * np.sin(3 * z * x)
    V = pts * r[:, None]
    return V, F


def synthetic_normal_dataset(
    num: int, n_points: int = 150, seed: int = 0, operator: str = "lap", hack: float = 1.0
) -> list[dict]:
    """normal_predict-style samples: input = V, target = vertex normals, and
    the igl-convention hacked Laplacian ``L``.  Only ``operator='lap'`` is
    ported; the Dirac branch comes with the Dirac slice."""
    if operator != "lap":
        raise NotImplementedError(f"operator={operator!r}: only 'lap' is ported")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        V, F = random_blob_mesh(rng, n_points)
        out.append(
            {
                "V": V.astype(np.float32),
                "F": F,
                "input": V.astype(np.float32),
                "target": geo.vertex_normals(V, F).astype(np.float32),
                "name": f"synthetic_{i}",
                "L": geo.igl_style_laplacian(V, F, hack=hack),
            }
        )
    return out
