"""Seeded synthetic meshes and the FAUST loader (counterpart of
``surfacenetworks_tpu/data/datasets.py``).

``random_blob_mesh``, ``synthetic_normal_dataset`` and
``synthetic_correspondence_dataset`` are copies of the JAX package's
generators (same RNG call order), so the same seed gives the same meshes,
labels, geodesic proxies, Laplacians and Dirac coefficients in both
packages.  ``load_faust_npz`` reads the reference's FAUST ``.npz`` layout;
``load_normal_sample``, ``scan_mesh_tree`` and ``load_normal_npz`` read the
normal trainer's mesh trees and the JAX package's ``cli.preprocess normal``
output, Laplacian and Dirac samples.
"""

from __future__ import annotations

import glob
import io
import os
import pickle

import numpy as np
import scipy.sparse as sp
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
    """normal_predict-style samples: input = V, target = vertex normals.

    ``operator='lap'`` attaches the igl-convention hacked Laplacian ``L``;
    any other value (the JAX package's ``'dirac'``) the structured Dirac
    coefficients ``dirac`` of the float64 vertices.
    """
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        V, F = random_blob_mesh(rng, n_points)
        sample = {
            "V": V.astype(np.float32),
            "F": F,
            "input": V.astype(np.float32),
            "target": geo.vertex_normals(V, F).astype(np.float32),
            "name": f"synthetic_{i}",
        }
        if operator == "lap":
            sample["L"] = geo.igl_style_laplacian(V, F, hack=hack)
        else:
            sample["dirac"] = geo.dirac_coeffs(V, F)
        out.append(sample)
    return out


def synthetic_correspondence_dataset(num: int, n_points: int = 200, seed: int = 0) -> list[dict]:
    """FAUST-style samples: deformations of one base shape with known
    correspondence labels and a geodesic-proxy distance matrix ``G``
    (Euclidean distances on the base shape)."""
    rng = np.random.default_rng(seed)
    base_V, F = random_blob_mesh(rng, n_points)
    n = base_V.shape[0]
    # row-chunked: the [n, n, 3] difference would not fit at large n
    Vf = base_V.astype(np.float32)
    G = np.empty((n, n), np.float32)
    chunk = max(1, (256 << 20) // max(n * 12, 1))
    for i0 in range(0, n, chunk):
        d = Vf[i0 : i0 + chunk, None, :] - Vf[None, :, :]
        G[i0 : i0 + chunk] = np.sqrt((d * d).sum(-1))
    out = []
    for i in range(num):
        a = rng.uniform(-0.2, 0.2, size=3)
        V = base_V * (1.0 + a[None, :] * np.sin(2 * base_V))
        perm = rng.permutation(n)
        inv = geo.invert_permutation(perm)
        Vp = V[perm].astype(np.float32)  # scan vertex i <-> template id perm[i]
        Fp = inv[F].astype(np.int32)
        out.append(
            {
                "V": Vp,
                "F": Fp,
                "input": Vp,
                "L": geo.igl_style_laplacian(Vp, Fp, hack=1.0),
                "label": perm.astype(np.int64),  # scan vertex -> template id
                "label_inv": inv.astype(np.int64),  # template id -> scan vertex
                "G": G[perm][:, perm],
                "name": f"faustlike_{i}",
            }
        )
    return out


def load_faust_npz(path: str) -> dict:
    """Load a FAUST ``.npz`` in the reference layout: V, F, the Laplacian
    ``L`` as a pickled scipy matrix, label, label_inv and ``dist_mat`` (kept
    as ``G``)."""
    with np.load(path, allow_pickle=True) as seq:
        out = {
            "V": seq["V"].astype(np.float32),
            "F": seq["F"].astype(np.int32),
            "label": seq["label"].astype(np.int64),
            "label_inv": seq["label_inv"].astype(np.int64),
            "G": seq["dist_mat"].astype(np.float32),
            "name": path,
        }
        if "L" in seq:
            out["L"] = seq["L"].item().astype(np.float32).tocsr()
        out["input"] = out["V"]
    return out


def load_normal_sample(obj_path: str, operator: str = "lap", hack: float = 1.0,
                       uniform_mesh: bool = False) -> dict | None:
    """One ``.obj``/``.ply`` as a normal-prediction sample with its
    igl-style Laplacian (``operator="lap"``) or, for any other value (the
    JAX package's ``"dirac"``), the Dirac coefficients of its float64
    vertices: the target is the vertex normals of the mesh as read, the
    input and the operator those of the mesh after ``uniform_mesh`` scaling.
    NaN or empty meshes, and Laplacians with non-finite values, give None."""
    loader = geo.load_ply if obj_path.lower().endswith(".ply") else geo.load_obj
    V, F = loader(obj_path)
    if V.size == 0 or F.size == 0:
        return None
    target = geo.vertex_normals(V, F)
    if not np.isfinite(target).all():
        return None
    if uniform_mesh:
        V = geo.uniform_mesh_scale(V)
    sample = {
        "V": V.astype(np.float32),
        "F": F.astype(np.int32),
        "input": V.astype(np.float32),
        "target": target.astype(np.float32),
        "name": obj_path,
    }
    if operator == "lap":
        L = geo.igl_style_laplacian(V, F, hack=hack)
        if not np.isfinite(L.data).all():
            return None
        sample["L"] = L
    else:
        sample["dirac"] = geo.dirac_coeffs(V, F)
    return sample


def scan_obj_tree(data_path: str) -> list[str]:
    """Every ``.obj`` under ``data_path``, recursively, sorted."""
    return sorted(glob.glob(os.path.join(data_path, "**/*.obj"), recursive=True))


def scan_mesh_tree(data_path: str) -> list[str]:
    """Preprocessed ``.npz`` samples under ``data_path`` if there are any,
    else its ``.obj`` files (sorted, recursive)."""
    npz = sorted(glob.glob(os.path.join(data_path, "**/*.npz"), recursive=True))
    return npz if npz else scan_obj_tree(data_path)


class _DiracUnpickler(pickle.Unpickler):
    """Unpickles the ``dirac`` member of a preprocessed sample: the JAX
    package's ``DiracCoeffs`` becomes the port's (same fields), numpy's
    array reconstructors are admitted, and every other global is refused,
    so the file can neither import the JAX package nor run code."""

    _NUMPY = {("numpy._core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "_reconstruct"),
              ("numpy", "ndarray"), ("numpy", "dtype")}

    def find_class(self, module: str, name: str):
        if (module, name) == ("surfacenetworks_tpu.geometry.mesh_ops", "DiracCoeffs"):
            return geo.DiracCoeffs
        if (module, name) in self._NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refused global {module}.{name} in a Dirac sample")


def _read_dirac_member(z, path: str) -> geo.DiracCoeffs:
    """The 0-d object array ``dirac.npy`` of an open ``.npz``, read through
    ``_DiracUnpickler`` (``np.load`` would unpickle with no restriction)."""
    with z.zip.open("dirac.npy") as fh:
        version = np.lib.format.read_magic(fh)
        header = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
        shape, _, dtype = header(fh)
        if shape != () or dtype != np.dtype(object):
            raise ValueError(f"{path}: dirac member is {dtype} {shape}, not a pickled DiracCoeffs")
        coeffs = _DiracUnpickler(io.BytesIO(fh.read())).load().item()
    if not isinstance(coeffs, geo.DiracCoeffs):
        raise ValueError(f"{path}: dirac member holds {type(coeffs).__name__}, not DiracCoeffs")
    return coeffs


def load_normal_npz(path: str) -> dict:
    """One normal-prediction sample written by the JAX package's
    ``cli.preprocess normal``: its Laplacian, or its pickled Dirac
    coefficients (read by ``_DiracUnpickler``)."""
    with np.load(path, allow_pickle=False) as z:
        V = z["V"].astype(np.float32)
        sample = {
            "V": V,
            "F": z["F"].astype(np.int32),
            "input": V,
            "target": z["target"].astype(np.float32),
            "name": path,
        }
        if "L_data" in z:
            sample["L"] = sp.csr_matrix((z["L_data"], z["L_indices"], z["L_indptr"]), shape=tuple(z["L_shape"]))
        else:
            sample["dirac"] = _read_dirac_member(z, path)
    return sample
