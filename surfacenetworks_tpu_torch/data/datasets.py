"""Seeded synthetic meshes and the loaders (counterpart of
``surfacenetworks_tpu/data/datasets.py``).

``random_blob_mesh``, ``synthetic_normal_dataset``,
``synthetic_correspondence_dataset`` and ``synthetic_arap_sequences`` are
copies of the JAX package's generators (same RNG call order), so the same
seed gives the same meshes, labels, geodesic proxies, Laplacians and Dirac
coefficients in both packages.  ``load_faust_npz`` reads the reference's
FAUST ``.npz`` layout; ``load_normal_sample``, ``scan_mesh_tree`` and
``load_normal_npz`` read the normal trainer's mesh trees and the JAX
package's ``cli.preprocess normal`` output, Laplacian and Dirac samples;
``load_arap_sequence`` reads the ARAP trainer's ``.npy`` sequences;
``height_field_mesh``, ``synthetic_mnist_dataset`` and
``load_mnist_mesh_pickle`` make and read the mesh-MNIST samples of the
classifier and the VAE; ``load_mnist_idx`` and ``build_mnist_mesh_dataset``
read MNIST's idx files and turn the images into those samples (the JAX
package's offline pass, ``cli.preprocess mnist``).  Dirac coefficients are
built by the native runtime (``native.dirac_coeffs``), as the JAX package
builds them.  The mesh-MNIST pickle and a normal sample's
pickled Dirac member are read through ``_SampleUnpickler``, which admits
only the globals a sample holds.
"""

from __future__ import annotations

import glob
import io
import os
import pickle

import numpy as np
import scipy.sparse as sp
from scipy.spatial import ConvexHull, Delaunay

from surfacenetworks_tpu_torch import geometry as geo
from surfacenetworks_tpu_torch import native


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


def height_field_mesh(rng: np.random.Generator, n_points: int = 150,
                      n_blobs: int = 3) -> tuple[np.ndarray, np.ndarray, int]:
    """Random triangulated height field (a mesh-MNIST-like lifted mesh):
    ``n_points`` uniform points of the unit square, their Delaunay
    triangles, and a height of ``n_blobs`` Gaussian peaks at least 0.28
    apart, normalised to a maximum of 1.  Returns (V, F, label) with the
    blob count as the label."""
    pts = rng.uniform(0, 1, size=(n_points, 2))
    tri = Delaunay(pts)
    z = np.zeros(n_points)
    centers: list = []
    for _ in range(n_blobs):
        for _try in range(50):
            c = rng.uniform(0.15, 0.85, size=2)
            if all(np.linalg.norm(c - o) > 0.28 for o in centers):
                break
        centers.append(c)
        s = rng.uniform(0.08, 0.13)
        z += rng.uniform(0.5, 1.0) * np.exp(-((pts[:, 0] - c[0]) ** 2 + (pts[:, 1] - c[1]) ** 2) / (2 * s**2))
    V = np.concatenate([pts, z[:, None] / max(z.max(), 1e-6)], axis=1)
    return V, np.asarray(tri.simplices, dtype=np.int32), n_blobs


def synthetic_mnist_dataset(num: int, seed: int = 0, n_points: int = 120, n_classes: int = 10) -> list[dict]:
    """mesh-MNIST-style samples: a height field per sample with its lifted
    and flat (z = 0) cotan Laplacians ``L``/``flat_L`` and Dirac
    coefficients ``dirac``/``flat_dirac`` (of the float32 vertices), and
    ``flat_V``.  The label draws the blob count: label k has k+1 blobs
    below 10 classes, max(k, 1) at 10."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        label = int(rng.integers(0, n_classes))
        n_blobs = label + 1 if n_classes < 10 else max(label, 1)
        V, F, _ = height_field_mesh(rng, n_points, n_blobs=n_blobs)
        V = V.astype(np.float32)
        flat_V = V.copy()
        flat_V[:, 2] = 0
        out.append({
            "V": V,
            "F": F,
            "label": label,
            "L": geo.mesh_laplacian(V, F).astype(np.float32),
            "flat_L": geo.mesh_laplacian(flat_V, F).astype(np.float32),
            "dirac": native.dirac_coeffs(V, F),
            "flat_dirac": native.dirac_coeffs(flat_V, F),
            "flat_V": flat_V,
            "name": f"mnistlike_{i}",
        })
    return out


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
            sample["dirac"] = native.dirac_coeffs(V, F)
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


def arap_wave_frames(num_seq: int, n_frames: int = 50, n_points: int = 120,
                     seed: int = 0) -> list[tuple[list[np.ndarray], np.ndarray]]:
    """The float64 vertices of every frame, and the faces, of each sequence
    ``synthetic_arap_sequences`` makes from the same arguments: a blob mesh
    deformed by a smooth travelling wave."""
    rng = np.random.default_rng(seed)
    sequences = []
    for _ in range(num_seq):
        V0, F = random_blob_mesh(rng, n_points)
        omega = rng.uniform(0.15, 0.4)
        phase = rng.uniform(0, 2 * np.pi, size=V0.shape[0])
        dirvec = rng.normal(size=3)
        dirvec /= np.linalg.norm(dirvec)
        frames = [V0 * (1.0 + 0.15 * np.sin(omega * t + phase)[:, None]) + 0.05 * np.sin(omega * t) * dirvec
                  for t in range(n_frames)]
        sequences.append((frames, F))
    return sequences


def synthetic_arap_sequences(num_seq: int, n_frames: int = 50, n_points: int = 120,
                             seed: int = 0) -> list[list[dict]]:
    """ARAP-style sequences (``arap_wave_frames``): each frame's ``V`` and
    ``F``, and on the first 10 frames (the only ones an operator is taken
    from) the cotan ``L`` and the Dirac coefficients of the float64
    vertices."""
    sequences = []
    for frames64, F in arap_wave_frames(num_seq, n_frames, n_points, seed):
        frames = []
        for t, V in enumerate(frames64):
            frame = {"V": V.astype(np.float32), "F": F}
            if t < 10:
                frame["L"] = geo.mesh_laplacian(V, F).astype(np.float32)
                frame["dirac"] = native.dirac_coeffs(V, F)
            frames.append(frame)
        sequences.append(frames)
    return sequences


def load_arap_sequence(path: str) -> list[dict]:
    """One ARAP ``.npy`` sequence in the reference layout: a pickled array
    of frame dicts with ``V``, ``F`` and, where present, ``L``."""
    seq = np.load(path, encoding="latin1", allow_pickle=True)
    frames = []
    for frame in seq:
        f = {"V": np.asarray(frame["V"], np.float32), "F": np.asarray(frame["F"], np.int32)}
        if "L" in frame and frame["L"] is not None:
            f["L"] = frame["L"].astype(np.float32)
        frames.append(f)
    return frames


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
        sample["dirac"] = native.dirac_coeffs(V, F)
    return sample


def scan_obj_tree(data_path: str) -> list[str]:
    """Every ``.obj`` under ``data_path``, recursively, sorted."""
    return sorted(glob.glob(os.path.join(data_path, "**/*.obj"), recursive=True))


def scan_mesh_tree(data_path: str) -> list[str]:
    """Preprocessed ``.npz`` samples under ``data_path`` if there are any,
    else its ``.obj`` files (sorted, recursive)."""
    npz = sorted(glob.glob(os.path.join(data_path, "**/*.npz"), recursive=True))
    return npz if npz else scan_obj_tree(data_path)


class _SampleUnpickler(pickle.Unpickler):
    """Unpickles a sample file's objects with every global refused but
    numpy's array and scalar reconstructors, scipy's sparse matrix and
    array classes (under any of their module paths), the copy protocol's
    ``_reconstructor`` over ``object`` (Python 2 pickles), and the JAX
    package's ``DiracCoeffs``, which becomes the port's (same fields).  So
    a file can neither import the JAX package nor run code."""

    _NUMPY = {("numpy._core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "_reconstruct"),
              ("numpy._core.multiarray", "scalar"), ("numpy.core.multiarray", "scalar"),
              ("numpy", "ndarray"), ("numpy", "dtype"), ("copyreg", "_reconstructor"),
              ("copy_reg", "_reconstructor"), ("builtins", "object"), ("__builtin__", "object")}
    _SPARSE = {f"{fmt}_{kind}" for fmt in ("coo", "csr", "csc") for kind in ("matrix", "array")}

    def find_class(self, module: str, name: str):
        if (module, name) == ("surfacenetworks_tpu.geometry.mesh_ops", "DiracCoeffs"):
            return geo.DiracCoeffs
        if (module, name) in self._NUMPY:
            return super().find_class(module, name)
        if (module == "scipy.sparse" or module.startswith("scipy.sparse.")) and name in self._SPARSE:
            return getattr(sp, name)
        raise pickle.UnpicklingError(f"refused global {module}.{name} in a sample file")


def _read_pickled_npy(fh, path: str, what: str) -> np.ndarray:
    """The object array of an open ``.npy`` stream, unpickled by
    ``_SampleUnpickler`` (``np.load`` would unpickle with no restriction)."""
    version = np.lib.format.read_magic(fh)
    header = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
    shape, _, dtype = header(fh)
    if dtype != np.dtype(object):
        raise ValueError(f"{path}: {what} is {dtype} {shape}, not a pickled object array")
    return _SampleUnpickler(io.BytesIO(fh.read()), encoding="latin1").load()


def _read_dirac_member(z, path: str) -> geo.DiracCoeffs:
    """The 0-d object array ``dirac.npy`` of an open ``.npz``, read through
    ``_SampleUnpickler``."""
    with z.zip.open("dirac.npy") as fh:
        arr = _read_pickled_npy(fh, path, "dirac member")
    if arr.shape != ():
        raise ValueError(f"{path}: dirac member has shape {arr.shape}, not a pickled DiracCoeffs")
    coeffs = arr.item()
    if not isinstance(coeffs, geo.DiracCoeffs):
        raise ValueError(f"{path}: dirac member holds {type(coeffs).__name__}, not DiracCoeffs")
    return coeffs


def load_normal_npz(path: str) -> dict:
    """One normal-prediction sample written by the JAX package's
    ``cli.preprocess normal``: its Laplacian, or its pickled Dirac
    coefficients (read by ``_SampleUnpickler``)."""
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


def load_mnist_mesh_pickle(path: str) -> list[dict]:
    """A ``train_plus.np``-style pickle (the reference's
    ``mesh_mnist/add_laplacian.py`` output or the JAX package's ``cli.preprocess
    mnist``, an ``.npy`` object array or a bare pickle) of sample dicts with
    V, F, label and the lifted and flat operators, read through
    ``_SampleUnpickler``: V float32, F int32, the label an int, ``L`` and
    ``flat_L`` as CSR, and ``flat_V`` made where the file has none."""
    with open(path, "rb") as fh:
        if fh.read(6) == b"\x93NUMPY":
            fh.seek(0)
            raw = _read_pickled_npy(fh, path, "the sample array")
        else:
            fh.seek(0)
            raw = _SampleUnpickler(fh, encoding="latin1").load()
    out = []
    for s in raw:
        d = dict(s)
        d["V"] = np.asarray(d["V"], np.float32)
        d["F"] = np.asarray(d["F"], np.int32)
        d["label"] = int(d["label"])
        for key in ("L", "flat_L"):
            if key in d and d[key] is not None:
                d[key] = d[key].tocsr()
        if "flat_V" not in d:
            flat = d["V"].copy()
            flat[:, 2] = 0
            d["flat_V"] = flat
        out.append(d)
    return out


def load_mnist_idx(images_path: str, labels_path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read MNIST in the standard idx format (optionally .gz).

    The reference pulls MNIST through ``torchvision.datasets`` in
    mesh_mnist/create_data.py; this loader reads the raw idx files directly
    (no torchvision dependency).  Returns (images [N, 28, 28] uint8,
    labels [N] int64).
    """
    import gzip
    import struct

    def _open(p):
        return gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")

    with _open(images_path) as fh:
        magic, n, rows, cols = struct.unpack(">IIII", fh.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx image magic {magic} in {images_path}")
        images = np.frombuffer(fh.read(n * rows * cols), np.uint8).reshape(n, rows, cols)
    with _open(labels_path) as fh:
        magic, n2 = struct.unpack(">II", fh.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx label magic {magic} in {labels_path}")
        labels = np.frombuffer(fh.read(n2), np.uint8).astype(np.int64)
    if n != n2:
        raise ValueError(f"image/label count mismatch: {n} vs {n2}")
    return images, labels


def build_mnist_mesh_dataset(
    images: np.ndarray,
    labels: np.ndarray,
    limit: int | None = None,
    with_operators: bool = True,
    seed: int = 0,
) -> list[dict]:
    """Offline mesh-MNIST dataset pass: images -> meshes -> operators.

    The combination of the reference's create_data.py (Poisson-disc sample +
    Delaunay + rejection) and add_laplacian.py (normalize + cotan L + Dirac
    for the lifted and flat meshes); rejected images are skipped like the
    reference's `continue` (create_data.py:92-101).
    """
    from surfacenetworks_tpu_torch.geometry import sampling

    rng = np.random.default_rng(seed)
    out = []
    n = len(images) if limit is None else min(limit, len(images))
    for i in range(n):
        sample = sampling.image_to_mesh(np.asarray(images[i], np.float64), int(labels[i]), rng=rng)
        if sample is None:
            continue
        out.append(sampling.add_operators(sample) if with_operators else sample)
    return out
