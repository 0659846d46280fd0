"""Mesh file I/O: Wavefront OBJ and ascii PLY (counterpart of
``surfacenetworks_tpu/geometry/io.py``).

Loaders return ``(V, F)`` as ``float64 [N,3]`` / ``int32 [M,3]`` NumPy
arrays, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an OBJ file (v/f records; f entries may be 'i', 'i/t', 'i/t/n')."""
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as fh:
        for line in fh:
            if not line or line[0] == "#":
                continue
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[i + 1]) for i in range(3)])
            elif parts[0] == "f":
                faces.append([int(tok.split("/")[0]) - 1 for tok in parts[1:]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32)


def save_obj(path: str, V: np.ndarray, F: np.ndarray) -> None:
    """Write an OBJ file (1-based face indices)."""
    with open(path, "w") as fh:
        for row in np.asarray(V):
            fh.write(f"v {row[0]} {row[1]} {row[2]}\n")
        for row in np.asarray(F):
            fh.write(f"f {row[0] + 1} {row[1] + 1} {row[2] + 1}\n")


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an ascii PLY file with vertex x/y/z leading properties and list
    faces; other elements' rows are skipped.  Binary PLY raises."""
    with open(path) as fh:
        if fh.readline().strip() != "ply":
            raise ValueError(f"{path}: not a PLY file")
        n_vert = 0
        elements: list[tuple[str, int]] = []
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == "format" and tok[1] != "ascii":
                raise ValueError(f"{path}: only ascii PLY supported, got {tok[1]}")
            if tok[0] == "element":
                elements.append((tok[1], int(tok[2])))
                if tok[1] == "vertex":
                    n_vert = int(tok[2])
            if tok[0] == "end_header":
                break
        verts = np.zeros((n_vert, 3), dtype=np.float64)
        faces: list[list[int]] = []
        for name, count in elements:
            if name == "vertex":
                for i in range(count):
                    vals = fh.readline().split()
                    verts[i] = [float(vals[0]), float(vals[1]), float(vals[2])]
            elif name == "face":
                for _ in range(count):
                    vals = fh.readline().split()
                    k = int(vals[0])
                    faces.append([int(v) for v in vals[1 : 1 + k]])
            else:
                for _ in range(count):
                    fh.readline()
    return verts, np.asarray(faces, dtype=np.int32)


def save_ply(path: str, V: np.ndarray, F: np.ndarray) -> None:
    """Write an ascii PLY with float x/y/z vertices and triangle faces."""
    V, F = np.asarray(V), np.asarray(F)
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {V.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {F.shape[0]}\n"
        "property list uchar uint vertex_indices\nend_header\n"
    )
    with open(path, "w") as fh:
        fh.write(header)
        for row in V:
            fh.write(f"{row[0]} {row[1]} {row[2]}\n")
        for row in F:
            fh.write(f"3 {row[0]} {row[1]} {row[2]}\n")
