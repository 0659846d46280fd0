"""Offline preprocessing CLI (counterpart of ``surfacenetworks_tpu/cli/preprocess.py``):
the reference's multiprocessing operator passes, unified.

Subcommands, flags and defaults are the JAX package's, and each runs a
``multiprocessing.Pool`` of ``--workers`` (``os.cpu_count()`` by default),
as the JAX package's does:

* ``mnist``  — MNIST idx files -> Poisson-disc meshes -> cotan L and Dirac
  for the lifted and flat configurations -> one ``train_plus.np``-style
  object pickle, read by ``train_mnist --data-path`` and ``train_vae
  --data-path``;
* ``normal`` — ``.obj`` tree -> per-mesh ``.npz`` with vertex normals and the
  igl-style Laplacian (``--operator dirac``: the pickled Dirac
  coefficients), read by ``train_normal --data-path`` (``scan_mesh_tree``
  takes ``.npz`` before ``.obj``);
* ``arap``   — directories of per-frame ``.obj`` sequences -> ``*.npy`` in
  the reference layout (V, F per frame; L for the first ``--op-frames``),
  read by ``train_arap --data-path``.

The files are the JAX package's files: the same arrays, bit for bit, for the
same inputs and seeds, and each package's loaders read the other's.  The
pickled Dirac coefficients are written under the JAX package's class path
(``surfacenetworks_tpu.geometry.mesh_ops.DiracCoeffs``, the same fields as
the port's), without importing that package: the port's loaders map that
one class to their own, and the JAX package reads its own class.
Preprocessing touches no device::

    python -m surfacenetworks_tpu_torch.cli.preprocess mnist --images train-images-idx3-ubyte.gz \\
        --labels train-labels-idx1-ubyte.gz --out data/train_plus.np
    python -m surfacenetworks_tpu_torch.cli.preprocess normal --data-path objs/ --out npz/
    python -m surfacenetworks_tpu_torch.cli.preprocess arap --data-path seqs/ --out data_plus/
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing
import os
import pickle
import zipfile

import numpy as np

from surfacenetworks_tpu_torch import geometry as geo
from surfacenetworks_tpu_torch.data import datasets

JAX_DIRAC_CLASS = ("surfacenetworks_tpu.geometry.mesh_ops", "DiracCoeffs")
PICKLE_PROTOCOL = 3  # numpy's np.save / np.savez protocol


class _JaxClassPickler(pickle._Pickler):
    """The pure-Python pickler with the port's ``DiracCoeffs`` class written
    as the JAX package's global (``GLOBAL`` opcode, no import); every other
    object as ``pickle`` writes it."""

    def save_global(self, obj, name=None):
        if obj is geo.DiracCoeffs:
            module, qualname = JAX_DIRAC_CLASS
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode("utf-8"))
            self.memoize(obj)
            return
        super().save_global(obj, name)


def write_npy(fh, array: np.ndarray) -> None:
    """``np.save`` of ``array`` into the open binary ``fh``; object arrays
    are pickled by ``_JaxClassPickler``."""
    if array.dtype != np.dtype(object):
        np.lib.format.write_array(fh, array, allow_pickle=False)
        return
    np.lib.format.write_array_header_1_0(fh, np.lib.format.header_data_from_array_1_0(array))
    _JaxClassPickler(fh, protocol=PICKLE_PROTOCOL).dump(array)


def write_npz(path: str, **arrays) -> None:
    """``np.savez(path, **arrays)`` (an uncompressed zip of ``<key>.npy``
    members) through ``write_npy``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fh:
                write_npy(fh, np.asanyarray(val))


# -------------------------------------------------------------- mnist


def _mnist_worker(job):
    image, label, seed = job
    from surfacenetworks_tpu_torch.geometry import sampling

    rng = np.random.default_rng(seed)
    sample = sampling.image_to_mesh(np.asarray(image, np.float64), int(label), rng=rng)
    if sample is None:
        return None
    return sampling.add_operators(sample)


def run_mnist(args):
    images, labels = datasets.load_mnist_idx(args.images, args.labels)
    n = len(images) if args.limit is None else min(args.limit, len(images))
    jobs = [(images[i], labels[i], args.seed + i) for i in range(n)]
    with multiprocessing.Pool(args.workers) as pool:
        out = [s for s in pool.map(_mnist_worker, jobs, chunksize=8) if s is not None]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as fh:  # the exact name (np.save would append .npy)
        write_npy(fh, np.asarray(out, dtype=object))
    print(f"wrote {len(out)}/{n} samples -> {args.out}")


# -------------------------------------------------------------- normal


def _normal_worker(job):
    obj_path, out_dir, operator, hack, uniform = job
    sample = datasets.load_normal_sample(obj_path, operator=operator, hack=hack, uniform_mesh=uniform)
    if sample is None:
        return None
    stem = os.path.splitext(os.path.basename(obj_path))[0]
    out = os.path.join(out_dir, stem + ".npz")
    payload = {
        "V": sample["V"],
        "F": sample["F"],
        "target": sample["target"],
    }
    if "L" in sample:
        L = sample["L"].tocsr()
        payload.update(L_data=L.data, L_indices=L.indices, L_indptr=L.indptr, L_shape=np.asarray(L.shape))
    else:
        payload["dirac"] = np.asarray(sample["dirac"], dtype=object)
    write_npz(out, **payload)
    return out


def run_normal(args):
    names = datasets.scan_obj_tree(args.data_path)
    os.makedirs(args.out, exist_ok=True)
    jobs = [(p, args.out, args.operator, args.hack, args.uniform_mesh) for p in names]
    with multiprocessing.Pool(args.workers) as pool:
        written = [p for p in pool.map(_normal_worker, jobs, chunksize=4) if p]
    print(f"wrote {len(written)}/{len(names)} meshes -> {args.out}")


# -------------------------------------------------------------- arap


def _arap_worker(job):
    seq_dir, out_dir, op_frames = job
    frame_paths = sorted(glob.glob(os.path.join(seq_dir, "*.obj")))
    if not frame_paths:
        return None
    frames = []
    for i, p in enumerate(frame_paths):
        V, F = geo.load_obj(p)
        frame = {"V": V.astype(np.float32), "F": F.astype(np.int32)}
        if i < op_frames:
            frame["L"] = geo.igl_style_laplacian(V, F, hack=1.0).astype(np.float32)
        frames.append(frame)
    out = os.path.join(out_dir, os.path.basename(os.path.normpath(seq_dir)) + ".npy")
    with open(out, "wb") as fh:
        write_npy(fh, np.asarray(frames, dtype=object))
    return out


def run_arap(args):
    seq_dirs = sorted(d for d in glob.glob(os.path.join(args.data_path, "*")) if os.path.isdir(d))
    os.makedirs(args.out, exist_ok=True)
    jobs = [(d, args.out, args.op_frames) for d in seq_dirs]
    with multiprocessing.Pool(args.workers) as pool:
        written = [p for p in pool.map(_arap_worker, jobs) if p]
    print(f"wrote {len(written)}/{len(seq_dirs)} sequences -> {args.out}")


# -------------------------------------------------------------- cli


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Offline operator preprocessing")
    sub = parser.add_subparsers(dest="task", required=True)

    m = sub.add_parser("mnist", help="MNIST idx -> mesh dataset pickle")
    m.add_argument("--images", required=True)
    m.add_argument("--labels", required=True)
    m.add_argument("--out", default="train_plus.np")
    m.add_argument("--limit", type=int, default=None)
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--workers", type=int, default=os.cpu_count())
    m.set_defaults(fn=run_mnist)

    n = sub.add_parser("normal", help=".obj tree -> per-mesh .npz with operators")
    n.add_argument("--data-path", required=True)
    n.add_argument("--out", required=True)
    n.add_argument("--operator", default="lap", choices=["lap", "dirac"])
    n.add_argument("--hack", type=float, default=1.0)
    n.add_argument("--uniform-mesh", action="store_true")
    n.add_argument("--workers", type=int, default=os.cpu_count())
    n.set_defaults(fn=run_normal)

    a = sub.add_parser("arap", help="frame-.obj sequence dirs -> data_plus .npy")
    a.add_argument("--data-path", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--op-frames", type=int, default=10,
                   help="frames per sequence that get operators (reference: 10)")
    a.add_argument("--workers", type=int, default=os.cpu_count())
    a.set_defaults(fn=run_arap)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
