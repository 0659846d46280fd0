"""The port's host side (geometry, packing, batching) against the JAX
package's on seeded blob meshes.  Both run the same NumPy/SciPy code, so the
arrays must be equal, not only close."""

import dataclasses
import pathlib

import numpy as np
import pytest

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu import sparse as jsps
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu_torch import geometry as tgeo
from surfacenetworks_tpu_torch import sparse as tsps
from surfacenetworks_tpu_torch.data import batching as tbat
from surfacenetworks_tpu_torch.data import datasets as tdatasets

N_POINTS = 300  # pads to 384 rows: three BSR block-rows
FAUST = sorted(str(p) for p in (pathlib.Path(__file__).parent / "fixtures" / "faust").glob("*.npz"))


def _mesh(seed=0):
    return jdatasets.random_blob_mesh(np.random.default_rng(seed), N_POINTS)


def _equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _sparse_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    _equal(a.indptr, b.indptr, "indptr")
    _equal(a.indices, b.indices, "indices")
    _equal(a.data, b.data, "data")


def case_random_blob_mesh():
    V, F = _mesh()
    tV, tF = tdatasets.random_blob_mesh(np.random.default_rng(0), N_POINTS)
    _equal(tV, V, "V")
    _equal(tF, F, "F")


def case_igl_style_laplacian():
    V, F = _mesh()
    _sparse_equal(tgeo.igl_style_laplacian(V, F, hack=1.0), jgeo.igl_style_laplacian(V, F, hack=1.0))
    _sparse_equal(tgeo.igl_style_laplacian(V, F, hack=None), jgeo.igl_style_laplacian(V, F, hack=None))


def case_mesh_laplacian_parts():
    V, F = _mesh()
    tW, tA = tgeo.cotangent_weights(V, F)
    jW, jA = jgeo.cotangent_weights(V, F)
    _sparse_equal(tgeo.laplacian(tW, tA), jgeo.laplacian(jW, jA))
    _equal(tgeo.face_areas(V, F), jgeo.face_areas(V, F), "face_areas")
    _equal(tgeo.edge_lengths(V, F), jgeo.edge_lengths(V, F), "edge_lengths")


def case_vertex_normals():
    V, F = _mesh()
    _equal(tgeo.vertex_normals(V, F), jgeo.vertex_normals(V, F))


def case_rcm_permutation():
    V, F = _mesh()
    L = jgeo.igl_style_laplacian(V, F)
    perm = tsps.rcm_permutation(L)
    _equal(perm, jsps.rcm_permutation(L))
    _equal(tgeo.invert_permutation(perm), jgeo.invert_permutation(perm))


def case_ell_from_scipy():
    V, F = _mesh()
    L = jgeo.igl_style_laplacian(V, F)
    for kw in ({}, {"k": 16, "n_rows": 384, "n_cols": 384}, {"k_multiple": 8}):
        t, j = tsps.ell_from_scipy(L, **kw), jsps.ell_from_scipy(L, **kw)
        _equal(t.cols.numpy(), j.cols, "cols")
        _equal(t.vals.numpy(), j.vals, "vals")
        assert (t.n_cols, t.window) == (j.n_cols, j.window), kw
    t, j = tsps.operator_from_scipy(L, n_rows=384, n_cols=384), jsps.operator_from_scipy(L, n_rows=384, n_cols=384)
    _equal(t.bwd.cols.numpy(), j.bwd.cols, "bwd cols")
    _equal(t.bwd.vals.numpy(), j.bwd.vals, "bwd vals")


def case_bsr_from_scipy():
    V, F = _mesh()
    L = jgeo.igl_style_laplacian(V, F)
    perm = jsps.rcm_permutation(L)
    Lr = L.tocsr()[perm][:, perm].tocsr()
    for kw in ({}, {"k": 3, "n_rows": 384, "n_cols": 384}):
        t, j = tsps.bsr_operator_from_scipy(Lr, **kw), jsps.bsr_operator_from_scipy(Lr, **kw)
        for side in ("fwd", "bwd"):
            tm, jm = getattr(t, side), getattr(j, side)
            _equal(tm.block_cols.numpy(), jm.block_cols, f"{side} block_cols")
            _equal(tm.block_vals.numpy(), jm.block_vals, f"{side} block_vals")
            assert tm.n_cols == jm.n_cols


def case_fit_bsr_k():
    samples = jdatasets.synthetic_normal_dataset(3, N_POINTS, seed=4)
    samples = [jbat.rcm_reorder_sample(s) for s in samples]
    jb, tb = jbat.Buckets(n_vertices=384), tbat.Buckets(n_vertices=384)
    assert tbat.fit_bsr_k(samples, tb) == jbat.fit_bsr_k(samples, jb) == jb.bsr_k == tb.bsr_k
    for s in samples:
        assert tbat.bsr_k_needed(s["L"]) == jbat.bsr_k_needed(s["L"])
        assert tbat.bsr_k_needed(s["L"], 64) == jbat.bsr_k_needed(s["L"], 64)


def case_synthetic_normal_dataset():
    for t, j in zip(tdatasets.synthetic_normal_dataset(2, 120, seed=1),
                    jdatasets.synthetic_normal_dataset(2, 120, seed=1)):
        for key in ("V", "F", "input", "target"):
            _equal(t[key], j[key], key)
        _sparse_equal(t["L"], j["L"])


def case_rcm_reorder_sample():
    (s,) = jdatasets.synthetic_normal_dataset(1, N_POINTS, seed=2)
    t, j = tbat.rcm_reorder_sample(s), jbat.rcm_reorder_sample(s)
    for key in ("V", "F", "input", "target", "rcm_perm"):
        _equal(t[key], j[key], key)
    _sparse_equal(t["L"], j["L"])


def _equal_sample(t, j):
    """Every key of two sample dicts equal (sparse operators by structure
    and values, ``None`` as ``None``)."""
    assert sorted(t) == sorted(j), (sorted(t), sorted(j))
    for key in j:
        if j[key] is None or isinstance(j[key], str):
            assert t[key] == j[key], key
        elif hasattr(j[key], "tocsr"):
            _sparse_equal(t[key], j[key])
        else:
            _equal(t[key], j[key], key)


def case_rcm_reorder_correspondence_sample():
    """A correspondence sample: ``G`` permuted along both axes, ``label_inv``
    remapped (its values are vertex indices), Dirac coefficients dropped."""
    (s,) = jdatasets.synthetic_correspondence_dataset(1, n_points=60, seed=1)
    s["dirac"] = np.zeros((3, 3), np.float32)
    _equal_sample(tbat.rcm_reorder_sample(s), jbat.rcm_reorder_sample(s))


def case_synthetic_correspondence_dataset():
    for t, j in zip(tdatasets.synthetic_correspondence_dataset(3, n_points=80, seed=2),
                    jdatasets.synthetic_correspondence_dataset(3, n_points=80, seed=2)):
        _equal_sample(t, j)


def case_load_faust_npz():
    for path in FAUST:
        _equal_sample(tdatasets.load_faust_npz(path), jdatasets.load_faust_npz(path))


def case_buckets_and_format():
    samples = jdatasets.synthetic_normal_dataset(2, 150, seed=3)
    t, j = tbat.Buckets.for_samples(samples), jbat.Buckets.for_samples(samples)
    assert (t.n_vertices, t.n_faces, t.ell_k, t.ell_k_t, t.bsr_block, t.bsr_k) == (
        j.n_vertices, j.n_faces, j.ell_k, j.ell_k_t, j.bsr_block, j.bsr_k)
    for b, n, ok in [(4, 1008, False), (1, 7040, False), (1, 7040, True), (64, 2048, False)]:
        assert tbat.choose_operator_format(b, n, ok) == jbat.choose_operator_format(b, n, ok)
    assert tbat.round_up(1000, 128) == jbat.round_up(1000, 128) == 1024


@pytest.mark.parametrize("fmt", ["ell", "bsr", "dense"])
def test_laplacian_batch_matches_jax(fmt):
    samples = jdatasets.synthetic_normal_dataset(2, 200, seed=5)
    if fmt == "bsr":
        samples = [jbat.rcm_reorder_sample(s) for s in samples]
    jb = jbat.Buckets(n_vertices=256, n_faces=512)
    tb = tbat.Buckets(n_vertices=256, n_faces=512)
    if fmt == "bsr":
        jbat.fit_bsr_k(samples, jb)
        tbat.fit_bsr_k(samples, tb)
    j = jbat.laplacian_batch(samples, jb, fmt=fmt)
    t = tbat.laplacian_batch(samples, tb, fmt=fmt)
    for key in ("inputs", "targets", "mask", "faces"):
        _equal(getattr(t, key).numpy(), getattr(j, key), key)
    if fmt == "dense":
        _equal(t.operator.numpy(), j.operator, "dense operator")
        return
    for side in ("fwd", "bwd"):
        tm, jm = getattr(t.operator, side), getattr(j.operator, side)
        for f in dataclasses.fields(tm):
            tv, jv = getattr(tm, f.name), getattr(jm, f.name)
            if isinstance(tv, int):
                assert tv == jv, f.name
            else:
                _equal(tv.numpy(), jv, f"{side}.{f.name}")


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_correspondence_batch_matches_jax(fmt):
    """The siamese trainer's per-shape batch on the committed FAUST scans."""
    samples = [jdatasets.load_faust_npz(p) for p in FAUST]
    if fmt == "bsr":
        samples = [jbat.rcm_reorder_sample(s) for s in samples]
    multiple = 128 if fmt == "bsr" else 8
    jb, tb = jbat.Buckets.for_samples(samples, multiple), tbat.Buckets.for_samples(samples, multiple)
    if fmt == "bsr":
        assert tbat.fit_bsr_k(samples, tb) == jbat.fit_bsr_k(samples, jb)
    for s in samples:
        j = jbat.correspondence_batch(s, jb, fmt=fmt)
        t = tbat.correspondence_batch(s, tb, fmt=fmt)
        _equal(t.inputs.numpy(), j.inputs, "inputs")
        _equal(t.mask.numpy(), j.mask, "mask")
        for tv, jv, what in zip(t.targets, j.targets, ("G", "label", "label_inv")):
            _equal(tv, jv, what)
        for side in ("fwd", "bwd"):
            tm, jm = getattr(t.operator, side), getattr(j.operator, side)
            for f in dataclasses.fields(tm):
                tv, jv = getattr(tm, f.name), getattr(jm, f.name)
                if isinstance(tv, int):
                    assert tv == jv, f.name
                else:
                    _equal(tv.numpy(), jv, f"{side}.{f.name}")


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_side_matches_jax(name):
    CASES[name]()
