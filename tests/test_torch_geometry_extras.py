"""The port's library geometry against the JAX package's: the Poisson-disc
sampler and the mesh-MNIST mesh synthesis (``geometry/sampling.py``), the
spectral descriptors (``geometry/spectral.py``) and the rest of
``graph_ops``, ``mesh_ops`` and ``repair``, on the same inputs.

The code is the same NumPy and SciPy in both packages, so every result is
held bit for bit, but where ARPACK's ``eigsh`` runs: its starting vector is
drawn by ARPACK itself, so two calls agree to the solver's convergence, not
bit for bit.  Those are held to 1e-8 relative on eigenvalues, 1e-6 on
eigenvectors (up to sign) and 1e-6 relative on the WKS and HKS descriptors
built from them.
"""

import numpy as np
import pytest

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.geometry import repair as jrepair
from surfacenetworks_tpu.geometry import sampling as jsampling
from surfacenetworks_tpu.geometry import spectral as jspectral
from surfacenetworks_tpu_torch import geometry as geo
from surfacenetworks_tpu_torch.data import datasets
from surfacenetworks_tpu_torch.geometry import repair, sampling, spectral

from torch_parity import assert_same

EIG_RTOL = 1e-8
VEC_ATOL = 1e-6
DESCRIPTOR_RTOL = 1e-6


def _blob(n=80, seed=0):
    return datasets.random_blob_mesh(np.random.default_rng(seed), n)


def _digit(seed=1):
    img = np.zeros((28, 28))
    rng = np.random.default_rng(seed)
    r, c = rng.integers(4, 10, 2)
    img[r : r + 12, c : c + 12] = rng.uniform(120, 255, size=(12, 12))
    return img


# ------------------------------------------------------------------- sampling


@pytest.mark.parametrize("d,r,extent,seed_point", [(2, 1.5, 27.0, None), (2, 1.5, 27.0, (13.0, 13.0)),
                                                   (1, 0.8, 20.0, None), (3, 2.5, 10.0, None)])
def test_poisson_disc_matches_jax(d, r, extent, seed_point):
    got = sampling.poisson_disc(r, (extent,) * d, seed_point=seed_point, rng=np.random.default_rng(d))
    ref = jsampling.poisson_disc(r, (extent,) * d, seed_point=seed_point, rng=np.random.default_rng(d))
    assert_same(got, ref)
    assert_same(sampling.poisson_disc_2d(r, extent, extent / 2, k=10, rng=np.random.default_rng(7)),
          jsampling.poisson_disc_2d(r, extent, extent / 2, k=10, rng=np.random.default_rng(7)))


def test_bilinear_interpolate_matches_jax():
    img = _digit()
    rng = np.random.default_rng(0)
    for y, x in rng.uniform(0, 27, size=(200, 2)):
        assert sampling.bilinear_interpolate(img, y, x) == jsampling.bilinear_interpolate(img, y, x)


@pytest.mark.parametrize("seed", [1, 2])
def test_image_to_mesh_and_operators_match_jax(seed):
    img = _digit(seed)
    got = sampling.image_to_mesh(img, label=seed, rng=np.random.default_rng(seed))
    ref = jsampling.image_to_mesh(img, label=seed, rng=np.random.default_rng(seed))
    assert got is not None
    assert_same(got, ref)
    assert_same(sampling.add_operators(got), jsampling.add_operators(ref))


def test_image_to_mesh_rejection_matches_jax():
    """Too few points at a large radius: every try is rejected, in both."""
    img = _digit()
    assert sampling.image_to_mesh(img, 0, r=6.0, max_tries=3, rng=np.random.default_rng(0)) is None
    assert jsampling.image_to_mesh(img, 0, r=6.0, max_tries=3, rng=np.random.default_rng(0)) is None


# ------------------------------------------------------------------- spectral


def test_cot_and_mass_matches_jax():
    V, F = _blob(60, seed=5)
    assert_same(spectral.cot_and_mass(V, F), jspectral.cot_and_mass(V, F))


def test_normalized_laplacian_matches_jax():
    V, F = _blob(50, seed=7)
    assert_same(spectral.normalized_laplacian(V, F), jspectral.normalized_laplacian(V, F))
    V0 = np.concatenate([V, np.zeros((1, 3))])  # an unreferenced vertex has no mass
    assert spectral.normalized_laplacian(V0, F) is None and jspectral.normalized_laplacian(V0, F) is None


def test_laplacian_eigendecomp_matches_jax():
    V, F = _blob(60, seed=5)
    vals, vecs = spectral.laplacian_eigendecomp(V, F, k=10)
    jvals, jvecs = jspectral.laplacian_eigendecomp(V, F, k=10)
    np.testing.assert_allclose(vals, jvals, rtol=EIG_RTOL, atol=1e-12)
    signs = np.sign((vecs * jvecs).sum(axis=0))
    np.testing.assert_allclose(vecs * signs, jvecs, atol=VEC_ATOL)
    assert abs(vals[0]) < 1e-6


@pytest.mark.parametrize("which", ["wks", "hks", "hks times"])
def test_descriptors_match_jax(which):
    V, F = _blob(60, seed=6)
    if which == "wks":
        got, ref = (m.compute_wks(V, F, n_descriptors=16, k=30) for m in (spectral, jspectral))
    elif which == "hks":
        got, ref = (m.heat_kernel_signature(V, F, k=20) for m in (spectral, jspectral))
    else:
        t = np.geomspace(0.01, 1.0, 5)
        got, ref = (m.heat_kernel_signature(V, F, times=t, k=20) for m in (spectral, jspectral))
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=DESCRIPTOR_RTOL, atol=1e-12 * np.abs(ref).max())


# ------------------------------------------------------------------ graph_ops


def _knn(V, k=6):
    d = np.linalg.norm(V[:, None] - V[None, :], axis=-1)
    idx = np.argsort(d, axis=1)[:, 1 : k + 1]
    return np.take_along_axis(d, idx, axis=1), idx


@pytest.mark.parametrize("name", ["knn_adjacency", "exp_weights", "uniform_weights", "graph_laplacian",
                                  "vertex_adjacency", "normalized_adjacency", "left_normalized_adjacency",
                                  "sym_norm_laplacian", "triangle_triangle_adjacency", "dual_adjacency",
                                  "amp_pyramid"])
def test_graph_ops_match_jax(name):
    V, F = _blob(70, seed=9)
    dist, idx = _knn(V)
    W = geo.knn_adjacency(dist, idx)
    D = geo.dist_matrix(V, F)
    args = lambda: {  # noqa: E731  (fresh arguments for each call: the weights functions write into theirs)
        "knn_adjacency": (dist, idx),
        "exp_weights": (D.copy(), 0.05),
        "uniform_weights": (D.copy(),),
        "graph_laplacian": (W,),
        "vertex_adjacency": (F, V.shape[0] + 2),
        "normalized_adjacency": (F,),
        "left_normalized_adjacency": (F,),
        "sym_norm_laplacian": (F,),
        "triangle_triangle_adjacency": (F,),
        "dual_adjacency": (F,),
        "amp_pyramid": (geo.mesh_laplacian(V, F), 3),
    }[name]
    got, ref = getattr(geo, name)(*args()), getattr(jgeo, name)(*args())
    if name == "amp_pyramid":
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            assert_same(g, r, name)
    else:
        assert_same(got, ref, name)
    if name == "graph_laplacian":
        for normalized, symmetric in ((False, True), (True, False)):
            assert_same(geo.graph_laplacian(W, normalized=normalized, symmetric=symmetric),
                  jgeo.graph_laplacian(W, normalized=normalized, symmetric=symmetric), name)


# -------------------------------------------------------------------- mesh_ops


@pytest.mark.parametrize("name", ["face_normals", "face_normals raw", "centroids", "gaussian_curvature",
                                  "gaussian_curvature area", "mean_curvature", "curvature_features",
                                  "unit_bounding_box", "rescale_V", "pca_whiten", "permute_sparse"])
def test_mesh_ops_match_jax(name):
    V, F = _blob(90, seed=11)
    perm = np.random.default_rng(0).permutation(V.shape[0])
    call = {
        "face_normals": lambda m: m.face_normals(V, F),
        "face_normals raw": lambda m: m.face_normals(V, F, normalize=False),
        "centroids": lambda m: m.centroids(V, F),
        "gaussian_curvature": lambda m: m.gaussian_curvature(V, F),
        "gaussian_curvature area": lambda m: m.gaussian_curvature(V, F, area_avg=True),
        "mean_curvature": lambda m: m.mean_curvature(V, F),
        "curvature_features": lambda m: m.curvature_features(V, F),
        "unit_bounding_box": lambda m: m.unit_bounding_box(V.astype(np.float32)),
        "rescale_V": lambda m: m.rescale_V(V),
        "pca_whiten": lambda m: m.pca_whiten(V),
        "permute_sparse": lambda m: m.permute_sparse(m.mesh_laplacian(V, F), perm),
    }[name]
    got, ref = call(geo), call(jgeo)
    assert_same(got, ref, name)
    if name == "curvature_features":
        assert got.shape == (V.shape[0], 4) and np.abs(got).max() <= 1.0


# ---------------------------------------------------------------------- repair


def _degenerate_mesh():
    V = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [0.5, 1, 0], [1.5, 1, 0], [1, -1, 0]], float)
    F = np.array([[0, 1, 3], [1, 4, 3], [1, 2, 4], [0, 2, 1], [0, 1, 5], [1, 2, 5]])
    return V, F


def test_degenerate_faces_and_zero_mass_match_jax():
    V, F = _degenerate_mesh()
    assert_same(repair.degenerate_faces(V, F), jrepair.degenerate_faces(V, F))
    assert len(repair.degenerate_faces(V, F)) == 1
    V0 = np.concatenate([V, [[5.0, 5.0, 0.0]]])  # an isolated vertex
    assert_same(repair.zero_mass_vertices(V0, F), jrepair.zero_mass_vertices(V0, F))
    assert list(repair.zero_mass_vertices(V0, F)) == [6]


@pytest.mark.parametrize("case", ["collinear", "short edge", "clean blob"])
def test_fix_degenerate_matches_jax(case):
    if case == "collinear":
        V, F = _degenerate_mesh()
    else:
        V, F = _blob(60, seed=12)
        if case == "short edge":
            V = V.copy()
            V[F[0, 1]] = V[F[0, 0]] + 1e-6  # a near-zero edge to collapse
    got, ref = repair.fix_degenerate(V, F), jrepair.fix_degenerate(V, F)
    assert_same(got, ref, case)
    assert got[2] is True


def test_collapse_remove_and_largest_component_match_jax():
    V, F = _blob(40, seed=3)
    assert_same(repair.collapse_edge(V, F, int(F[0, 0]), int(F[0, 1])), jrepair.collapse_edge(V, F, int(F[0, 0]), int(F[0, 1])))
    V2, F2 = repair.collapse_edge(V, F, int(F[0, 0]), int(F[0, 1]))
    assert_same(repair.remove_unreferenced(V2, F2), jrepair.remove_unreferenced(V2, F2))
    V1, F1 = _blob(40, seed=1)
    Vb, Fb = _blob(30, seed=2)
    Vc = np.concatenate([V1, Vb + 5.0])
    Fc = np.concatenate([F1, Fb + V1.shape[0]])
    got = repair.largest_component(Vc, Fc)
    assert_same(got, jrepair.largest_component(Vc, Fc))
    assert got[1].shape[0] == F1.shape[0]
    assert_same(repair.largest_component(V1, F1), jrepair.largest_component(V1, F1))


def test_constrained_edge_flip_matches_jax():
    V, F = _blob(100, seed=4)
    got = repair.constrained_edge_flip(V, F.copy(), 30, rng=np.random.default_rng(0))
    ref = jrepair.constrained_edge_flip(V, F.copy(), 30, rng=np.random.default_rng(0))
    assert_same(got, ref)
    assert not np.array_equal(got[1], F)


def test_blob_meshes_match_jax():
    """The meshes the tests above start from are the JAX package's."""
    assert_same(_blob(70, seed=9), jdatasets.random_blob_mesh(np.random.default_rng(9), 70))
