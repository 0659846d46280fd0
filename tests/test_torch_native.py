"""The port's native host runtime (``surfacenetworks_tpu_torch/native``, a
``g++`` build of its own copy of ``snx_native.cc``) against the JAX
package's native bindings, bit for bit, and against the port's NumPy route.

Every entry point is compared on ``random_blob_mesh`` meshes and on an
RCM-permuted CSR (whose rows are unsorted: the native forward packer keeps
that slot order, the NumPy one sorts it).  ``SNX_NO_NATIVE`` takes the
NumPy route; a failed build raises.  The data path packs natively where the
JAX package does (``_fixed_k_operator``, the Dirac coefficients), and a
first update of the normal and mesh-MNIST trainers is bit-identical on
either route.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from surfacenetworks_tpu import native as jax_native
from surfacenetworks_tpu.data import batching as jax_batching
from surfacenetworks_tpu_torch import native
from surfacenetworks_tpu_torch.data import batching, datasets
from surfacenetworks_tpu_torch.geometry import mesh_ops
from surfacenetworks_tpu_torch.sparse import ell

from torch_parity import DIRAC_FIELDS, assert_same

OBJS = os.path.join(os.path.dirname(__file__), "fixtures", "objs")
MNIST = os.path.join(os.path.dirname(__file__), "fixtures", "mnist_plus.np")
MESHES = [(0, 80), (1, 300), (2, 1000)]


def _mesh(seed, n):
    return datasets.random_blob_mesh(np.random.default_rng(seed), n)


def _same_op(got, ref, what):
    for side in ("fwd", "bwd"):
        g, r = getattr(got, side), getattr(ref, side)
        assert_same(g.cols, r.cols, f"{what} {side} cols")
        assert_same(g.vals, r.vals, f"{what} {side} vals")
        assert (g.n_cols, g.window) == (r.n_cols, r.window), f"{what} {side}"


def _rcm_csr(seed=1, n=300):
    V, F = _mesh(seed, n)
    L = mesh_ops.igl_style_laplacian(V, F, hack=1.0).tocsr().astype(np.float32)
    perm = batching.rcm_permutation(L)
    P = L[perm][:, perm].tocsr()
    assert not P.has_sorted_indices  # the slot-order case
    return P


def test_library_builds_into_the_ports_build_dir():
    assert native.available()
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libsnx_native_") and path.exists()
    assert native.SOURCE.read_bytes() == open(os.path.join(os.path.dirname(__file__), "..", "csrc",
                                                          "snx_native.cc"), "rb").read()
    assert jax_native.available()


@pytest.mark.parametrize("hack", [1.0, 0.0, None])
@pytest.mark.parametrize("seed,n", MESHES)
def test_igl_laplacian_ell_matches_jax_and_numpy(seed, n, hack):
    V, F = _mesh(seed, n)
    N = n + 5
    got = native.igl_laplacian_ell_arrays(V, F, N, 24, 24, hack=hack)
    for g, r, what in zip(got, jax_native.igl_laplacian_ell_arrays(V, F, N, 24, 24, hack=hack),
                          ("fwd cols", "fwd vals", "bwd cols", "bwd vals")):
        assert_same(g, r, what)
    ref = ell.operator_from_scipy(mesh_ops.igl_style_laplacian(V, F, hack=hack).tocsr().astype(np.float32),
                                  k=24, n_rows=N, n_cols=N)
    # NumPy's transpose takes its own k: compare on the shared slots
    assert_same(got[0], ref.fwd.cols, "numpy fwd cols")
    assert_same(got[1], ref.fwd.vals, "numpy fwd vals")
    kt = ref.bwd.cols.shape[1]
    assert_same(got[2][:, :kt], ref.bwd.cols, "numpy bwd cols")
    assert_same(got[3][:, :kt], ref.bwd.vals, "numpy bwd vals")
    assert not got[3][:, kt:].any()


@pytest.mark.parametrize("seed,n", MESHES)
def test_mesh_laplacian_ell_and_operator_match_jax(seed, n):
    V, F = _mesh(seed, n)
    N = n + 3
    for g, r in zip(native.mesh_laplacian_ell_arrays(V, F, N, 24, 20), jax_native.mesh_laplacian_ell_arrays(V, F, N, 24, 20)):
        assert_same(g, r, "mesh convention")
    for conv in ("igl", "mesh"):
        got = native.laplacian_ell_operator(V, F, N, 24, convention=conv)
        ref = jax_native.laplacian_ell_operator(V, F, N, 24, convention=conv)
        _same_op(got, ref, conv)
    with pytest.raises(ValueError, match="unknown convention"):
        native.laplacian_ell_operator(V, F, N, 24, convention="cot")


@pytest.mark.parametrize("max_valence", [None, 12])
@pytest.mark.parametrize("seed,n", MESHES)
def test_dirac_coeffs_and_normals_match_jax_and_numpy(seed, n, max_valence):
    V, F = _mesh(seed, n)
    for VV in (V, V.astype(np.float32)):
        got = native.dirac_coeffs(VV, F, max_valence=max_valence)
        for ref in (jax_native.dirac_coeffs(VV, F, max_valence=max_valence),
                    mesh_ops.dirac_coeffs(VV, F, max_valence=max_valence)):
            for f in DIRAC_FIELDS:
                assert_same(getattr(got, f), getattr(ref, f), f)
        assert type(got) is mesh_ops.DiracCoeffs
    assert_same(native.vertex_normals(V, F), jax_native.vertex_normals(V, F), "normals vs jax")
    assert_same(native.vertex_normals(V, F), mesh_ops.vertex_normals(V, F).astype(np.float32), "normals vs numpy")


@pytest.mark.parametrize("case", ["sorted", "rcm", "random"])
def test_csr_packers_match_jax(case):
    if case == "sorted":
        V, F = _mesh(0, 300)
        M = mesh_ops.igl_style_laplacian(V, F, hack=1.0).tocsr().astype(np.float32)
    elif case == "rcm":
        M = _rcm_csr()
    else:
        M = sp.random(60, 60, density=0.12, random_state=np.random.default_rng(3), format="csr", dtype=np.float32)
    N = M.shape[0] + 4
    k = int(np.diff(M.indptr).max())
    kt = int(np.diff(M.T.tocsr().indptr).max())
    for g, r in zip(native.csr_to_ell_arrays(M, N, k), jax_native.csr_to_ell_arrays(M, N, k)):
        assert_same(g, r, f"{case} csr_to_ell")
    got = native.ell_operator_from_csr(M, N, k, kt)
    _same_op(got, jax_native.ell_operator_from_csr(M, N, k, kt), case)
    # the same matrix as NumPy's packing (which sorts its argument's rows in
    # place: hand it a copy); the same slots where the rows are sorted
    ref = ell.operator_from_scipy(M.copy(), k=k, n_rows=N, n_cols=N)
    dense = lambda m: torch.zeros(N, N, dtype=torch.float64).index_put_(  # noqa: E731
        (torch.arange(N).repeat_interleave(m.cols.shape[1]), m.cols.reshape(-1).long()),
        m.vals.reshape(-1).double(), accumulate=True)
    assert torch.equal(dense(got.fwd), dense(ref.fwd)) and torch.equal(dense(got.bwd), dense(ref.bwd))
    assert_same(got.bwd.cols, ref.bwd.cols, f"{case} transpose slots")
    if M.has_sorted_indices:
        _same_op(got, ref, f"{case} vs numpy")
    else:
        assert not torch.equal(got.fwd.cols, ref.fwd.cols)  # unsorted rows keep their slot order


def test_k_too_small_and_short_buffers_raise():
    V, F = _mesh(0, 80)
    L = mesh_ops.igl_style_laplacian(V, F).tocsr().astype(np.float32)
    for call in (lambda: native.igl_laplacian_ell_arrays(V, F, 80, 2, 2),
                 lambda: native.mesh_laplacian_ell_arrays(V, F, 80, 2),
                 lambda: native.csr_to_ell_arrays(L, 80, 2),
                 lambda: native.ell_operator_from_csr(L, 80, 2, 24),
                 lambda: native.ell_operator_from_csr(L, 80, 24, 2)):
        with pytest.raises(ValueError, match="ELL k too small"):
            call()
    with pytest.raises(ValueError, match="ELL k too small"):
        jax_native.igl_laplacian_ell_arrays(V, F, 80, 2, 2)
    for call in (lambda: native.igl_laplacian_ell_arrays(V, F, 79, 24),
                 lambda: native.csr_to_ell_arrays(L, 79, 24),
                 lambda: native.ell_operator_from_csr(L, 79, 24, 24)):
        with pytest.raises(ValueError, match="padded shape smaller"):
            call()


def test_snx_no_native_takes_the_numpy_route(monkeypatch):
    V, F = _mesh(1, 300)
    monkeypatch.setenv("SNX_NO_NATIVE", "1")
    assert not native.available()
    L = _rcm_csr()
    assert native.igl_laplacian_ell_arrays(V, F, 304, 24) is None
    assert native.mesh_laplacian_ell_arrays(V, F, 304, 24) is None
    assert native.csr_to_ell_arrays(L, 304, 24) is None
    assert native.ell_operator_from_csr(L, 304, 24, 24) is None
    got = native.dirac_coeffs(V, F)
    ref = mesh_ops.dirac_coeffs(V, F)
    for f in DIRAC_FIELDS:
        assert_same(getattr(got, f), getattr(ref, f), f)
    assert_same(native.vertex_normals(V, F), mesh_ops.vertex_normals(V, F).astype(np.float32), "normals")
    _same_op(native.laplacian_ell_operator(V, F, 304, 24),
             ell.operator_from_scipy(mesh_ops.igl_style_laplacian(V, F).tocsr(), k=24, n_rows=304, n_cols=304),
             "numpy operator")
    # the data path sorts an RCM-permuted CSR's rows on this route
    b = batching.Buckets(n_vertices=304, ell_k=24, ell_k_t=24)
    numpy_op = batching._fixed_k_operator(L, b, 304)
    _same_op(numpy_op, ell.EllOperator(fwd=ell.ell_from_scipy(L.copy(), k=24, n_rows=304, n_cols=304),
                                        bwd=ell.ell_from_scipy(L.T.tocsr(), k=24, n_rows=304, n_cols=304)),
             "numpy _fixed_k_operator")
    monkeypatch.delenv("SNX_NO_NATIVE")
    assert native.available()
    assert not torch.equal(batching._fixed_k_operator(L, b, 304).fwd.cols, numpy_op.fwd.cols)


@pytest.mark.parametrize("failure", ["missing compiler", "compile error"])
def test_failed_build_raises(tmp_path, monkeypatch, failure):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    if failure == "missing compiler":
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
        match = "cannot run the compiler"
    else:
        src = tmp_path / "broken.cc"
        src.write_text("int snx_abi_version( { return 1; }\n")
        monkeypatch.setattr(native, "SOURCE", src)
        match = "build failed"
    with pytest.raises(RuntimeError, match=match):
        native.available()
    assert not list((tmp_path / "_build").glob("*.so"))


def _rcm_sample():
    V, F = _mesh(2, 400)
    return {"V": V.astype(np.float32), "F": F, "L": mesh_ops.igl_style_laplacian(V, F, hack=1.0)}


def test_fixed_k_operator_matches_jax_on_rcm_samples():
    """The data path's packing of RCM-ordered samples (GAT, FAUST BSR with
    ``--smooth-reg``) equals the JAX package's, which packs natively: the
    slot order of the permuted CSR, bit for bit."""
    s = batching.rcm_reorder_sample(_rcm_sample())
    js = jax_batching.rcm_reorder_sample(_rcm_sample())
    assert np.array_equal(s["rcm_perm"], js["rcm_perm"])
    b = batching.Buckets.for_samples([s])
    jb = jax_batching.Buckets.for_samples([js])
    got = batching._fixed_k_operator(s["L"], b, b.n_vertices)
    ref = jax_batching._fixed_k_operator(js["L"], jb, jb.n_vertices)
    _same_op(got, ell.EllOperator(
        fwd=ell.EllMatrix(cols=torch.from_numpy(np.asarray(ref.fwd.cols)), vals=torch.from_numpy(np.asarray(ref.fwd.vals)),
                          n_cols=ref.fwd.n_cols, window=ref.fwd.window),
        bwd=ell.EllMatrix(cols=torch.from_numpy(np.asarray(ref.bwd.cols)), vals=torch.from_numpy(np.asarray(ref.bwd.vals)),
                          n_cols=ref.bwd.n_cols, window=ref.bwd.window)), "rcm sample")


def _first_update(main, argv, tmp, ckpt):
    hist = main([*argv, "--result-dir", str(tmp)])
    return hist, torch.load(tmp / "pts" / ckpt, weights_only=True)["params"]


@pytest.mark.parametrize("trainer", ["normal lap", "normal dirac", "mnist lap", "mnist dirac"])
def test_first_update_is_unchanged_by_the_native_route(tmp_path, monkeypatch, trainer):
    """The trainers' data on the native route and on the NumPy route give
    the same first update, loss and weights, bit for bit."""
    from surfacenetworks_tpu_torch.cli import train_mnist, train_normal

    family, model = trainer.split()
    if family == "normal":
        main, ckpt = train_normal.main, "debug_normal_state.pt"
        argv = ["--device", "cpu", "--data-path", OBJS, "--model", model, "--layer", "2", "--num-epoch", "1",
                "--num-updates", "1", "--batch-size", "2", "--operator-format", "ell"]
    else:
        main, ckpt = train_mnist.main, "mnist.pt"
        argv = ["--device", "cpu", "--data-path", MNIST, "--model", model, "--layer", "2", "--num-epoch", "1",
                "--batch-size", "4"]
    runs = []
    for route in ("native", "numpy"):
        if route == "numpy":
            monkeypatch.setenv("SNX_NO_NATIVE", "1")
        runs.append(_first_update(main, argv, tmp_path / route, ckpt))
    (h1, p1), (h2, p2) = runs
    assert h1 == h2 and np.isfinite(np.asarray(h1["train"], np.float64)).all()
    assert p1.keys() == p2.keys() and all(torch.equal(p1[k], p2[k]) for k in p1)
