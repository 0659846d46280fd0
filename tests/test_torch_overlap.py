"""The overlap check of the partitioned applies (``dist/analysis.py``) on
four gloo ranks on the CPU, against the JAX package's check.

On the meshes of JAX's ``tests/test_overlap_structure.py`` (a
``random_blob_mesh`` of 1,200 points, RCM-ordered, for the Laplacian and
the GAT attend; one of 800 points, its faces sorted, for the Dirac pair),
each rank runs ``check_overlap_structure`` on its shard of
``partitioned_spmm`` (ELL and BSR interiors), ``partitioned_dirac_vf`` and
``partitioned_dirac_fv`` and the partitioned GAT attend, and on JAX's
negative control, the serialized formulation (the interior computed from
the exchanged frame).  Each apply must show JAX's assertions (on a rank
inside the chain, two directions exchanged; work independent of the halo;
work that depends on it; an output that reads it) and the port's own: the
interior issued before the exchange is waited on.  The control must report
no independent work and no interior before the wait.  JAX's
``check_overlap_structure`` on the same partitioned operators (in
``shard_map`` on the conftest's virtual devices) reports the same truth
values."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import PartitionSpec as P

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu.dist import dirac_partition as jdp
from surfacenetworks_tpu.dist import edge_partition as jep
from surfacenetworks_tpu.dist import make_mesh as jmake_mesh
from surfacenetworks_tpu.dist.analysis import check_overlap_structure as jcheck
from surfacenetworks_tpu_torch import geometry as tgeo
from surfacenetworks_tpu_torch.data import datasets as tdatasets
from surfacenetworks_tpu_torch.dist import mesh_setup
from surfacenetworks_tpu_torch.sparse import rcm_permutation

N_PARTS = 4
HEADS, CH = 2, 8
APPLIES = ["pspmm_ell", "pspmm_bsr", "dirac_vf", "dirac_fv", "gat"]
TRUTHS = ("n_ppermute>=2", "interior_indep>=1", "boundary_dep>=1", "output_depends_on_halo")


def _pad_to(n: int, multiple: int) -> int:
    m = N_PARTS * multiple
    return (n + m - 1) // m * m


def _inputs(tmp) -> dict:
    """The two meshes' operators and seeded features, written for the ranks."""
    rng = np.random.default_rng(0)
    V, F = tdatasets.random_blob_mesh(rng, 1200)
    L = tgeo.igl_style_laplacian(V, F, hack=1.0).tocsr()
    perm = rcm_permutation(L)
    L = L[perm][:, perm].tocsr()
    N = _pad_to(L.shape[0], 128)
    lap = {"data": L.data, "indices": L.indices, "indptr": L.indptr, "shape": np.asarray(L.shape), "N": N,
           "halo": jep.suggest_halo(L), "x": rng.normal(size=(N, 64)).astype(np.float32),
           "xh": rng.normal(size=(N, HEADS, CH)).astype(np.float32),
           "s_src": rng.normal(size=(N, HEADS)).astype(np.float32),
           "s_dst": rng.normal(size=(N, HEADS)).astype(np.float32)}
    rng = np.random.default_rng(1)
    V, F = tdatasets.random_blob_mesh(rng, 800)
    L2 = tgeo.igl_style_laplacian(V, F, hack=1.0).tocsr()
    perm = rcm_permutation(L2)
    inv = tgeo.invert_permutation(perm)
    V, F = V[perm].astype(np.float32), inv[np.asarray(F)].astype(np.int32)
    F = F[jdp.sort_faces_for_partition(F)]
    Nv, Mf = _pad_to(V.shape[0], 8), _pad_to(F.shape[0], 8)
    dirac = {"V": V, "F": F, "N": Nv, "M": Mf, "v": rng.normal(size=(Nv, 64)).astype(np.float32),
             "f": rng.normal(size=(Mf, 64)).astype(np.float32)}
    np.savez(tmp / "lap.npz", **lap)
    np.savez(tmp / "dirac.npz", **dirac)
    return {"lap": lap, "dirac": dirac, "L": L}


def _overlap_rank(mesh, tmp: str) -> None:
    """One rank: the check on each apply's shard and on the serialized
    control; writes ``overlap_r<rank>.json``."""
    import torch

    from surfacenetworks_tpu_torch import geometry
    from surfacenetworks_tpu_torch.dist import analysis, dirac_partition, edge_partition
    from surfacenetworks_tpu_torch.nn.blocks import gat_attend
    from surfacenetworks_tpu_torch.sparse import kernels

    g = mesh.graph_index
    f = np.load(f"{tmp}/lap.npz")
    L = sp.csr_matrix((f["data"], f["indices"], f["indptr"]), shape=tuple(f["shape"]))
    halo, N = int(f["halo"]), int(f["N"])

    def rows(a):
        return edge_partition.shard_rows(torch.from_numpy(a), N_PARTS, g) if a.ndim == 2 else \
            torch.from_numpy(a).narrow(0, g * (a.shape[0] // N_PARTS), a.shape[0] // N_PARTS).contiguous()

    def serialized(op, x_loc):
        m = op.fwd
        left, right = edge_partition._Exchange(x_loc, m.halo, mesh.graph).wait()
        x_ext = torch.cat([left, x_loc, right], dim=-2)
        y = kernels.ell_matmul(m.cols, m.vals, x_ext[..., m.halo:x_ext.shape[-2] - m.halo, :])
        y_bnd = kernels.ell_matmul(m.bnd_cols, m.bnd_vals, x_ext)
        return edge_partition._scatter_add_rows(y, m.bnd_rows, y_bnd)

    res = {}
    with mesh.context(vertex=True, batch=False):
        for fmt in ("ell", "bsr"):
            op = edge_partition.shard_partitioned(
                edge_partition.partition_operator(L, N_PARTS, halo=halo, n_rows=N, interior_fmt=fmt), g)
            res[f"pspmm_{fmt}"] = analysis.check_overlap_structure(edge_partition.partitioned_spmm, op, rows(f["x"]))
            if fmt == "ell":
                res["serialized"] = analysis.check_overlap_structure(serialized, op, rows(f["x"]))
                xh = torch.from_numpy(f["xh"]).narrow(0, g * (N // N_PARTS), N // N_PARTS).contiguous()
                res["gat"] = analysis.check_overlap_structure(gat_attend, op, xh, rows(f["s_src"]),
                                                              rows(f["s_dst"]))
        d = np.load(f"{tmp}/dirac.npz")
        coeffs = geometry.dirac_coeffs(d["V"], d["F"])
        pd = dirac_partition.shard_partitioned_dirac(
            dirac_partition.partition_dirac(coeffs, N_PARTS, int(d["N"]), int(d["M"])), g)
        res["dirac_vf"] = analysis.check_overlap_structure(dirac_partition.partitioned_dirac_vf, pd, rows(d["v"]))
        res["dirac_fv"] = analysis.check_overlap_structure(dirac_partition.partitioned_dirac_fv, pd, rows(d["f"]))
    with open(f"{tmp}/overlap_r{mesh.rank}.json", "w") as fp:
        json.dump(res, fp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap")
    data = _inputs(tmp)
    mesh_setup.launch(_overlap_rank, 1, N_PARTS, args=(str(tmp),), device="cpu", timeout_s=120)
    ranks = [json.loads((tmp / f"overlap_r{r}.json").read_text()) for r in range(N_PARTS)]
    return data, ranks


def _truths(r: dict) -> tuple:
    return (r["n_ppermute"] >= 2, r["interior_indep"] >= 1, r["boundary_dep"] >= 1, r["output_depends_on_halo"])


@pytest.mark.parametrize("apply", APPLIES)
def test_partitioned_apply_overlap_structure(apply, runs):
    """JAX's assertions on the ranks inside the chain (two neighbours: two
    directions exchanged), every rank's interior issued before its wait,
    and a chain end exchanging one direction."""
    _, ranks = runs
    for rank, res in enumerate(ranks):
        r = res[apply]
        inner = 0 < rank < N_PARTS - 1
        assert r["n_ppermute"] >= (2 if inner else 1), (apply, rank, r)
        assert r["interior_indep"] >= 1, (apply, rank, r)  # overlappable interior aggregation
        assert r["boundary_dep"] >= 1, (apply, rank, r)  # boundary rows wait for the halo
        assert r["output_depends_on_halo"], (apply, rank, r)  # the exchange is live
        assert r["interior_before_wait"], (apply, rank, r)  # and the interior is queued before the wait


def test_serialized_formulation_is_detected(runs):
    """The negative control: the interior computed from the exchanged frame
    leaves nothing to overlap, and nothing is issued before the wait."""
    _, ranks = runs
    for rank, res in enumerate(ranks):
        r = res["serialized"]
        assert r["n_ppermute"] >= (2 if 0 < rank < N_PARTS - 1 else 1), r
        assert r["interior_indep"] == 0 and not r["interior_before_wait"], (rank, r)
        assert r["boundary_dep"] >= 2 and r["output_depends_on_halo"], (rank, r)


def _jax_reports(data) -> dict:
    """JAX's check on the same partitioned operators, in ``shard_map`` over
    four virtual devices."""
    lap, d, L = data["lap"], data["dirac"], data["L"]
    mesh = jmake_mesh(n_data=1, n_graph=N_PARTS, devices=jax.devices()[:N_PARTS])
    out = {}

    def shard(fn, n_in=2):
        return jax.shard_map(fn, mesh=mesh, in_specs=(P("graph"),) * n_in, out_specs=P("graph"))

    with mesh:
        x = jnp.asarray(lap["x"])
        for fmt in ("ell", "bsr"):
            pop = jep.partition_operator(L, N_PARTS, halo=int(lap["halo"]), n_rows=int(lap["N"]), interior_fmt=fmt)
            out[f"pspmm_{fmt}"] = jcheck(shard(jep.partitioned_spmm), pop, x)
            if fmt == "ell":
                def serialized(op, x_loc):
                    mm = op.fwd
                    x_ext = jep._halo_exchange(x_loc, mm.halo, mm.axis)
                    x_mid = x_ext[..., mm.halo: x_ext.shape[-2] - mm.halo, :]
                    y = jep._ell_local(mm.cols, mm.vals, x_mid)
                    return jep._scatter_add_rows(y, mm.bnd_rows, jep._ell_local(mm.bnd_cols, mm.bnd_vals, x_ext))

                out["serialized"] = jcheck(shard(serialized), pop, x)
        pd = jdp.partition_dirac(jgeo.dirac_coeffs(d["V"], d["F"]), N_PARTS, int(d["N"]), int(d["M"]))
        out["dirac_vf"] = jcheck(shard(jdp.partitioned_dirac_vf), pd, jnp.asarray(d["v"]))
        out["dirac_fv"] = jcheck(shard(jdp.partitioned_dirac_fv), pd, jnp.asarray(d["f"]))
    return out


def test_jax_check_agrees(runs):
    """JAX's ``check_overlap_structure`` on the same operators gives the same
    truth values as the port's on its inner ranks, for the Laplacian (ELL
    and BSR interiors), the Dirac pair and the serialized control."""
    data, ranks = runs
    jax_rep = _jax_reports(data)
    for name, jr in jax_rep.items():
        port = ranks[1][name]
        assert _truths(port) == _truths(jr), (name, port, jr)
    assert jax_rep["serialized"]["interior_indep"] == 0 == ranks[1]["serialized"]["interior_indep"]
