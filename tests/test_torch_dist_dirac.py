"""The port's row-partitioned Dirac pair, partitioned GAT attend and
differentiable exchanges on the CPU, against the JAX package.

* The host code (``partition_dirac``, ``stack_partitioned_dirac`` with
  floors, ``prepartition_dirac``, ``partition_batch_dirac``,
  ``sort_faces_for_partition`` and the halo and divisibility errors) gives
  JAX's arrays bit for bit at 2 and 4 partitions.
* ``partitioned_dirac_vf`` / ``_fv``, forward and VJP, at 2 and 4 ranks
  (through ``nn.blocks.apply_dirac_vf`` / ``_fv``) equal JAX's partitioned
  functions inside ``shard_map`` on the conftest's virtual CPU devices, on
  the same seeded inputs (``tests/test_dirac_partition.py``'s RCM-ordered
  blob mesh with sorted faces), fp64 under ``enable_x64``, within 1e-12 of
  the largest element (the same slot sums in another order).
* The ELL-pair branch of the Dirac dispatch (``(Di, None)`` and ``(None,
  DiA)`` of ``EllOperator``s on quaternion rows, through ``ell_matmul``'s
  plain version here) equals the structured apply on fp64 features within
  1e-6 of the largest element: the pair's entries are the fp64 scipy
  matrices rounded to fp32, the structured coefficients are computed in
  fp32, and the two roundings differ by about 1e-7
  (``tests/test_block_parity.py``'s check at its 1e-5, on a blob mesh: the
  reference cube is not in the repo).
* The partitioned GAT attend at 2 and 4 ranks, its output and the
  gradients of its three inputs, equals JAX's ``_gat_attend_partitioned``
  inside ``shard_map`` (``tests/test_gat.py``'s configuration, fp64) and the
  port's single-device ``gat_attend`` on the whole operator, within 1e-12.
* ``halo_exchange`` and ``parallel_context.gather_rows`` at 2 and 4 ranks in
  fp64: the frames and the gathered rows exact, and the gradient of a
  global objective (each rank's own cotangent) equal to the unsharded
  function's gradient, worked out here in NumPy, within 1e-14.

The ranks run in ``tests/_torch_dist_worker.py`` (four gloo ranks started
once for the file, under a hard timeout that kills them).
"""

import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from surfacenetworks_tpu import geometry as jgeo
from surfacenetworks_tpu import parallel_context as jpc
from surfacenetworks_tpu import sparse as jsps
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu.dist import dirac_partition as jdp
from surfacenetworks_tpu.dist import edge_partition as jep
from surfacenetworks_tpu.dist import graph_parallel as jgp
from surfacenetworks_tpu.dist import make_mesh as jmake_mesh
from surfacenetworks_tpu.nn import blocks as jblocks
from surfacenetworks_tpu_torch.dist import dirac_partition as tdp
from surfacenetworks_tpu_torch.dist import edge_partition as tep
from surfacenetworks_tpu_torch.dist import graph_parallel as tgp
from surfacenetworks_tpu_torch.geometry.mesh_ops import DiracCoeffs
from surfacenetworks_tpu_torch.nn import blocks as tblocks
from surfacenetworks_tpu_torch.sparse import ell as tell
from surfacenetworks_tpu_torch.sparse import ops as tops

from torch_parity import assert_close

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_dist_worker.py"
WORKER_TIMEOUT_S = 120
RTOL = 1e-12
EXCHANGE_RTOL = 1e-14
ELL_PAIR_RTOL = 1e-6
PARTS = (2, 4)
COEFF_FIELDS = ("F", "q_fv", "vf_face", "vf_corner", "q_vf", "q_bwd_v", "q_bwd_f")


def _pad_to(n: int, n_parts: int, multiple: int = 8) -> int:
    m = n_parts * multiple
    return (n + m - 1) // m * m


def _mesh(n_points: int = 400, seed: int = 0):
    """``tests/test_dirac_partition.py``'s mesh: a blob, RCM-ordered
    vertices, faces sorted by their smallest vertex (the JAX package's
    code), with its Dirac coefficients."""
    V, F = jdatasets.random_blob_mesh(np.random.default_rng(seed), n_points)
    L = jgeo.igl_style_laplacian(V, F, hack=1.0).tocsr()
    perm = jsps.rcm_permutation(L)
    inv = jgeo.invert_permutation(perm)
    V, F = V[perm].astype(np.float32), inv[F].astype(np.int32)
    F = F[jdp.sort_faces_for_partition(F)]
    return V, F, jgeo.dirac_coeffs(V, F)


def _port_coeffs(c) -> DiracCoeffs:
    return DiracCoeffs(**{k: np.asarray(getattr(c, k)) for k in COEFF_FIELDS}, n_vertices=c.n_vertices,
                       n_faces=c.n_faces)


def _same(t, j, what: str) -> None:
    for f in tdp._TENSOR_FIELDS:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")
    assert (t.halo_v, t.halo_f, t.n_parts, t.axis) == (j.halo_v, j.halo_f, j.n_parts, j.axis), what


# ---------------------------------------------------------------------------
# host side, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_parts", PARTS)
def test_partition_dirac_matches_jax(n_parts):
    """``partition_dirac`` (measured halos, interior and boundary tables of
    both row families) on the blob mesh: JAX's arrays bit for bit."""
    _, F, c = _mesh()
    N, M = _pad_to(c.n_vertices, n_parts), _pad_to(c.n_faces, n_parts)
    t = tdp.partition_dirac(_port_coeffs(c), n_parts, N, M)
    _same(t, jdp.partition_dirac(c, n_parts, N, M), "partition_dirac")
    assert t.fbnd_rows.shape[0] > 0 and t.vbnd_rows.shape[0] > 0  # the boundary tables are exercised
    assert t.halo_v < N // n_parts and t.halo_f < M // n_parts


@pytest.mark.parametrize("n_parts", PARTS)
def test_prepartition_and_stack_dirac_match_jax(n_parts):
    """``prepartition_dirac`` (shared halos, ``min_mbf``/``min_mbv``
    floors) over three meshes, ``stack_partitioned_dirac`` of a batch with
    the floors, and ``partition_batch_dirac``: JAX's arrays bit for bit."""
    meshes = [_mesh(160 + 40 * s, seed=s) for s in range(3)]
    N = _pad_to(max(c.n_vertices for *_, c in meshes), n_parts)
    M = _pad_to(max(c.n_faces for *_, c in meshes), n_parts)
    jc = [c for *_, c in meshes]
    tc = [_port_coeffs(c) for c in jc]
    tops_, tfloors = tgp.prepartition_dirac(tc, n_parts, N, M, max_valence=16)
    jops_, jfloors = jgp.prepartition_dirac(jc, n_parts, N, M, max_valence=16)
    assert tfloors == jfloors
    for i, (t, j) in enumerate(zip(tops_, jops_)):
        _same(t, j, f"prepartitioned {i}")
    _same(tdp.stack_partitioned_dirac([tops_[2], tops_[0]], **tfloors),
          jdp.stack_partitioned_dirac([jops_[2], jops_[0]], **jfloors), "stacked")
    _same(tgp.partition_batch_dirac(tc[:2], n_parts, N, M, max_valence=16),
          jgp.partition_batch_dirac(jc[:2], n_parts, N, M, max_valence=16), "partition_batch_dirac")


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_faces_for_partition_matches_jax(seed):
    """The stable face order by smallest vertex, on an RCM-ordered mesh's
    shuffled faces (ties included)."""
    V, F, _ = _mesh(300, seed)
    F = F[np.random.default_rng(seed + 5).permutation(F.shape[0])]
    np.testing.assert_array_equal(tdp.sort_faces_for_partition(F), jdp.sort_faces_for_partition(F))


@pytest.mark.parametrize("n_parts", PARTS)
def test_partition_dirac_errors_match_jax(n_parts):
    """A halo below the need, a halo wider than a partition and padded
    sizes not divisible by the partitions raise as in JAX."""
    _, _, c = _mesh()
    tc = _port_coeffs(c)
    N, M = _pad_to(c.n_vertices, n_parts), _pad_to(c.n_faces, n_parts)
    for args, kwargs, msg in (((N, M), {"halo_v": 1}, "too small for incidence span"),
                              ((N, M), {"halo_f": M}, "exceed partition sizes"),
                              ((N + 1, M), {}, "not divisible by")):
        with pytest.raises(ValueError, match=msg):
            jdp.partition_dirac(c, n_parts, *args, **kwargs)
        with pytest.raises(ValueError, match=msg):
            tdp.partition_dirac(tc, n_parts, *args, **kwargs)


def test_ell_pair_branch_matches_structured():
    """``apply_dirac_vf`` on ``(Di, None)`` and ``apply_dirac_fv`` on
    ``(None, DiA)`` as ``EllOperator``s on quaternion rows equal the
    structured applies (fp64 features, the pair's fp32 values), and
    ``dirac_num_faces`` reads the pair's face count."""
    V, F, c = _mesh(200, seed=2)
    Dm, DAm = jgeo.dirac(V, F)
    di = tell.stack_operators([tell.operator_from_scipy(Dm.astype(np.float32))])
    dia = tell.stack_operators([tell.operator_from_scipy(DAm.astype(np.float32))])
    dop = tell.stack_dirac([tell.dirac_from_coeffs(_port_coeffs(c))])
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.normal(size=(1, c.n_vertices, 8)))
    f = torch.from_numpy(rng.normal(size=(1, c.n_faces, 8)))
    assert_close(tblocks.apply_dirac_vf((di, None), v), tops.dirac_apply_vf(dop, v), ELL_PAIR_RTOL, "vf")
    assert_close(tblocks.apply_dirac_fv((None, dia), f), tops.dirac_apply_fv(dop, f), ELL_PAIR_RTOL, "fv")
    assert tblocks.dirac_num_faces((di, dia)) == c.n_faces == tblocks.dirac_num_faces(dop)


# ---------------------------------------------------------------------------
# the ranks: the partitioned applies, the attend, the exchanges
# ---------------------------------------------------------------------------


def _run_worker(spec: dict, tmp) -> None:
    """The worker under a hard timeout; on expiry its whole process group
    (the ranks included) is killed."""
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen([sys.executable, str(WORKER), str(path), str(tmp)], cwd=tmp, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"the ranks did not finish in {WORKER_TIMEOUT_S} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-6000:]


def _dirac_inputs(n_parts: int) -> dict:
    _, _, c = _mesh()
    N, M = _pad_to(c.n_vertices, n_parts), _pad_to(c.n_faces, n_parts)
    rng = np.random.default_rng(2)
    arrays = {k: rng.normal(size=(1, n, 16)) for k, n in (("v", N), ("f", M), ("gf", M), ("gv", N))}
    return {**{k: np.asarray(getattr(c, k)) for k in COEFF_FIELDS}, "n_vertices": c.n_vertices,
            "n_faces": c.n_faces, "N": N, "M": M, **arrays}


def _gat_inputs(n_parts: int) -> dict:
    """``tests/test_gat.py``'s partitioned-attend configuration: a 300-point
    blob, RCM-ordered, 2 heads of 8 channels."""
    V, F = jdatasets.random_blob_mesh(np.random.default_rng(0), 300)
    L = jgeo.igl_style_laplacian(V, F, hack=1.0).tocsr()
    perm = jsps.rcm_permutation(L)
    L = L[perm][:, perm].tocsr()
    N = _pad_to(L.shape[0], n_parts)
    rng = np.random.default_rng(n_parts)
    return {"data": L.data, "indices": L.indices, "indptr": L.indptr, "shape": np.asarray(L.shape), "N": N,
            "halo": min(jep.suggest_halo(L), N // n_parts), "xh": rng.normal(size=(1, N, 2, 8)),
            "ss": rng.normal(size=(1, N, 2)), "sd": rng.normal(size=(1, N, 2)), "g": rng.normal(size=(1, N, 2, 8))}


def _exchange_inputs(n_parts: int) -> dict:
    rng = np.random.default_rng(10 + n_parts)
    n, halo = 8 * n_parts, 3
    out = {"x": rng.normal(size=(1, n, 5)), "halo": halo}
    for r in range(n_parts):
        out[f"g_ext{r}"] = rng.normal(size=(1, n // n_parts + 2 * halo, 5))
        out[f"g_all{r}"] = rng.normal(size=(1, n, 5))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_dirac")
    cases, inputs = [], {}
    for kind, make in (("dirac", _dirac_inputs), ("gat", _gat_inputs), ("exchange", _exchange_inputs)):
        for n in PARTS:
            name = f"{kind}{n}"
            inputs[name] = make(n)
            np.savez(tmp / f"{name}.npz", **inputs[name])
            cases.append({"name": name, "kind": kind, "n_data": 1, "n_graph": n, "input": str(tmp / f"{name}.npz")})
    _run_worker({"ranks": 4, "timeout": 60, "cases": cases}, tmp)

    def load(name: str) -> list[dict]:
        n = int(name[-1])
        return [dict(np.load(tmp / f"{name}_r{r}.npz")) for r in range(n)]

    load.inputs = inputs
    return load


def _cat(res: list[dict], key: str) -> np.ndarray:
    return np.concatenate([r[key] for r in res], axis=1)


def _jax_dirac(inp: dict, n_parts: int) -> dict:
    """JAX's partitioned applies and their VJPs inside ``shard_map`` on
    ``n_parts`` virtual devices, fp64 features."""
    c = jgeo.DiracCoeffs(**{k: inp[k] for k in COEFF_FIELDS}, n_vertices=int(inp["n_vertices"]),
                         n_faces=int(inp["n_faces"]))
    op = jdp.partition_dirac(c, n_parts, int(inp["N"]), int(inp["M"]))
    mesh = jmake_mesh(n_data=1, n_graph=n_parts, devices=jax.devices()[:n_parts])
    with jax.enable_x64(True), mesh:
        op_d = jdp.shard_partitioned_dirac(mesh, op)

        def sharded(fn):
            return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("graph"), P("graph")), out_specs=P("graph")))

        out = {}
        for name, fn, x, g, bar in (("vf", jdp.partitioned_dirac_vf, "v", "gf", "v_bar"),
                                    ("fv", jdp.partitioned_dirac_fv, "f", "gv", "f_bar")):
            y, vjp = jax.vjp(lambda x_: sharded(fn)(op_d, x_), jnp.asarray(inp[x][0]))
            out[name] = np.asarray(y)[None]
            out[bar] = np.asarray(vjp(jnp.asarray(inp[g][0]))[0])[None]
    return out


@pytest.mark.parametrize("n_parts", PARTS)
def test_partitioned_dirac_matches_jax(n_parts, ranks):
    """The ranks' rows of ``Di v``, ``DiA f`` and both VJPs, put together,
    against JAX's partitioned functions in ``shard_map`` (and the halos
    the ranks measured against JAX's)."""
    res = ranks(f"dirac{n_parts}")
    inp = ranks.inputs[f"dirac{n_parts}"]
    ref = _jax_dirac(inp, n_parts)
    for key in ("vf", "fv", "v_bar", "f_bar"):
        assert_close(_cat(res, key), ref[key], RTOL, f"{n_parts} ranks: {key}")
    c = jgeo.DiracCoeffs(**{k: inp[k] for k in COEFF_FIELDS}, n_vertices=int(inp["n_vertices"]),
                         n_faces=int(inp["n_faces"]))
    jop = jdp.partition_dirac(c, n_parts, int(inp["N"]), int(inp["M"]))
    assert all((int(r["halo_v"]), int(r["halo_f"])) == (jop.halo_v, jop.halo_f) for r in res)


@pytest.mark.parametrize("n_parts", PARTS)
def test_partitioned_gat_attend_matches_jax_and_single_device(n_parts, ranks):
    """The partitioned attend's rows and the gradients of ``xh``, the
    source and the destination scores, put together, against JAX's
    ``_gat_attend_partitioned`` inside ``shard_map`` and against the port's
    single-device ``gat_attend`` on the whole operator."""
    res = ranks(f"gat{n_parts}")
    inp = ranks.inputs[f"gat{n_parts}"]
    import scipy.sparse as sp

    L = sp.csr_matrix((inp["data"], inp["indices"], inp["indptr"]), shape=tuple(inp["shape"]))
    N, halo = int(inp["N"]), int(inp["halo"])
    got = {"out": _cat(res, "out"), **{f"{k}_bar": _cat(res, f"{k}_bar") for k in ("xh", "ss", "sd")}}
    # JAX, partitioned, in shard_map
    pop = jgp.partition_batch_operator([L], n_parts, n_rows=N, halo=halo, k=16)
    mesh = jmake_mesh(n_data=1, n_graph=n_parts, devices=jax.devices()[:n_parts])

    def local(op, xh, ss, sd):
        with jpc.sharded_axes(vertex_axis="graph", batch_axis=None):
            return jblocks.gat_attend(op, xh, ss, sd)

    row = P(None, "graph")
    with jax.enable_x64(True):
        fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(row, row, row, row), out_specs=row))
        out, vjp = jax.vjp(lambda *a: fn(pop, *a), *(jnp.asarray(inp[k]) for k in ("xh", "ss", "sd")))
        bars = vjp(jnp.asarray(inp["g"]))
    jax_ref = {"out": np.asarray(out), **{f"{k}_bar": np.asarray(b) for k, b in zip(("xh", "ss", "sd"), bars)}}
    # the port on one device
    eop = tell.stack_operators([tell.operator_from_scipy(L, k=16, n_rows=N, n_cols=N)])
    args = [torch.from_numpy(inp[k]).requires_grad_(True) for k in ("xh", "ss", "sd")]
    o = tblocks.gat_attend(eop, *args)
    o.backward(torch.from_numpy(inp["g"]))
    single = {"out": o.detach().numpy(), **{f"{k}_bar": a.grad.numpy() for k, a in zip(("xh", "ss", "sd"), args)}}
    for key in got:
        assert_close(got[key], jax_ref[key], RTOL, f"{n_parts} ranks against JAX: {key}")
        assert_close(got[key], single[key], RTOL, f"{n_parts} ranks against one device: {key}")


def _unsharded_exchange(inp: dict, n_parts: int) -> dict:
    """The exchange's frames, the gathered rows and both gradients of the
    global objective ``sum_r <out_r, g_r>``, worked out whole in NumPy."""
    x, h = inp["x"], int(inp["halo"])
    n = x.shape[1] // n_parts
    frames, x_bar_ext = [], np.zeros_like(x)
    for r in range(n_parts):
        lo, hi = r * n, (r + 1) * n
        left = x[:, lo - h:lo] if r > 0 else np.zeros_like(x[:, :h])
        right = x[:, hi:hi + h] if r < n_parts - 1 else np.zeros_like(x[:, :h])
        frames.append(np.concatenate([left, x[:, lo:hi], right], axis=1))
        g = inp[f"g_ext{r}"]
        x_bar_ext[:, lo:hi] += g[:, h:h + n]
        if r > 0:
            x_bar_ext[:, lo - h:lo] += g[:, :h]
        if r < n_parts - 1:
            x_bar_ext[:, hi:hi + h] += g[:, h + n:]
    x_bar_all = sum(inp[f"g_all{r}"] for r in range(n_parts))
    return {"frames": frames, "x_bar_ext": x_bar_ext, "x_bar_all": x_bar_all}


@pytest.mark.parametrize("what", ["halo_exchange", "gather_rows"])
@pytest.mark.parametrize("n_parts", PARTS)
def test_differentiable_exchanges_match_unsharded(n_parts, what, ranks):
    """Each rank's frame ``[from_left | x | from_right]`` (zeros at the
    chain's ends) or the gathered rows, and the gradient that reaches ``x``
    from every rank's cotangent, against the unsharded function."""
    res = ranks(f"exchange{n_parts}")
    inp = ranks.inputs[f"exchange{n_parts}"]
    ref = _unsharded_exchange(inp, n_parts)
    if what == "halo_exchange":
        for r, frame in enumerate(ref["frames"]):
            np.testing.assert_array_equal(res[r]["ext"], frame, err_msg=f"rank {r}: frame")
        assert_close(_cat(res, "x_bar_ext"), ref["x_bar_ext"], EXCHANGE_RTOL, "halo_exchange gradient")
    else:
        for r in range(n_parts):
            np.testing.assert_array_equal(res[r]["whole"], inp["x"], err_msg=f"rank {r}: gathered rows")
        assert_close(_cat(res, "x_bar_all"), ref["x_bar_all"], EXCHANGE_RTOL, "gather_rows gradient")
