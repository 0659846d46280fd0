"""The port's sparse kernels (plain versions, which the wrappers use for CPU
tensors) against the JAX package's XLA formulations and its Pallas kernels
run in interpret mode, and the autograd Functions' backwards against
``jax.vjp``.  Tolerance: fp32 with another summation order, so
``max|err| <= 1e-5 * max|ref|``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.sparse import bsr as jbsr
from surfacenetworks_tpu.sparse import ell as jell
from surfacenetworks_tpu.sparse import ops as jops
from surfacenetworks_tpu.sparse import pallas_kernels
from surfacenetworks_tpu_torch.sparse import ell as tell
from surfacenetworks_tpu_torch.sparse import kernels, ops

from torch_parity import assert_close, blob_laplacian, operators

RTOL = 1e-5


def _bsr_inputs(c: int, batch: int | None = None):
    rng = np.random.default_rng(10 + c)
    nb, kb, bs = 2, 2, 128
    lead = () if batch is None else (batch,)
    cols = rng.integers(0, nb, size=lead + (nb, kb)).astype(np.int32)
    vals = rng.normal(size=lead + (nb, kb, bs, bs)).astype(np.float32)
    x = rng.normal(size=lead + (nb * bs, c)).astype(np.float32)
    return cols, vals, x


def _ell_inputs(batch: int | None = None):
    rng = np.random.default_rng(3)
    R, K, N, C = 200, 7, 200, 8
    lead = () if batch is None else (batch,)
    cols = rng.integers(0, N, size=lead + (R, K)).astype(np.int32)
    vals = rng.normal(size=lead + (R, K)).astype(np.float32)
    vals[..., -2:][rng.random(size=lead + (R, 2)) < 0.5] = 0.0  # some padding slots
    cols[vals == 0] = 0
    x = rng.normal(size=lead + (N, C)).astype(np.float32)
    return cols, vals, x


@pytest.mark.parametrize("c", [16, 3])
def test_bsr_matmul_plain_matches_xla_and_pallas(c):
    cols, vals, x = _bsr_inputs(c)
    port = kernels.bsr_matmul_plain(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(x))
    args = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x))
    assert port.dtype == torch.float32 and port.shape == (2 * 128, c)
    assert_close(port.numpy(), jbsr._bsr_matmul_xla(*args), RTOL, "vs _bsr_matmul_xla")
    assert_close(port.numpy(), pallas_kernels.bsr_matmul(*args), RTOL, "vs pallas bsr_matmul")


def test_ell_matmul_plain_matches_xla_and_pallas():
    cols, vals, x = _ell_inputs()
    window = tell._ell_window(cols, vals, x.shape[0])
    assert window == jell._ell_window(cols, vals, x.shape[0])
    port = kernels.ell_matmul_plain(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(x))
    args = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x))
    assert port.shape == (200, 8)
    assert_close(port.numpy(), jops._ell_matmul_xla(*args), RTOL, "vs _ell_matmul_xla")
    assert_close(port.numpy(), pallas_kernels.ell_matmul(*args, window), RTOL, "vs pallas ell_matmul")


def _sddmm_inputs(batch: int | None = None, c: int = 12):
    """An ELL pattern with padding slots (value 0) and dense factors."""
    cols, vals, _ = _ell_inputs(batch)
    rng = np.random.default_rng(4)
    lead = cols.shape[:-2]
    a = rng.normal(size=lead + (cols.shape[-2], c)).astype(np.float32)
    b = rng.normal(size=lead + (200, c)).astype(np.float32)
    return cols, vals, a, b


def _kernel_inputs(name: str, batch: int | None = None):
    if name == "bsr_matmul":
        return _bsr_inputs(16, batch=batch)
    return _ell_inputs(batch) if name == "ell_matmul" else _sddmm_inputs(batch)


@pytest.mark.parametrize("name", ["bsr_matmul", "ell_matmul", "sddmm"])
def test_wrapper_batched_cpu_is_plain_and_not_counted(name):
    """A CPU tensor takes the plain version, batched over a leading axis, and
    does not count as a kernel launch."""
    t = [torch.from_numpy(a) for a in _kernel_inputs(name, batch=3)]
    kernels.reset_launch_counts()
    out = getattr(kernels, name)(*t)
    assert kernels.launches == {"bsr_matmul": 0, "ell_matmul": 0, "sddmm": 0, "bsr_matmul_bf16": 0,
                                "ell_matmul_bf16": 0, "sddmm_bf16": 0}
    for b in range(3):
        ref = getattr(kernels, f"{name}_plain")(*(x[b] for x in t))
        assert_close(out[b].numpy(), ref.numpy(), RTOL, f"batch item {b}")


@pytest.mark.parametrize("name", ["bsr_matmul", "ell_matmul", "sddmm"])
def test_wrapper_refuses_other_devices(name):
    """Off the CPU the wrapper launches its kernel or raises: a meta tensor
    (neither CPU nor CUDA) raises instead of falling back."""
    t = [torch.from_numpy(a).to("meta") for a in _kernel_inputs(name)]
    with pytest.raises(ValueError, match="expected cuda"):
        getattr(kernels, name)(*t)


def _sddmm_pattern(case: str):
    """A mesh Laplacian's packed pattern (R=N=256, K=16, with padding slots)
    and the channel count for ``case``: as packed (``mesh``); each row's
    slots permuted, so padding sits between live slots (``interleaved``);
    permuted and cut to K=5 or widened to K=17 by one more live slot; or
    permuted at C=3 and C=130 (the kernel's scalar path, and more than 128
    channels)."""
    _, _, L = blob_laplacian(5, 200)
    m = tell.ell_from_scipy(L, k=16, n_rows=256, n_cols=256)
    cols, vals = m.cols.numpy(), m.vals.numpy()
    c = {"c3": 3, "c130": 130}.get(case, 120)
    if case != "mesh":
        perm = np.argsort(np.random.default_rng(11).random(cols.shape), axis=1)
        cols, vals = np.take_along_axis(cols, perm, 1), np.take_along_axis(vals, perm, 1)
        live = vals != 0
        assert (~live[:, :-1] & live[:, 1:]).any()  # a live slot after a padding slot
    if case == "k5":
        cols, vals = cols[:, :5], vals[:, :5]
    elif case == "k17":  # one more live slot: the previous row's first live column
        first = np.argmax(vals != 0, axis=1)[:, None]
        extra_cols = np.roll(np.take_along_axis(cols, first, 1), 1, 0)
        extra_vals = np.roll(np.take_along_axis(vals, first, 1), 1, 0)
        cols, vals = np.concatenate([cols, extra_cols], 1), np.concatenate([vals, extra_vals], 1)
    cols, vals = np.ascontiguousarray(cols), np.ascontiguousarray(vals)
    window = m.window if case == "mesh" else tell._ell_window(cols, vals, 256)
    assert window == jell._ell_window(cols, vals, 256) and window > 0 and (vals == 0).any()
    return cols, vals, window, c


@pytest.mark.parametrize("case", ["mesh", "interleaved", "k5", "k17", "c3", "c130"])
def test_sddmm_plain_matches_xla_and_pallas(case):
    """Unbatched, on a mesh Laplacian's packed pattern (``window > 0``) with
    padding slots, at the kernel's edges (``_sddmm_pattern``): against
    ``_sddmm_xla`` and the Pallas kernel."""
    cols, vals, window, c = _sddmm_pattern(case)
    rng = np.random.default_rng(7)
    a = rng.normal(size=(256, c)).astype(np.float32)
    b = rng.normal(size=(256, c)).astype(np.float32)
    port = kernels.sddmm_plain(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(a), torch.from_numpy(b))
    assert port.shape == (256, cols.shape[1]) and port.dtype == torch.float32
    assert (port[torch.from_numpy(vals) == 0] == 0).all()
    args = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(a), jnp.asarray(b))
    assert_close(port.numpy(), jops._sddmm_xla(*args), RTOL, "vs _sddmm_xla")
    assert_close(port.numpy(), pallas_kernels.sddmm(*args, window), RTOL, "vs pallas sddmm")


def test_sddmm_plain_batched_matches_xla():
    cols, vals, a, b = _sddmm_inputs(batch=3)
    port = kernels.sddmm_plain(*(torch.from_numpy(x) for x in (cols, vals, a, b)))
    ref = jax.vmap(jops._sddmm_xla)(*(jnp.asarray(x) for x in (cols, vals, a, b)))
    assert port.shape == (3, 200, 7)
    assert (port.numpy()[vals == 0] == 0).all()
    assert_close(port.numpy(), ref, RTOL, "batched vs vmap(_sddmm_xla)")


@pytest.mark.parametrize("fmt", ["ell", "bsr", "sddmm"])
def test_operator_gradients_match_jax_vjp(fmt):
    """The autograd Functions' backwards (stored transpose for the applies,
    ELL SpMM and segment sum for the SDDMM) against ``jax.vjp`` of the JAX
    package's custom-VJP functions on the same packed operator.  The
    operator is not symmetric, so ``op.bwd`` must be its transpose."""
    from surfacenetworks_tpu import sparse as jsparse

    _, _, L = blob_laplacian(5, 200)
    L = (L + L.multiply(np.random.default_rng(8).uniform(0.5, 1.5, size=L.shape)).tocsr()).tocsr()
    jop, top = operators(L, 256, "bsr" if fmt == "bsr" else "ell", batch=2)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 256, 16)).astype(np.float32)
    if fmt == "sddmm":
        y = rng.normal(size=(2, 256, 16)).astype(np.float32)
        g = rng.normal(size=(2, 256, 16)).astype(np.float32)
        out, vjp = jax.vjp(lambda a, b: jsparse.sddmm(jop, a, b), jnp.asarray(x), jnp.asarray(y))
        ta, tb = (torch.from_numpy(v).requires_grad_() for v in (x, y))
        tout = ops.sddmm(top, ta, tb)
        tout.backward(torch.from_numpy(g))
        assert_close(tout.detach().numpy(), out, RTOL, "sddmm forward")
        ja, jb = vjp(jnp.asarray(g))
        assert_close(ta.grad.numpy(), ja, RTOL, "da")
        assert_close(tb.grad.numpy(), jb, RTOL, "db")
        return
    japply, tapply = (jsparse.bsr_spmm, ops.bsr_spmm) if fmt == "bsr" else (jsparse.spmm, ops.spmm)
    g = rng.normal(size=(2, 256, 32)).astype(np.float32)
    out, vjp = jax.vjp(lambda v: japply(jop, v), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    # the cotangent arrives non-contiguous, as a slice of the [x || Lx] concat's
    tout = tapply(top, tx)
    tout.backward(torch.from_numpy(g)[..., 16:])
    assert_close(tout.detach().numpy(), out, RTOL, f"{fmt} forward")
    assert_close(tx.grad.numpy(), vjp(jnp.asarray(g[..., 16:]))[0], RTOL, f"{fmt} x_bar")


@pytest.mark.parametrize("fmt", ["ell", "bsr", "dense"])
def test_operator_apply_matches_jax(fmt):
    """``spmm`` / ``bsr_spmm`` / ``dense_bmm`` on a batched mesh Laplacian
    against the JAX package's applies on the same packed operator."""
    from surfacenetworks_tpu.sparse import bsr_spmm as jbsr_spmm
    from surfacenetworks_tpu.sparse import dense_bmm as jdense
    from surfacenetworks_tpu.sparse import spmm as jspmm

    _, _, L = blob_laplacian(5, 200)
    jop, top = operators(L, 256, fmt, batch=2)
    x = np.random.default_rng(6).normal(size=(2, 256, 16)).astype(np.float32)
    japply = {"ell": jspmm, "bsr": jbsr_spmm, "dense": jdense}[fmt]
    tapply = {"ell": ops.spmm, "bsr": ops.bsr_spmm, "dense": ops.dense_bmm}[fmt]
    assert_close(tapply(top, torch.from_numpy(x)).numpy(), japply(jop, jnp.asarray(x)), RTOL, fmt)


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_operator_columns_checked_before_the_card(fmt):
    """The kernels skip an out-of-range column where the plain versions
    raise, so the operators check their columns on the host in ``.to`` and
    the applies check x's rows against the operator's columns."""
    _, _, L = blob_laplacian(5, 200)
    _, top = operators(L, 256, fmt)
    assert top.to("cpu").fwd.n_cols == 256  # in range: passes
    if fmt == "ell":
        top.fwd.cols[0, 7, 0] = 256
        apply, what = ops.spmm, "ELL column"
    else:
        top.fwd.block_cols[0, 1, 0] = -1
        apply, what = ops.bsr_spmm, "BSR block-column"
    with pytest.raises(ValueError, match=what):
        top.to("cpu")
    with pytest.raises(ValueError, match="rows"):
        apply(top, torch.zeros(1, 128, 4))


def _index_add_db(cols, w, a, n):
    """The SDDMM's ``db`` as the port computed it before, by ``index_add_``:
    ``out[j] = sum over (r, k) with cols[r,k] == j of w[r,k] a[r]``."""
    B, R, K = cols.shape
    contrib = (w[..., None] * a[:, :, None, :]).reshape(B * R * K, -1)
    rows = (cols.long() + n * torch.arange(B)[:, None, None]).reshape(-1)
    return torch.zeros(B * n, a.shape[-1], dtype=a.dtype).index_add_(0, rows, contrib).reshape(B, n, -1)


def _map_pattern(case: str):
    """ELL patterns for the transpose slot map: ragged (R=200 rows over
    N=150 columns, not multiples of 128), batched (3 different patterns),
    padded (a packed mesh Laplacian in a 256-row bucket)."""
    rng = np.random.default_rng(21)
    if case == "padded":
        _, _, L = blob_laplacian(5, 200)
        op = tell.operator_from_scipy(L, k=16, n_rows=256, n_cols=256)
        return op.fwd.cols.numpy()[None], op.fwd.vals.numpy()[None], 256
    B = 3 if case == "batched" else 1
    R, K, N = 200, 7, 150
    cols = rng.integers(0, N, size=(B, R, K)).astype(np.int32)
    vals = rng.normal(size=(B, R, K)).astype(np.float32)
    vals[..., -3:][rng.random(size=(B, R, 3)) < 0.6] = 0.0  # padding slots
    cols[vals == 0] = 0
    return cols, vals, N


@pytest.mark.parametrize("case", ["ragged", "batched", "padded"])
def test_transpose_slot_map(case):
    """``transpose_slot_map``: each column's live slots in ascending slot
    order, ``t_cols`` their rows, padding at slot R*K, K_t the largest
    column count; padding slots (value 0, column 0) are not listed."""
    cols, vals, N = _map_pattern(case)
    for c, v in zip(cols, vals):
        R, K = c.shape
        t_slots, t_cols = tell.transpose_slot_map(c, v, N)
        live = v.reshape(-1) != 0
        counts = np.bincount(c.reshape(-1)[live], minlength=N)
        assert t_slots.shape == (N, max(counts.max(), 1)) and t_slots.dtype == np.int32
        for j in range(N):
            want = np.flatnonzero(live & (c.reshape(-1) == j))
            got = t_slots[j]
            np.testing.assert_array_equal(got[: want.size], want)
            assert (got[want.size :] == R * K).all() and (t_cols[j, want.size :] == 0).all()
            np.testing.assert_array_equal(t_cols[j, : want.size], want // K)


@pytest.mark.parametrize("case", ["ragged", "batched", "padded"])
def test_sddmm_db_through_transpose_map(case):
    """The SDDMM's ``db``, now ``ell_matmul`` over the transpose slot map,
    equals the former ``index_add_`` segment sum and ``jax.vjp`` of the JAX
    package's ``sparse.sddmm`` (``jax.ops.segment_sum``); ``da`` too."""
    from surfacenetworks_tpu import sparse as jsparse

    cols, vals, N = _map_pattern(case)
    B, R, K = cols.shape
    rng = np.random.default_rng(22)
    a = rng.normal(size=(B, R, 12)).astype(np.float32)
    b = rng.normal(size=(B, N, 12)).astype(np.float32)
    g = rng.normal(size=(B, R, K)).astype(np.float32)
    top = tell.EllOperator(fwd=tell.EllMatrix(torch.from_numpy(cols), torch.from_numpy(vals), N),
                           bwd=tell.EllMatrix(torch.from_numpy(cols), torch.from_numpy(vals), N))
    ta, tb = (torch.from_numpy(t).requires_grad_() for t in (a, b))
    ops.sddmm(top, ta, tb).backward(torch.from_numpy(g))
    gm = torch.from_numpy(np.where(vals != 0, g, 0.0).astype(np.float32))
    old = _index_add_db(torch.from_numpy(cols), gm, torch.from_numpy(a), N)
    assert_close(tb.grad.numpy(), old.numpy(), RTOL, "db vs index_add_")
    jm = jell.EllMatrix(cols=jnp.asarray(cols), vals=jnp.asarray(vals), n_cols=N, window=0)
    _, vjp = jax.vjp(lambda p, q: jsparse.sddmm(jell.EllOperator(fwd=jm, bwd=jm), p, q),
                     jnp.asarray(a), jnp.asarray(b))
    ja, jb = vjp(jnp.asarray(g))
    assert_close(tb.grad.numpy(), jb, RTOL, "db vs jax.vjp")
    assert_close(ta.grad.numpy(), ja, RTOL, "da vs jax.vjp")


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped bits'
    unit, then clear them."""
    return ((v.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _tensor_core_bsr_row(A: torch.Tensor, x: torch.Tensor, passes: int) -> torch.Tensor:
    """``bsr_spmm_kernel``'s arithmetic for one block-row: per depth step of
    8 (one ``mma.sync`` m16n8k8), the TF32 products summed exactly and added
    to the fp32 accumulator.  ``passes=3`` is 3xTF32 (``A_lo x_hi``,
    ``A_hi x_lo``, ``A_hi x_hi``), split as the kernel splits: the high part
    and the rest each rounded to nearest; ``passes=1`` one TF32 product."""
    a_hi, x_hi = _tf32(A), _tf32(x)
    a_lo, x_lo = _tf32(A - a_hi), _tf32(x - x_hi)
    terms = [(a_lo, x_hi), (a_hi, x_lo), (a_hi, x_hi)] if passes == 3 else [(a_hi, x_hi)]
    acc = torch.zeros(A.shape[0], x.shape[1], dtype=torch.float32)
    for k0 in range(0, A.shape[1], 8):
        for a, b in terms:
            acc = (acc.double() + a[:, k0 : k0 + 8].double() @ b[k0 : k0 + 8].double()).float()
    return acc


@pytest.mark.parametrize("passes", [3, 1])
def test_3xtf32_meets_the_fp32_contract(passes):
    """The BSR kernel's accuracy argument: at one block-row of 5 dense
    128x128 blocks (128 x 640) against x [640, 64], 3xTF32 keeps every
    element within 1e-5 of ``|A||x|`` of the fp64 product, as
    ``chip_smoke.py`` requires of the kernel; one TF32 pass does not."""
    rng = np.random.default_rng(23)
    A = torch.from_numpy(rng.normal(size=(128, 640)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(640, 64)).astype(np.float32))
    ref, scale = A.double() @ x.double(), A.double().abs() @ x.double().abs()
    worst = float(((_tensor_core_bsr_row(A, x, passes).double() - ref).abs() / (RTOL * scale)).max())
    if passes == 3:
        assert worst <= 0.1, f"3xTF32 reaches {worst:.3f} of the limit"
    else:
        assert worst > 1.0, f"one TF32 pass stays within the limit ({worst:.3f})"
    assert torch.equal(_tf32(torch.tensor([1.0 + 2**-11, -(1.0 + 2**-11), 1.0 + 2**-12])),
                       torch.tensor([1.0 + 2**-10, -(1.0 + 2**-10), 1.0]))
