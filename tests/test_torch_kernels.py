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
    assert kernels.launches == {"bsr_matmul": 0, "ell_matmul": 0, "sddmm": 0}
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


def test_sddmm_plain_matches_xla_and_pallas():
    """Unbatched, on a mesh Laplacian's packed pattern (``window > 0``), and
    with padding slots: against ``_sddmm_xla`` and the Pallas kernel."""
    _, _, L = blob_laplacian(5, 200)
    m = tell.ell_from_scipy(L, k=16, n_rows=256, n_cols=256)
    assert m.window > 0 and (m.vals == 0).any()
    rng = np.random.default_rng(7)
    a = rng.normal(size=(256, 120)).astype(np.float32)
    b = rng.normal(size=(256, 120)).astype(np.float32)
    port = kernels.sddmm_plain(m.cols, m.vals, torch.from_numpy(a), torch.from_numpy(b))
    assert port.shape == (256, 16) and port.dtype == torch.float32
    assert (port[m.vals == 0] == 0).all()
    args = (jnp.asarray(m.cols.numpy()), jnp.asarray(m.vals.numpy()), jnp.asarray(a), jnp.asarray(b))
    assert_close(port.numpy(), jops._sddmm_xla(*args), RTOL, "vs _sddmm_xla")
    assert_close(port.numpy(), pallas_kernels.sddmm(*args, m.window), RTOL, "vs pallas sddmm")


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
