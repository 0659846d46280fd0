"""The port's sparse kernels (plain versions, which the wrappers use for CPU
tensors) against the JAX package's XLA formulations and its Pallas kernels
run in interpret mode.  Tolerance: fp32 with another summation order, so
``max|err| <= 1e-5 * max|ref|``."""

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


@pytest.mark.parametrize("name", ["bsr_matmul", "ell_matmul"])
def test_wrapper_batched_cpu_is_plain_and_not_counted(name):
    """A CPU tensor takes the plain version, batched over a leading axis, and
    does not count as a kernel launch."""
    cols, vals, x = _bsr_inputs(16, batch=3) if name == "bsr_matmul" else _ell_inputs(batch=3)
    t = [torch.from_numpy(a) for a in (cols, vals, x)]
    kernels.reset_launch_counts()
    out = getattr(kernels, name)(*t)
    assert kernels.launches == {"bsr_matmul": 0, "ell_matmul": 0}
    for b in range(3):
        ref = getattr(kernels, f"{name}_plain")(t[0][b], t[1][b], t[2][b])
        assert_close(out[b].numpy(), ref.numpy(), RTOL, f"batch item {b}")


@pytest.mark.parametrize("name", ["bsr_matmul", "ell_matmul"])
def test_wrapper_refuses_other_devices(name):
    """Off the CPU the wrapper launches its kernel or raises: a meta tensor
    (neither CPU nor CUDA) raises instead of falling back."""
    cols, vals, x = _bsr_inputs(16) if name == "bsr_matmul" else _ell_inputs()
    t = [torch.from_numpy(a).to("meta") for a in (cols, vals, x)]
    with pytest.raises(ValueError, match="expected cuda"):
        getattr(kernels, name)(*t)


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
