"""Mixed precision (bf16) in the port against the JAX package at
``dtype=jnp.bfloat16``: the bf16 variants of the three kernels (their plain
versions, which the wrappers use for CPU tensors) against the XLA paths the
JAX trainers run and the Pallas kernels in interpret mode; the autograd
Functions' backwards against ``jax.vjp``; the dtype repairs of the dense and
Dirac applies; ``GraphConv1x1`` and each block family against flax with
weights from ``convert.py``.  Inputs are seeded numpy arrays; a bf16 input
is made by JAX's rounding and handed to the port as its exact fp32 value.

Tolerances, stated per check:

* kernels with an fp32 result: every element within ``KERNEL_RTOL`` = 1e-5
  of its ``|A||x|`` (the sum of its terms' sizes): the products are exact
  on both sides (bf16 by bf16, or fp32 by a widened bf16), only fp32 sums
  in another order differ;
* a bf16 result: within one bf16 ulp of the reference plus the same 1e-5
  (the two fp32 sums differ by their rounding, so the final rounding to
  bf16 may land on the neighbouring value);
* against the Pallas bodies, which differ from the XLA paths under bf16:
  ``bsr_matmul`` keeps x in fp32, so rounding x to bf16 moves each product
  by at most 2^-8 of it (``2^-8 |A||x|``); ``ell_matmul`` writes bf16, one
  ulp;
* the SDDMM backward: JAX rounds each product to bf16 (2^-8 of it) and its
  segment sum adds in bf16 (at most 2^-8 of the terms' sizes per addition),
  where the port's products are exact and its sums fp32;
* layers and blocks: relative Frobenius errors of the output and of the
  whole gradient (every parameter's and the input's), with bounds set below
  from bf16's unit roundoff 2^-8 and the measurements they leave room for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu import sparse as jsparse
from surfacenetworks_tpu.nn import blocks as jblocks
from surfacenetworks_tpu.nn import layers as jlayers
from surfacenetworks_tpu.sparse import bsr as jbsr
from surfacenetworks_tpu.sparse import ops as jops
from surfacenetworks_tpu.sparse import pallas_kernels
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.nn import blocks as tblocks
from surfacenetworks_tpu_torch.nn import layers as tlayers
from surfacenetworks_tpu_torch.sparse import bsr as tbsr
from surfacenetworks_tpu_torch.sparse import ell as tell
from surfacenetworks_tpu_torch.sparse import kernels, ops

from torch_parity import (assert_within, bf16_ulp, blob_laplacian, dirac_operators, f64, fp32_sums, null_leaves,
                          operators, perturbed_params, rcm, rel_fro, to_jax)

BF = jnp.bfloat16
U = 2.0**-8  # bf16's unit roundoff: a rounding moves a value by at most this share of it
KERNEL_RTOL = 1e-5


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 by JAX (to nearest even), as its exact fp32 value."""
    return np.asarray(jnp.asarray(a, BF).astype(jnp.float32))


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """A port tensor of ``a`` (exact: ``a`` holds bf16 values where ``dtype`` is bf16)."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _bsr_inputs(c: int, batch: int | None = None, seed: int = 0):
    rng = np.random.default_rng(seed + c)
    nb, kb, bs = 2, 2, 128
    lead = () if batch is None else (batch,)
    cols = rng.integers(0, nb, size=lead + (nb, kb)).astype(np.int32)
    vals = _bf16(rng.normal(size=lead + (nb, kb, bs, bs)))
    x = rng.normal(size=lead + (nb * bs, c)).astype(np.float32)
    return cols, vals, x


def _ell_inputs(batch: int | None = None, c: int = 16):
    rng = np.random.default_rng(3)
    R, K, N = 200, 7, 200
    lead = () if batch is None else (batch,)
    cols = rng.integers(0, N, size=lead + (R, K)).astype(np.int32)
    vals = rng.normal(size=lead + (R, K)).astype(np.float32)
    vals[..., -2:][rng.random(size=lead + (R, 2)) < 0.5] = 0.0  # some padding slots
    cols[vals == 0] = 0
    x = _bf16(rng.normal(size=lead + (N, c)))
    return cols, vals, x


# ---------------------------------------------------------------------------
# kernels: plain bf16 versions against the XLA paths and the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("c", [16, 3])
def test_bsr_bf16_plain_matches_xla_and_pallas(c, x_dtype):
    """bf16 blocks: x (fp32 or bf16) rounded to bf16, exact products, fp32
    sums and result, as ``_bsr_matmul_xla``; against the Pallas kernel,
    which keeps x in fp32, within ``2^-8 |A||x|``."""
    cols, vals, x = _bsr_inputs(c)
    if x_dtype == "bf16":
        x = _bf16(x)
    tx = _t(x, torch.bfloat16 if x_dtype == "bf16" else torch.float32)
    port = kernels.bsr_matmul_plain(torch.from_numpy(cols), _t(vals, torch.bfloat16), tx)
    assert port.dtype == torch.float32 and port.shape == (256, c)
    jx = jnp.asarray(x, BF) if x_dtype == "bf16" else jnp.asarray(x)
    args = (jnp.asarray(cols), jnp.asarray(vals, BF), jx)
    xla = jbsr._bsr_matmul_xla(*args)
    assert xla.dtype == jnp.float32
    scale = f64(kernels.bsr_matmul_plain(torch.from_numpy(cols), _t(np.abs(vals)).double(),
                                         torch.from_numpy(np.abs(_bf16(x))).double()))
    assert_within(f64(port), xla, KERNEL_RTOL * scale, "vs _bsr_matmul_xla")
    scale_x = f64(kernels.bsr_matmul_plain(torch.from_numpy(cols), _t(np.abs(vals)).double(),
                                           torch.from_numpy(np.abs(x)).double()))
    assert_within(f64(port), pallas_kernels.bsr_matmul(*args), (U + KERNEL_RTOL) * scale_x, "vs pallas bsr_matmul")


def test_bsr_bf16_plain_rounds_x_to_nearest_even():
    """The plain version rounds fp32 x to bf16 to nearest even, as XLA's
    convert does: truncating x instead reads above the bound."""
    cols, vals, x = _bsr_inputs(16, seed=5)
    tc, tv = torch.from_numpy(cols), _t(vals, torch.bfloat16)
    port = kernels.bsr_matmul_plain(tc, tv, _t(x))
    truncated = (torch.from_numpy(x).view(torch.int32) & -65536).view(torch.float32)
    np.testing.assert_array_equal(f64(port), f64(kernels.bsr_matmul_plain(tc, tv, _t(_bf16(x)))))
    scale = f64(kernels.bsr_matmul_plain(tc, tv.abs().double(), torch.from_numpy(np.abs(_bf16(x))).double()))
    with pytest.raises(AssertionError, match="of its bound"):
        assert_within(f64(kernels.bsr_matmul_plain(tc, tv, truncated)), f64(port), KERNEL_RTOL * scale, "truncated")


def test_ell_bf16_plain_matches_xla_and_pallas():
    """fp32 values on bf16 x promote to fp32 (``_ell_matmul_xla``); the
    Pallas kernel writes bf16: one ulp."""
    cols, vals, x = _ell_inputs()
    window = tell._ell_window(cols, vals, x.shape[0])
    port = kernels.ell_matmul_plain(torch.from_numpy(cols), torch.from_numpy(vals), _t(x, torch.bfloat16))
    assert port.dtype == torch.float32
    args = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x, BF))
    xla = jops._ell_matmul_xla(*args)
    assert xla.dtype == jnp.float32
    scale = f64(kernels.ell_matmul_plain(torch.from_numpy(cols), torch.from_numpy(np.abs(vals)).double(),
                                         torch.from_numpy(np.abs(x)).double()))
    assert_within(f64(port), xla, KERNEL_RTOL * scale, "vs _ell_matmul_xla")
    pallas = pallas_kernels.ell_matmul(*args, window)
    assert pallas.dtype == BF
    assert_within(f64(port), pallas, bf16_ulp(pallas) + KERNEL_RTOL * scale, "vs pallas ell_matmul (bf16 out)")


def test_ell_bf16_plain_batched_matches_vmap_xla():
    cols, vals, x = _ell_inputs(batch=3)
    port = kernels.ell_matmul_plain(torch.from_numpy(cols), torch.from_numpy(vals), _t(x, torch.bfloat16))
    ref = jax.vmap(jops._ell_matmul_xla)(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x, BF))
    scale = f64(kernels.ell_matmul_plain(torch.from_numpy(cols), torch.from_numpy(np.abs(vals)).double(),
                                         torch.from_numpy(np.abs(x)).double()))
    assert port.shape == (3, 200, 16) and port.dtype == torch.float32
    assert_within(f64(port), ref, KERNEL_RTOL * scale, "batched vs vmap(_ell_matmul_xla)")


@pytest.mark.parametrize("c", [120, 3, 130])
def test_sddmm_bf16_plain_matches_xla_and_pallas(c):
    """bf16 a and b: fp32 sums rounded once to bf16 (``_sddmm_xla``), on a
    mesh Laplacian's packed pattern with padding slots; one ulp, against
    XLA and against the Pallas kernel."""
    _, _, L = blob_laplacian(5, 200)
    m = tell.ell_from_scipy(L, k=16, n_rows=256, n_cols=256)
    cols, vals = m.cols.numpy(), m.vals.numpy()
    rng = np.random.default_rng(7)
    a, b = _bf16(rng.normal(size=(256, c))), _bf16(rng.normal(size=(256, c)))
    port = kernels.sddmm_plain(torch.from_numpy(cols), torch.from_numpy(vals), _t(a, torch.bfloat16),
                               _t(b, torch.bfloat16))
    assert port.dtype == torch.bfloat16 and port.shape == (256, 16)
    assert (port[torch.from_numpy(vals) == 0] == 0).all()
    args = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(a, BF), jnp.asarray(b, BF))
    scale = f64(kernels.sddmm_plain(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(np.abs(a)).double(),
                                    torch.from_numpy(np.abs(b)).double()))
    for what, ref in {"_sddmm_xla": jops._sddmm_xla(*args), "pallas sddmm": pallas_kernels.sddmm(*args, m.window)}.items():
        assert ref.dtype == BF
        assert_within(f64(port), ref, bf16_ulp(ref) + KERNEL_RTOL * scale, f"vs {what}")


def test_sddmm_bf16_plain_batched_matches_vmap_xla():
    cols, vals, _ = _ell_inputs(batch=3)
    rng = np.random.default_rng(4)
    a, b = _bf16(rng.normal(size=(3, 200, 24))), _bf16(rng.normal(size=(3, 200, 24)))
    port = kernels.sddmm_plain(torch.from_numpy(cols), torch.from_numpy(vals), _t(a, torch.bfloat16),
                               _t(b, torch.bfloat16))
    ref = jax.vmap(jops._sddmm_xla)(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(a, BF), jnp.asarray(b, BF))
    scale = f64(kernels.sddmm_plain(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(np.abs(a)).double(),
                                    torch.from_numpy(np.abs(b)).double()))
    assert port.dtype == torch.bfloat16 and (f64(port)[vals == 0] == 0).all()
    assert_within(f64(port), ref, bf16_ulp(ref) + KERNEL_RTOL * scale, "batched vs vmap(_sddmm_xla)")


@pytest.mark.parametrize("name", ["bsr_matmul", "ell_matmul", "sddmm"])
def test_bf16_wrapper_on_cpu_is_plain_and_not_counted(name):
    """A CPU tensor in bf16 takes the plain version and counts no launch."""
    if name == "bsr_matmul":
        cols, vals, x = _bsr_inputs(8)
        args = (torch.from_numpy(cols), _t(vals, torch.bfloat16), _t(x))
    elif name == "ell_matmul":
        cols, vals, x = _ell_inputs()
        args = (torch.from_numpy(cols), torch.from_numpy(vals), _t(x, torch.bfloat16))
    else:
        cols, vals, x = _ell_inputs()
        args = (torch.from_numpy(cols), torch.from_numpy(vals), _t(x, torch.bfloat16), _t(x[::-1], torch.bfloat16))
    kernels.reset_launch_counts()
    out = getattr(kernels, name)(*args)
    assert all(v == 0 for v in kernels.launches.values()) and set(kernels.launches) == {
        "bsr_matmul", "ell_matmul", "sddmm", "bsr_matmul_bf16", "ell_matmul_bf16", "sddmm_bf16"}
    assert torch.equal(out, getattr(kernels, f"{name}_plain")(*args))


@pytest.mark.parametrize("case", ["bsr fp32 blocks, bf16 x", "bsr bf16 blocks, fp64 x", "ell bf16 vals",
                                  "sddmm bf16 a, fp32 b"])
def test_bf16_wrapper_refuses_unsupported_dtypes_off_the_cpu(case, monkeypatch):
    """Off the CPU an unsupported dtype raises before any launch (the
    device check is bypassed: this machine has no card)."""
    monkeypatch.setattr(kernels, "_check_cuda", lambda *a, **k: None)
    meta = torch.device("meta")
    if case.startswith("bsr"):
        vals_dt, x_dt = (torch.float32, torch.bfloat16) if "fp32 blocks" in case else (torch.bfloat16, torch.float64)
        args = (torch.zeros(2, 2, dtype=torch.int32, device=meta), torch.zeros(2, 2, 128, 128, dtype=vals_dt, device=meta),
                torch.zeros(256, 8, dtype=x_dt, device=meta))
        fn = kernels.bsr_matmul
    elif case.startswith("ell"):
        args = (torch.zeros(4, 3, dtype=torch.int32, device=meta), torch.zeros(4, 3, dtype=torch.bfloat16, device=meta),
                torch.zeros(4, 8, dtype=torch.bfloat16, device=meta))
        fn = kernels.ell_matmul
    else:
        args = (torch.zeros(4, 3, dtype=torch.int32, device=meta), torch.zeros(4, 3, device=meta),
                torch.zeros(4, 8, dtype=torch.bfloat16, device=meta), torch.zeros(4, 8, device=meta))
        fn = kernels.sddmm
    with pytest.raises(TypeError, match="the kernels take"):
        fn(*args)


# ---------------------------------------------------------------------------
# autograd Functions under bf16 against jax.vjp
# ---------------------------------------------------------------------------


def _asym_operator(fmt: str, op_dtype=None):
    _, _, L = blob_laplacian(5, 200)
    L = (L + L.multiply(np.random.default_rng(8).uniform(0.5, 1.5, size=L.shape)).tocsr()).tocsr()
    if fmt == "bsr":
        j = jsparse.stack_bsr_operators([jsparse.bsr_operator_from_scipy(L, n_rows=256, n_cols=256, dtype=BF)] * 2)
        t = tbsr.stack_bsr_operators([tbsr.bsr_operator_from_scipy(L, n_rows=256, n_cols=256, dtype=torch.bfloat16)] * 2)
        return jax.tree_util.tree_map(jnp.asarray, j), t, L
    jop, top = operators(L, 256, fmt, batch=2)
    return jop, top, L


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_apply_backward_under_bf16_matches_jax_vjp(fmt):
    """bf16 x: the forward is fp32, the backward the stored transpose on the
    fp32 cotangent (BSR: rounded to bf16 as it is read), cast to bf16, as
    the JAX package's custom VJPs give it."""
    jop, top, L = _asym_operator(fmt)
    rng = np.random.default_rng(9)
    x = _bf16(rng.normal(size=(2, 256, 16)))
    g = rng.normal(size=(2, 256, 32)).astype(np.float32)
    japply, tapply = (jsparse.bsr_spmm, ops.bsr_spmm) if fmt == "bsr" else (jsparse.spmm, ops.spmm)
    out, vjp = jax.vjp(lambda v: japply(jop, v), jnp.asarray(x, BF))
    (jx_bar,) = vjp(jnp.asarray(g[..., 16:]))
    tx = _t(x, torch.bfloat16).requires_grad_()
    tout = tapply(top, tx)
    tout.backward(torch.from_numpy(g)[..., 16:])  # a slice, as from the [x || Lx] concat
    assert tout.dtype == torch.float32 and out.dtype == jnp.float32
    assert tx.grad.dtype == torch.bfloat16 and jx_bar.dtype == BF
    absL = abs(L).toarray()
    Lp = np.zeros((256, 256))
    Lp[:200, :200] = absL
    xg = np.abs(_bf16(g[..., 16:])) if fmt == "bsr" else np.abs(g[..., 16:])
    assert_within(f64(tout), out, KERNEL_RTOL * (Lp @ np.abs(x)), f"{fmt} forward")
    assert_within(f64(tx.grad), jx_bar, bf16_ulp(jx_bar) + KERNEL_RTOL * (Lp.T @ xg), f"{fmt} x_bar")


def test_sddmm_backward_under_bf16_matches_jax_vjp():
    """bf16 a, b: a bf16 forward (one ulp), and bf16 ``da``, ``db``.  JAX
    rounds each of the backward's products to bf16 (``da``: 2^-8 of the
    terms' sizes, plus the rounding of each side's result: 2 ulp) and adds
    ``db``'s in bf16 in its segment sum (one more 2^-8 of the terms' sizes
    per addition: the column's count of live slots)."""
    jop, top, L = _asym_operator("ell")
    rng = np.random.default_rng(10)
    a, b = _bf16(rng.normal(size=(2, 256, 16))), _bf16(rng.normal(size=(2, 256, 16)))
    g = _bf16(rng.normal(size=(2, 256, 16)))
    out, vjp = jax.vjp(lambda u, v: jsparse.sddmm(jop, u, v), jnp.asarray(a, BF), jnp.asarray(b, BF))
    ja, jb = vjp(jnp.asarray(g, BF))
    ta, tb = (_t(v, torch.bfloat16).requires_grad_() for v in (a, b))
    tout = ops.sddmm(top, ta, tb)
    tout.backward(_t(g, torch.bfloat16))
    assert tout.dtype == torch.bfloat16 and out.dtype == BF
    assert ta.grad.dtype == tb.grad.dtype == torch.bfloat16 and ja.dtype == jb.dtype == BF
    cols, vals = top.fwd.cols, top.fwd.vals
    gm = np.where(vals.numpy() != 0, np.abs(g), 0.0)
    fwd_scale = f64(kernels.sddmm_plain(cols, vals, torch.from_numpy(np.abs(a)).double(), torch.from_numpy(np.abs(b)).double()))
    assert_within(f64(tout), out, bf16_ulp(out) + KERNEL_RTOL * fwd_scale, "sddmm forward")
    da_terms = f64(kernels.ell_matmul_plain(cols, torch.from_numpy(gm), torch.from_numpy(np.abs(b)).double()))
    assert_within(f64(ta.grad), ja, 2 * bf16_ulp(ja) + U * da_terms, "da")
    live = vals.numpy() != 0
    count = np.stack([np.bincount(cols.numpy()[i][live[i]], minlength=256) for i in range(2)])[..., None]
    db_terms = np.stack([np.stack([np.bincount(cols.numpy()[i].ravel(), weights=(gm[i][..., None] * np.abs(a[i])[:, None, :])
                                               [..., ch].ravel(), minlength=256) for ch in range(16)], -1)
                         for i in range(2)])
    assert_within(f64(tb.grad), jb, 2 * bf16_ulp(jb) + (count + 1) * U * db_terms, "db")


# ---------------------------------------------------------------------------
# the dtype repairs: dense and Dirac applies promote as JAX does
# ---------------------------------------------------------------------------


def test_dense_bmm_promotes_fp32_operator_on_bf16_x():
    """An fp32 dense operator on bf16 x gives fp32, as ``jnp.einsum``
    promotes (the ARAP ``--dense`` and mesh-MNIST dense path); plain
    ``torch.matmul`` of the two dtypes raises."""
    _, _, L = blob_laplacian(2, 100)
    jop, top = operators(L, 104, "dense", batch=2)
    x = _bf16(np.random.default_rng(1).normal(size=(2, 104, 8)))
    got = ops.dense_bmm(top, _t(x, torch.bfloat16))
    ref = jops.dense_bmm(jop, jnp.asarray(x, BF))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    scale = np.abs(np.asarray(jop, np.float64)) @ np.abs(x)
    assert_within(f64(got), ref, KERNEL_RTOL * scale, "dense_bmm")
    xg = _t(x, torch.bfloat16).requires_grad_()
    ops.dense_bmm(top, xg).sum().backward()
    assert xg.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("side", ["vf", "fv"])
def test_dirac_apply_promotes_on_bf16_x(side):
    """The structured Dirac applies on bf16 x: fp32 tables times bf16 x
    promote to fp32, as ``_dirac_gather_apply``'s products do; the backward
    is cast to bf16.  (Rounding the tables to x's dtype gave bf16.)"""
    jop, top, _ = dirac_operators()
    n = top.n_vertices if side == "vf" else top.n_faces
    rng = np.random.default_rng(3)
    x = _bf16(rng.normal(size=(2, n, 16)))
    japply = jsparse.dirac_apply_vf if side == "vf" else jsparse.dirac_apply_fv
    tapply = ops.dirac_apply_vf if side == "vf" else ops.dirac_apply_fv
    out, vjp = jax.vjp(lambda v: japply(jop, v), jnp.asarray(x, BF))
    tx = _t(x, torch.bfloat16).requires_grad_()
    tout = tapply(top, tx)
    assert out.dtype == jnp.float32 and tout.dtype == torch.float32
    g = rng.normal(size=tout.shape).astype(np.float32)
    tout.backward(torch.from_numpy(g))
    (jx_bar,) = vjp(jnp.asarray(g))
    assert tx.grad.dtype == torch.bfloat16 and jx_bar.dtype == BF
    # exact products summed in fp32 (forward); the backward rounded to bf16 once
    assert rel_fro(f64(tout), out) <= 1e-6, rel_fro(f64(tout), out)
    assert rel_fro(f64(tx.grad), jx_bar) <= U, rel_fro(f64(tx.grad), jx_bar)


def test_dense_dirac_pair_promotes_on_bf16_x():
    """A dense (Di, DiA) pair in fp32 on bf16 x gives fp32, as the JAX
    package's dense Dirac apply promotes (rounding the matrix to x's dtype
    gave bf16)."""
    from surfacenetworks_tpu_torch.data import datasets
    from surfacenetworks_tpu_torch.data.batching import dense_dirac_pair

    _, top, _ = dirac_operators()
    samples = datasets.synthetic_normal_dataset(2, 60, seed=2, operator="dirac")  # dirac_operators' samples
    pair = dense_dirac_pair(samples, top.n_vertices, top.n_faces)
    x = _bf16(np.random.default_rng(4).normal(size=(2, top.n_vertices, 16)))
    got = tblocks.apply_dirac_vf(pair, _t(x, torch.bfloat16))
    ref = tblocks.apply_dirac_vf(top, _t(x))
    assert got.dtype == torch.float32
    assert rel_fro(f64(got), f64(ref)) <= 1e-5, rel_fro(f64(got), f64(ref))


# ---------------------------------------------------------------------------
# GraphConv1x1 and the blocks against flax at dtype=bf16
# ---------------------------------------------------------------------------

# GraphConv1x1: the same roundings at the same places (input and weight to
# bf16, the bf16 product, the bf16 bias add), fp32 sums in another order, so
# a few elements land on a neighbouring bf16 value (one ulp, at most 2^-7 of
# it): the output within 2^-8 relative (Frobenius); each gradient (JAX's
# sums in fp32, ``fp32_sums``) within 2^-6.
LAYER_OUT_RTOL = U
LAYER_GRAD_RTOL = 4 * U
# Blocks: two layers, a batch norm between (it divides by statistics that
# carry those flips) and the operator apply: the output within 2^-6; each
# gradient within 2^-4.  Measured: every output bit for bit, each gradient
# of a layer at most 0.005U, of a block at most 4.0U (a batch norm's bias).
BLOCK_OUT_RTOL = 4 * U
BLOCK_GRAD_RTOL = 16 * U


def _inputs(shape, seed=0, n_valid=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    mask = np.ones(shape[:-1] + (1,), np.float32)
    if n_valid is not None:
        mask[:, n_valid:] = 0.0
        x[:, n_valid:] = 0.0
    return x, mask


def _leaf_errors(tmod, jgrads, inputs: list, jin_grads: list) -> dict:
    """Relative Frobenius error of each gradient: every parameter's (flax
    layout converted to ``state_dict``) and each input's; one that is zero
    in exact arithmetic (``null_leaves``) relative to the largest parameter
    gradient instead of its own."""
    jg = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), like=tmod)
    top = max(float(np.linalg.norm(f64(v))) for v in jg.values())
    null = null_leaves(tmod)
    errs = {}
    for k, p in tmod.named_parameters():
        assert p.grad.dtype == torch.float32 and p.dtype == torch.float32, k
        got, ref = f64(p.grad), f64(jg[k])
        errs[k] = float(np.linalg.norm(got - ref)) / top if k in null else rel_fro(got, ref)
    for i, (t, g) in enumerate(zip(inputs, jin_grads)):
        assert t.grad.dtype == t.dtype, (i, t.grad.dtype)
        errs[f"input {i}"] = rel_fro(f64(t.grad), np.asarray(g, np.float64))
    return errs


def _hold(jmod, tmod, jargs, targs, grad_args: tuple, cot: np.ndarray, seed: int, out_rtol: float,
          grad_rtol: float, what: str):
    """Flax ``jmod`` (dtype bf16; its sums in fp32, ``fp32_sums``) and the
    port's ``tmod`` with the same perturbed parameters on the same inputs:
    the output (in JAX's dtype) within ``out_rtol``; the VJP of the
    cotangent ``cot`` (fp32), each parameter's gradient and each gradient of
    the inputs at ``grad_args``, one at a time, within ``grad_rtol``.  A
    zeroed gradient (relative error 1) must not pass."""
    params = perturbed_params(jmod.init(jax.random.key(0), *jargs)["params"], seed)
    tmod.load_state_dict(params_from_flax(params, like=tmod), strict=True)

    def f(p, *xs):
        a = list(jargs)
        for i, x in zip(grad_args, xs):
            a[i] = x
        return jmod.apply({"params": p}, *a)

    with fp32_sums():
        out, vjp = jax.vjp(f, to_jax(params), *(jargs[i] for i in grad_args))
        out_v = out[0] if isinstance(out, tuple) else out
        jg = vjp((jnp.asarray(cot, out_v.dtype),) + tuple(jnp.zeros_like(o) for o in out[1:])
                 if isinstance(out, tuple) else jnp.asarray(cot, out_v.dtype))
    ta = list(targs)
    for i in grad_args:
        ta[i] = ta[i].detach().clone().requires_grad_()
    tout = tmod(*ta)
    tout_v = tout[0] if isinstance(tout, tuple) else tout
    assert str(tout_v.dtype).split(".")[-1] == str(out_v.dtype), (what, tout_v.dtype, out_v.dtype)
    e_out = rel_fro(f64(tout_v), out_v)
    tout_v.backward(torch.from_numpy(cot).to(tout_v.dtype))
    inputs = [ta[i] for i in grad_args]
    errs = _leaf_errors(tmod, jg[0], inputs, jg[1:])
    assert e_out <= out_rtol, f"{what}: output rel_fro {e_out:.3e} > {out_rtol:.3e}"
    worst = max(errs, key=errs.get)
    assert errs[worst] <= grad_rtol, f"{what}: gradient of {worst} rel_fro {errs[worst]:.3e} > {grad_rtol:.3e}"
    # planted: the largest parameter gradient zeroed, and an input's, as a detached path leaves them
    name, p = max(tmod.named_parameters(), key=lambda kv: float(kv[1].grad.norm()))
    p.grad.zero_()
    inputs[0].grad.zero_()
    planted = _leaf_errors(tmod, jg[0], inputs, jg[1:])
    assert planted[name] > grad_rtol and planted["input 0"] > grad_rtol, (what, planted[name], planted["input 0"])
    return e_out, errs


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bn", ["pre", "post", None])
def test_graph_conv1x1_bf16_matches_flax(bn, x_dtype):
    """``GraphConv1x1(dtype=bf16)`` as flax's ``nn.Dense(dtype=bf16)``
    behind or before a batch norm, on fp32 or bf16 input: the output is
    bf16 (two roundings: the product, then the bias add)."""
    x, mask = _inputs((2, 64, 12), seed=2, n_valid=50)
    if x_dtype == "bf16":
        x = _bf16(x)
    jx = jnp.asarray(x, BF if x_dtype == "bf16" else jnp.float32)
    tx = _t(x, torch.bfloat16 if x_dtype == "bf16" else torch.float32)
    cot = np.random.default_rng(5).normal(size=(2, 64, 10)).astype(np.float32)
    _hold(jlayers.GraphConv1x1(12, 10, bn, dtype=BF), tlayers.GraphConv1x1(12, 10, bn, dtype=torch.bfloat16),
          (jx, jnp.asarray(mask)), (tx, torch.from_numpy(mask)), (0,), cot, 3, LAYER_OUT_RTOL, LAYER_GRAD_RTOL,
          f"GraphConv1x1 {bn} {x_dtype}")


def test_graph_conv1x1_bf16_rounds_product_and_bias_apart():
    """The bias is added to the rounded bf16 product and rounded again, as
    flax does; a fused ``F.linear`` (one rounding) differs from it."""
    x = _bf16(np.random.default_rng(6).normal(size=(1, 512, 32)))
    layer = tlayers.GraphConv1x1(32, 16, None, dtype=torch.bfloat16)
    with torch.no_grad():
        layer.fc.bias.uniform_(-3.0, 3.0, generator=torch.Generator().manual_seed(0))
    got = layer(_t(x, torch.bfloat16))
    w, b = layer.fc.weight.bfloat16(), layer.fc.bias.bfloat16()
    two = (_t(x, torch.bfloat16) @ w.t()) + b
    assert got.dtype == torch.bfloat16 and torch.equal(got, two)
    fused = torch.nn.functional.linear(_t(x, torch.bfloat16), w, b)
    assert not torch.equal(got, fused)


def _block_case(name: str):
    """(flax block, port block, flax args, port args, index of the input,
    output shape) for a block family on a 150-vertex mesh padded to 256
    rows, batch 2, bf16 input."""
    x, mask = _inputs((2, 256, 16), seed=11, n_valid=150)
    x = _bf16(x)
    jx, tx, jm, tm = jnp.asarray(x, BF), _t(x, torch.bfloat16), jnp.asarray(mask), torch.from_numpy(mask)
    if name == "dir":
        jop, top, _ = dirac_operators()
        rng = np.random.default_rng(12)
        v = _bf16(rng.normal(size=(2, top.n_vertices, 16)))
        f = _bf16(rng.normal(size=(2, top.n_faces, 16)))
        return (jblocks.DirResNet2(16, dtype=BF), tblocks.DirResNet2(16, dtype=torch.bfloat16),
                (jop, jnp.asarray(v, BF), jnp.asarray(f, BF)), (top, _t(v, torch.bfloat16), _t(f, torch.bfloat16)),
                (1, 2), (2, top.n_vertices, 16))
    if name == "mlp":
        return (jblocks.MlpResNet2(16, dtype=BF), tblocks.MlpResNet2(16, dtype=torch.bfloat16), (None, jm, jx),
                (None, tm, tx), (2,), (2, 256, 16))
    if name == "avg":
        return (jblocks.AvgResNet2(16, dtype=BF), tblocks.AvgResNet2(16, dtype=torch.bfloat16), (None, jm, jx),
                (None, tm, tx), (2,), (2, 256, 16))
    fmt = name.split("-")[1]
    _, _, L = blob_laplacian(3, 150)
    L = rcm(L)
    if fmt == "bsr":
        j = jsparse.stack_bsr_operators([jsparse.bsr_operator_from_scipy(L, n_rows=256, n_cols=256, dtype=BF)] * 2)
        jop = jax.tree_util.tree_map(jnp.asarray, j)
        top = tbsr.stack_bsr_operators([tbsr.bsr_operator_from_scipy(L, n_rows=256, n_cols=256,
                                                                      dtype=torch.bfloat16)] * 2)
    else:
        jop, top = operators(L, 256, fmt, batch=2)
    wide = name.startswith("widelap")
    jb = jblocks.WideLapResNet2(16, 32, dtype=BF) if wide else jblocks.LapResNet2(16, dtype=BF)
    tb = tblocks.WideLapResNet2(16, 32, dtype=torch.bfloat16) if wide else tblocks.LapResNet2(16, dtype=torch.bfloat16)
    return jb, tb, (jop, jm, jx), (top, tm, tx), (2,), (2, 256, 32 if wide else 16)


@pytest.mark.parametrize("name", ["lap-ell", "lap-bsr", "lap-dense", "widelap-ell", "avg", "mlp", "dir"])
def test_block_bf16_matches_flax(name):
    """Each block family at ``dtype=bf16`` against flax's: the operator
    result stays fp32 into the 'pre' batch norm; output and gradients
    within the block bounds."""
    jb, tb, jargs, targs, grad_args, shape = _block_case(name)
    cot = np.random.default_rng(13).normal(size=shape).astype(np.float32)
    _hold(jb, tb, jargs, targs, grad_args, cot, 21, BLOCK_OUT_RTOL, BLOCK_GRAD_RTOL, f"block {name}")
