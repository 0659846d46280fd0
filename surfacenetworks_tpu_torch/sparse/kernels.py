"""Sparse operator kernels (counterpart of ``surfacenetworks_tpu/sparse/pallas_kernels.py``).

Each kernel has three parts here: the wrapper the model calls, its plain
PyTorch version, and a launch count.  A tensor on the CPU takes the plain
version; a CUDA tensor launches the hand-written kernel in ``csrc/spmm.cu``
(built by ``_build.py``) or raises.  Every kernel takes an optional leading
batch axis, so one launch serves a whole batch of operators.  The wrappers
are not differentiable: ``sparse/ops.py`` wraps them in autograd Functions.

``bsr_matmul`` replaces ``_bsr_matmul_call`` (``pallas_kernels.py:133-178``).
  Bound on the H100: bytes.  At NB=55, KB=5, C=128 it reads 18 MB of stored
  128x128 blocks and 3.6 MB of x and writes 3.6 MB: about 0.0075 ms at
  3.35 TB/s.  Its ``2*NB*KB*128*128*C`` flops (1.15 GFLOP) run on the
  tensor cores in three TF32 passes, 0.007 ms at 495 TFLOP/s; in fp32 FMA
  (67 TFLOP/s) they would bound it at 0.017 ms.  Accuracy: the TPU kernel
  lets the MXU round its inputs to bf16; the port holds fp32, every element
  within 1e-5 of ``|A||x|``, which one TF32 pass (about 5e-4 per product)
  does not meet.  So each operand is split into a TF32 high part and a TF32
  low part (the rest), each rounded to nearest, and three products are
  summed (3xTF32: about 2^-21 per product).  Design: one CTA of 4 warps per
  (64-channel tile, half block-row, batch item), 220 CTAs at C=128;
  ``mma.sync`` m16n8k8 TF32 with fp32 accumulators in registers; each
  slot's block and slice of x stream through a 3-stage ring in shared
  memory by ``cp.async`` in depth chunks of 32, the next chunks (and slots)
  loading while the current one multiplies.

``ell_matmul`` replaces ``_ell_matmul_call`` (``pallas_kernels.py:186-274``).
  Bound on the H100: bytes.  At R=N=7040, K=16, C=128 it moves about 8 MB
  (slots once, x once, out once) for about 13 MFLOP; but each row of x is
  gathered by every row that references it (about 7), so the L2 cache
  serves several times x's bytes, a round trip per gather.  Design: one
  warp per output row with 16-byte lanes along the channel axis, so each
  gathered row is one coalesced read.  Each lane reads the row's (col, val)
  pairs with vector loads, then issues all gathers of a chunk of 8 slots,
  predicated on live slots, before any FMA: a warp keeps up to 8 gathers in
  flight, at 64 registers or fewer so that 32 warps fit on an SM.  The FMAs
  run in slot order, a fixed order of summation, which the deterministic
  sums of the training backward rely on.  The TPU kernel's banded densify
  (``window``) was a matrix-unit device; on this card the gather is the
  contract (``sparse/ops.py:44-47`` in the JAX package), so ``window`` is
  accepted and ignored, and R need not be a multiple of 128.

``sddmm`` replaces ``_sddmm_call`` (``pallas_kernels.py:277-352``).
  Bound on the H100: bytes.  At R=N=7040, K=16, C=120 it reads a and b
  (3.4 MB each) and the pattern (0.9 MB) once and writes 0.45 MB, about
  8.1 MB (0.0024 ms), for about 12 MFLOP; where a and b are one tensor, as
  in the smoothness term, 4.7 MB (0.0014 ms).  Design: as ``ell_matmul``
  read the other way round, one warp per row with 16-byte lanes along the
  channel axis.  A ballot over the row's slots gives its live ones in slot
  order, wherever the padding sits, so dead slots cost nothing.  They are
  taken in chunks of 4: all of a chunk's gathers of b[col] are issued
  before any product, and one transposing reduction (6 shuffles, where a
  butterfly per slot takes 20) leaves each slot's dot in a fixed lane, from
  which the row's K outputs leave in one coalesced store.  One fixed order
  of summation, no atomics: two launches agree bit for bit.  48 registers,
  so 40 warps fit on an SM.  Measured by ``chip_smoke.py`` on an NVIDIA
  H100 80GB HBM3 at 700.00 W: 0.00728 ms warm, 0.01229 ms with a cold L2
  cache.  The TPU kernel's one MXU product per 128-row tile against a densified
  ``window`` band, with the K slots picked out by compare-selects, was
  matrix-unit machinery; ``window`` is ignored here.
"""

from __future__ import annotations

import ctypes

import torch

from surfacenetworks_tpu_torch.sparse import _build

# Launches of each CUDA kernel since the last reset (plain-version calls on
# CPU tensors do not count).
launches = {"bsr_matmul": 0, "ell_matmul": 0, "sddmm": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _batched(*ts: torch.Tensor) -> tuple[bool, list[torch.Tensor]]:
    """Add a batch axis of 1 to unbatched operands."""
    if ts[0].dim() == 2:
        return False, [t.unsqueeze(0) for t in ts]
    return True, list(ts)


def _check_cuda(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on different devices {devices}")


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {code}")


# ---------------------------------------------------------------------------
# block-ELL SpMM
# ---------------------------------------------------------------------------


def bsr_matmul_plain(block_cols: torch.Tensor, block_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[i*bs:(i+1)*bs] = sum_k block_vals[i,k] @ x[block_cols[i,k]*bs : +bs]``.

    ``block_cols [..., NB, KB]``, ``block_vals [..., NB, KB, bs, bs]``,
    ``x [..., N, C]`` -> ``[..., NB*bs, C]`` accumulated in fp32
    (``_bsr_matmul_xla``), or in fp64 for an fp64 reference run.
    """
    batched, (cols, vals, xb) = _batched(block_cols, block_vals, x)
    bs = vals.shape[-1]
    B, n, c = xb.shape
    blocks = xb.reshape(B, n // bs, bs, c)
    gathered = blocks[torch.arange(B, device=xb.device)[:, None, None], cols.long()]
    acc = torch.promote_types(torch.promote_types(vals.dtype, xb.dtype), torch.float32)
    out = torch.einsum("bnkij,bnkjc->bnic", vals.to(acc), gathered.to(acc)).reshape(B, -1, c)
    return out if batched else out[0]


def bsr_matmul(block_cols: torch.Tensor, block_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMM over 128x128 blocks; fp32 in and out on the card.

    Block-columns must lie in ``[0, N/128)``.  ``BsrMatrix.to`` checks that
    on the host and ``bsr_spmm`` checks N, so the port's path never hands
    the kernel another.  Called directly with one, the two versions differ:
    the plain version raises, the kernel skips the slot rather than read out
    of bounds (checking here would cost a device sync per launch)."""
    if x.device.type == "cpu":
        return bsr_matmul_plain(block_cols, block_vals, x)
    _check_cuda("bsr_matmul", block_cols=block_cols, block_vals=block_vals, x=x)
    if block_cols.dtype != torch.int32:
        raise TypeError(f"bsr_matmul: block_cols must be int32, got {block_cols.dtype}")
    if block_vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"bsr_matmul: the kernel takes fp32 blocks and x, got {block_vals.dtype} and {x.dtype}"
        )
    batched, (cols, vals, xb) = _batched(block_cols, block_vals, x)
    B, nb, kb = cols.shape
    if vals.shape != (B, nb, kb, 128, 128):
        raise ValueError(f"bsr_matmul: block_vals {tuple(vals.shape)} is not [{B},{nb},{kb},128,128]")
    if xb.dim() != 3 or xb.shape[0] != B or xb.shape[1] % 128:
        raise ValueError(f"bsr_matmul: x {tuple(xb.shape)} is not [{B}, 128*m, C]")
    if vals.data_ptr() % 16:
        raise ValueError("bsr_matmul: block_vals must be 16-byte aligned")
    n, c = xb.shape[1:]
    out = torch.empty((B, nb * 128, c), device=x.device, dtype=torch.float32)
    vec4 = c % 4 == 0 and xb.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.snx_bsr_spmm(
        cols.data_ptr(), vals.data_ptr(), xb.data_ptr(), out.data_ptr(),
        B, nb, kb, n, c, int(vec4), ctypes.c_void_p(stream),
    )
    _raise_on(code, "bsr_matmul")
    launches["bsr_matmul"] += 1
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# scalar-ELL SpMM
# ---------------------------------------------------------------------------


def ell_matmul_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_k vals[r,k] * x[cols[r,k]]``; ``cols [..., R, K]``,
    ``x [..., N, C]`` -> ``[..., R, C]`` (``_ell_matmul_xla``)."""
    batched, (c_, v_, xb) = _batched(cols, vals, x)
    B = xb.shape[0]
    gathered = xb[torch.arange(B, device=xb.device)[:, None, None], c_.long()]  # [B, R, K, C]
    out = (v_[..., None] * gathered).sum(dim=-2)
    return out if batched else out[0]


def ell_matmul(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Scalar-ELL SpMM.  ``window`` (the TPU kernel's banded bound) is
    accepted and ignored: the CUDA kernel gathers rows directly.  Columns
    must lie in ``[0, N)``; ``EllMatrix.to`` and ``spmm`` see to that on the
    port's path.  Called directly with another, the plain version raises and
    the kernel skips the slot rather than read out of bounds."""
    del window
    if x.device.type == "cpu":
        return ell_matmul_plain(cols, vals, x)
    _check_cuda("ell_matmul", cols=cols, vals=vals, x=x)
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_matmul: cols must be int32, got {cols.dtype}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"ell_matmul: the kernel takes fp32 vals and x, got {vals.dtype} and {x.dtype}")
    batched, (c_, v_, xb) = _batched(cols, vals, x)
    B, R, K = c_.shape
    if v_.shape != c_.shape:
        raise ValueError(f"ell_matmul: vals {tuple(v_.shape)} != cols {tuple(c_.shape)}")
    if xb.dim() != 3 or xb.shape[0] != B:
        raise ValueError(f"ell_matmul: x {tuple(xb.shape)} is not [{B}, N, C]")
    n, c = xb.shape[1:]
    out = torch.empty((B, R, c), device=x.device, dtype=torch.float32)
    vec4 = c % 4 == 0 and xb.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    pairs4 = K % 4 == 0 and c_.data_ptr() % 16 == 0 and v_.data_ptr() % 16 == 0
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.snx_ell_spmm(
        c_.data_ptr(), v_.data_ptr(), xb.data_ptr(), out.data_ptr(),
        B, R, K, n, c, int(vec4), int(pairs4), ctypes.c_void_p(stream),
    )
    _raise_on(code, "ell_matmul")
    launches["ell_matmul"] += 1
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# SDDMM at an ELL pattern
# ---------------------------------------------------------------------------


def sddmm_plain(cols: torch.Tensor, vals: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[r,k] = <a[r], b[cols[r,k]]>`` where ``vals[r,k] != 0``, else 0;
    ``cols [..., R, K]``, ``a [..., R, C]``, ``b [..., N, C]`` ->
    ``[..., R, K]`` (``_sddmm_xla``)."""
    batched, (c_, v_, ab, bb) = _batched(cols, vals, a, b)
    B = bb.shape[0]
    gathered = bb[torch.arange(B, device=bb.device)[:, None, None], c_.long()]  # [B, R, K, C]
    out = torch.einsum("brc,brkc->brk", ab, gathered)
    out = torch.where(v_ != 0, out, torch.zeros_like(out))
    return out if batched else out[0]


def sddmm(cols: torch.Tensor, vals: torch.Tensor, a: torch.Tensor, b: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Sampled dense-dense product at an ELL pattern; fp32 in and out on the
    card.  ``window`` is accepted and ignored, as in ``ell_matmul``.  Columns
    must lie in ``[0, N)`` (``EllMatrix.to`` checks); called directly with
    another, the plain version raises and the kernel writes 0 there."""
    del window
    if b.device.type == "cpu":
        return sddmm_plain(cols, vals, a, b)
    _check_cuda("sddmm", cols=cols, vals=vals, a=a, b=b)
    if cols.dtype != torch.int32:
        raise TypeError(f"sddmm: cols must be int32, got {cols.dtype}")
    if vals.dtype != torch.float32 or a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"sddmm: the kernel takes fp32 vals, a and b, got {vals.dtype}, {a.dtype}, {b.dtype}")
    batched, (c_, v_, ab, bb) = _batched(cols, vals, a, b)
    B, R, K = c_.shape
    if v_.shape != c_.shape:
        raise ValueError(f"sddmm: vals {tuple(v_.shape)} != cols {tuple(c_.shape)}")
    if bb.dim() != 3 or bb.shape[0] != B or ab.shape[:2] != (B, R) or ab.shape[2] != bb.shape[2]:
        raise ValueError(f"sddmm: a {tuple(ab.shape)} and b {tuple(bb.shape)} do not fit cols [{B}, {R}, {K}]")
    n, c = bb.shape[1:]
    out = torch.empty((B, R, K), device=b.device, dtype=torch.float32)
    vec4 = c % 4 == 0 and ab.data_ptr() % 16 == 0 and bb.data_ptr() % 16 == 0
    lib = _build.load()
    stream = torch.cuda.current_stream(b.device).cuda_stream
    code = lib.snx_sddmm(
        c_.data_ptr(), v_.data_ptr(), ab.data_ptr(), bb.data_ptr(), out.data_ptr(),
        B, R, K, n, c, int(vec4), ctypes.c_void_p(stream),
    )
    _raise_on(code, "sddmm")
    launches["sddmm"] += 1
    return out if batched else out[0]
