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
  accepted and ignored, and R need not be a multiple of 128.  A batch of
  stacked operators is one launch, a warp per row of every item: at the
  ARAP trainer's batch (32 operators of 2,000 rows, K=16, C=128, 73.7 MB,
  0.0220 ms at 3.35 TB/s) ``chip_smoke.py`` measured 0.0498 ms warm and
  0.0532 ms with a cold L2 cache on an NVIDIA H100 80GB HBM3 at 700.00 W.

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

Each kernel also has a bf16 variant, for mixed-precision training
(``--bf16``).  It computes what the JAX package's XLA path computes under
bf16, which is the path its trainers run (they never select Pallas):

* ``bsr_matmul`` with bf16 blocks (``_bsr_matmul_xla``): x (fp32 or bf16)
  rounded to bf16 to nearest even, bf16 products summed in fp32, fp32 out.
  ``mma.sync`` m16n8k16 bf16, one pass where fp32 takes three.  Bound:
  bytes; with the live-chunk mask, the live chunks, the x slices they read
  and out, 11.0 MB at NB=55, KB=5, C=128 on bf16 x (0.00328 ms); without
  it every stored byte, 14.4 MB (0.0043 ms).  Design: one CTA of 4 warps
  per 64-row half block-row and 64 channels (220 CTAs), a 6-stage
  ``cp.async`` ring of 32-deep chunks of both operands, x in its own
  row-major layout in shared memory read by ``ldmatrix.trans`` (fp32 x
  staged as fp32 and rounded as the fragments are built), and the chunks
  that hold only zeros skipped through the operator's live-chunk mask
  (``live=``, ``bsr.live_chunks``: 38% of a mesh Laplacian's stored
  chunks).  Chunks are taken in slot order, so the bits are those of
  reading every chunk.  Measured by ``bsr_bf16_sweep.py`` on an NVIDIA
  H100 80GB HBM3 at 700.00 W: 0.0102 ms on bf16 x (32% of its bound),
  0.0126-0.0128 ms on fp32 x (the backward's cotangents), 0.0144-0.0146
  ms cold.
* ``ell_matmul`` on bf16 x (``_ell_matmul_xla``): fp32 values times bf16 x
  promote to fp32, fp32 sums and out.  A 16-byte lane carries 8 bf16
  channels and a warp holds 32 / lanes_per_row rows (a row's lanes rounded
  up to a power of two: 2 rows at C=128, 4 at C=64), so a warp's gathers
  fill it as the fp32 kernel's do; slots are added in the fp32 kernel's
  fixed order.  Measured as above: 0.0062 ms at 7,040 x 16 x 128 (the fp32
  kernel 0.0070), 0.0356 ms at the ARAP batch, 0.0062 ms at the mesh-MNIST
  batch.
* ``sddmm`` of bf16 a and b (``_sddmm_xla``): fp32 sums, one rounding to
  bf16 at the store, bf16 out; the ballot-compacted design of the fp32
  kernel.

Their plain versions widen the bf16 inputs to fp32 (exact), compute in
fp32 and round to bf16 only where the XLA path's output is bf16.  Plain
``torch.matmul`` on bf16 tensors rounds its output to bf16, which is not
that contract.  The Pallas bodies differ from the XLA paths under bf16
(``bsr_matmul`` keeps x in fp32, ``ell_matmul`` writes ``x.dtype``); the
port follows the XLA paths.  Launches are counted per variant
(``launches["bsr_matmul_bf16"]`` and so on).
"""

from __future__ import annotations

import ctypes

import torch

from surfacenetworks_tpu_torch.sparse import _build

# Launches of each CUDA kernel variant since the last reset (plain-version
# calls on CPU tensors do not count).
KERNELS = ("bsr_matmul", "ell_matmul", "sddmm")
launches = {name + suffix: 0 for suffix in ("", "_bf16") for name in KERNELS}


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
    (``_bsr_matmul_xla``), or in fp64 for an fp64 reference run.  With bf16
    blocks, x is first rounded to bf16 (to nearest even); both are then
    widened to fp32, exactly, so each product is exact and the result fp32.
    """
    batched, (cols, vals, xb) = _batched(block_cols, block_vals, x)
    bs = vals.shape[-1]
    B, n, c = xb.shape
    blocks = xb.reshape(B, n // bs, bs, c)
    gathered = blocks[torch.arange(B, device=xb.device)[:, None, None], cols.long()]
    if vals.dtype == torch.bfloat16:  # x rounded to the blocks' bf16, as _bsr_matmul_xla does
        gathered = gathered.to(torch.bfloat16)
    acc = torch.promote_types(torch.promote_types(vals.dtype, gathered.dtype), torch.float32)
    out = torch.einsum("bnkij,bnkjc->bnic", vals.to(acc), gathered.to(acc)).reshape(B, -1, c)
    return out if batched else out[0]


def bsr_matmul(block_cols: torch.Tensor, block_vals: torch.Tensor, x: torch.Tensor,
               live: torch.Tensor | None = None) -> torch.Tensor:
    """Block-ELL SpMM over 128x128 blocks, fp32 out on the card: fp32 blocks
    and x, or bf16 blocks and fp32 or bf16 x (the bf16 variant).

    ``live`` (uint8 ``[..., NB, KB]``, ``bsr.live_chunks`` of the same
    blocks) lets the bf16 kernel skip the 64-row x 32-deep chunks of the
    stored blocks that hold only zeros; without it every chunk is read.  A
    skipped chunk would add exact zeros, so a true mask changes no finite
    result; a mask that clears a chunk holding a nonzero drops that chunk's
    terms.  The fp32 kernel and the plain version read every chunk.

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
    bf16 = block_vals.dtype == torch.bfloat16 and x.dtype in (torch.float32, torch.bfloat16)
    if not (bf16 or block_vals.dtype == x.dtype == torch.float32):
        raise TypeError(
            f"bsr_matmul: the kernels take fp32 blocks and x, or bf16 blocks and fp32 or bf16 x; got "
            f"{block_vals.dtype} and {x.dtype}"
        )
    batched, (cols, vals, xb) = _batched(block_cols, block_vals, x)
    B, nb, kb = cols.shape
    if vals.shape != (B, nb, kb, 128, 128):
        raise ValueError(f"bsr_matmul: block_vals {tuple(vals.shape)} is not [{B},{nb},{kb},128,128]")
    if xb.dim() != 3 or xb.shape[0] != B or xb.shape[1] % 128:
        raise ValueError(f"bsr_matmul: x {tuple(xb.shape)} is not [{B}, 128*m, C]")
    if vals.data_ptr() % 16:
        raise ValueError("bsr_matmul: block_vals must be 16-byte aligned")
    if live is not None:
        _check_cuda("bsr_matmul", block_cols=block_cols, live=live)
        if live.dtype != torch.uint8 or live.shape != block_cols.shape:
            raise ValueError(f"bsr_matmul: live must be uint8 {tuple(block_cols.shape)}, got {live.dtype} "
                             f"{tuple(live.shape)}")
    n, c = xb.shape[1:]
    out = torch.empty((B, nb * 128, c), device=x.device, dtype=torch.float32)
    x_bf16 = xb.dtype == torch.bfloat16
    vec = c % (8 if x_bf16 and bf16 else 4) == 0 and xb.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    if bf16:
        name = "bsr_matmul_bf16"
        code = lib.snx_bsr_spmm_bf16(cols.data_ptr(), vals.data_ptr(), None if live is None else live.data_ptr(),
                                     xb.data_ptr(), out.data_ptr(), B, nb, kb, n, c, int(x_bf16), int(vec), stream)
    else:
        name = "bsr_matmul"
        code = lib.snx_bsr_spmm(cols.data_ptr(), vals.data_ptr(), xb.data_ptr(), out.data_ptr(), B, nb, kb, n, c,
                                int(vec), stream)
    _raise_on(code, name)
    launches[name] += 1
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# scalar-ELL SpMM
# ---------------------------------------------------------------------------


def ell_matmul_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_k vals[r,k] * x[cols[r,k]]``; ``cols [..., R, K]``,
    ``x [..., N, C]`` -> ``[..., R, C]`` (``_ell_matmul_xla``).  fp32 values
    on bf16 x promote to fp32 (the widening is exact): fp32 sums and out."""
    batched, (c_, v_, xb) = _batched(cols, vals, x)
    B = xb.shape[0]
    gathered = xb[torch.arange(B, device=xb.device)[:, None, None], c_.long()]  # [B, R, K, C]
    out = (v_[..., None] * gathered).sum(dim=-2)
    return out if batched else out[0]


def ell_matmul(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Scalar-ELL SpMM, fp32 out on the card: fp32 values on fp32 x, or on
    bf16 x (the bf16 variant).  ``window`` (the TPU kernel's banded bound) is
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
    if vals.dtype != torch.float32 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ell_matmul: the kernels take fp32 vals on fp32 or bf16 x, got {vals.dtype} and {x.dtype}")
    batched, (c_, v_, xb) = _batched(cols, vals, x)
    B, R, K = c_.shape
    if v_.shape != c_.shape:
        raise ValueError(f"ell_matmul: vals {tuple(v_.shape)} != cols {tuple(c_.shape)}")
    if xb.dim() != 3 or xb.shape[0] != B:
        raise ValueError(f"ell_matmul: x {tuple(xb.shape)} is not [{B}, N, C]")
    n, c = xb.shape[1:]
    out = torch.empty((B, R, c), device=x.device, dtype=torch.float32)
    bf16 = xb.dtype == torch.bfloat16
    vec = c % (8 if bf16 else 4) == 0 and xb.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    pairs4 = K % 4 == 0 and c_.data_ptr() % 16 == 0 and v_.data_ptr() % 16 == 0
    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    name = "ell_matmul_bf16" if bf16 else "ell_matmul"
    launch = lib.snx_ell_spmm_bf16x if bf16 else lib.snx_ell_spmm
    code = launch(c_.data_ptr(), v_.data_ptr(), xb.data_ptr(), out.data_ptr(), B, R, K, n, c, int(vec), int(pairs4),
                  stream)
    _raise_on(code, name)
    launches[name] += 1
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# SDDMM at an ELL pattern
# ---------------------------------------------------------------------------


def sddmm_plain(cols: torch.Tensor, vals: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[r,k] = <a[r], b[cols[r,k]]>`` where ``vals[r,k] != 0``, else 0;
    ``cols [..., R, K]``, ``a [..., R, C]``, ``b [..., N, C]`` ->
    ``[..., R, K]`` in ``a``'s dtype (``_sddmm_xla``).  bf16 a and b are
    widened to fp32, the dots summed in fp32 and rounded to bf16 once."""
    batched, (c_, v_, ab, bb) = _batched(cols, vals, a, b)
    B = bb.shape[0]
    gathered = bb[torch.arange(B, device=bb.device)[:, None, None], c_.long()]  # [B, R, K, C]
    acc = torch.promote_types(torch.promote_types(ab.dtype, bb.dtype), torch.float32)
    out = torch.einsum("brc,brkc->brk", ab.to(acc), gathered.to(acc))
    out = torch.where(v_ != 0, out, torch.zeros_like(out)).to(ab.dtype)
    return out if batched else out[0]


def sddmm(cols: torch.Tensor, vals: torch.Tensor, a: torch.Tensor, b: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Sampled dense-dense product at an ELL pattern: fp32 a and b to fp32
    on the card, or bf16 a and b to bf16 (the bf16 variant), at fp32 pattern
    values.  ``window`` is accepted and ignored, as in ``ell_matmul``.  Columns
    must lie in ``[0, N)`` (``EllMatrix.to`` checks); called directly with
    another, the plain version raises and the kernel writes 0 there."""
    del window
    if b.device.type == "cpu":
        return sddmm_plain(cols, vals, a, b)
    _check_cuda("sddmm", cols=cols, vals=vals, a=a, b=b)
    if cols.dtype != torch.int32:
        raise TypeError(f"sddmm: cols must be int32, got {cols.dtype}")
    if vals.dtype != torch.float32 or a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sddmm: the kernels take fp32 vals and fp32 or bf16 a and b of one dtype, got "
                        f"{vals.dtype}, {a.dtype}, {b.dtype}")
    batched, (c_, v_, ab, bb) = _batched(cols, vals, a, b)
    B, R, K = c_.shape
    if v_.shape != c_.shape:
        raise ValueError(f"sddmm: vals {tuple(v_.shape)} != cols {tuple(c_.shape)}")
    if bb.dim() != 3 or bb.shape[0] != B or ab.shape[:2] != (B, R) or ab.shape[2] != bb.shape[2]:
        raise ValueError(f"sddmm: a {tuple(ab.shape)} and b {tuple(bb.shape)} do not fit cols [{B}, {R}, {K}]")
    n, c = bb.shape[1:]
    out = torch.empty((B, R, K), device=b.device, dtype=ab.dtype)
    bf16 = ab.dtype == torch.bfloat16
    vec = c % (8 if bf16 else 4) == 0 and ab.data_ptr() % 16 == 0 and bb.data_ptr() % 16 == 0
    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(b.device).cuda_stream)
    name = "sddmm_bf16" if bf16 else "sddmm"
    launch = lib.snx_sddmm_bf16 if bf16 else lib.snx_sddmm
    code = launch(c_.data_ptr(), v_.data_ptr(), ab.data_ptr(), bb.data_ptr(), out.data_ptr(), B, R, K, n, c, int(vec),
                  stream)
    _raise_on(code, name)
    launches[name] += 1
    return out if batched else out[0]
