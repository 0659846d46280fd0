"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``surfacenetworks_tpu_torch/sparse/csrc``
with one ``nvcc`` call (logging each kernel's registers and spills, and
checking in the SASS that the BSR kernel runs TF32 tensor-core products),
holds each kernel against its plain PyTorch version in fp32 and in fp64 at
the paths' shapes and more (the SDDMM also with padding between live slots,
K from 5 to 33 and C from 3 to 264, and two launches bit for bit), times
both (and each kernel again with a cold L2 cache), and holds each autograd
Function's backward against autograd through the plain versions.  Then it
drives two paths, each with the launch counts set to 0 just before it and
read just after:

* serving: LapDeepModel-15 at width 128 through ``NormalServer`` on four
  ~7,000-vertex meshes in the ELL and the BSR operator format, checked
  against each other and against an fp64 forward that uses no kernel;
* training: the FAUST siamese Lap-15 trainer (width 128, 120-d features)
  taking 8 updates with ``--smooth-reg 0.1`` on ~7,000-vertex synthetic
  scans in both formats, then its test pass; step 0's loss and gradients
  are checked against the same step in fp64 with dense operators and no
  kernel, and a trunk whose operator applies return detached outputs must
  fail that check.  Then each format runs the 8 updates and the test pass
  again from step 0's weights, optimizer state and random state, and the
  two runs' losses and test metrics must be bit-identical.

It needs a CUDA card; without one (or without the package beside it) it
exits non-zero and prints no result.  The last two lines are a JSON
``kernels`` report and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FMA
# outside the tensor cores and dense TF32 on the tensor cores, flop/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TF32_PASSES = 3  # bsr_matmul's 3xTF32: three tensor-core products per multiply-add
L2_FLUSH_BYTES = 128 << 20  # written between cold-L2 launches: over twice the 50 MB L2

BUCKET = 7040  # one 128-multiple bucket for every ~7,000-vertex request
WIDTH = 128
LAYERS = 15
APPLIES_PER_FORWARD = 16  # 8 WideLapResNet2 blocks x 2 inner steps
N_REQUESTS = 4
SEED = 0
# The kernel and operator checks hold every element of a product A x to the
# size of the terms summed into it: |got - ref| <= RTOL * (|A| |x|) + TINY.
# fp32 accumulation of the K <= 16 nonzero terms of a row errs by at most
# about K * 6e-8 of that sum, whatever the cancellation; TINY only lets an
# element whose terms are all zero be zero.
TINY = 1e-30
# Kernel vs its plain version on the same fp32 inputs.
KERNEL_RTOL = 1e-5
# Each served request's operator, applied to its inputs through the kernel
# and put back in the request's vertex order, against L x in fp64 on the
# same fp32 L and x.
PIPELINE_RTOL = 1e-5
# Served answers (fp32) against an fp64 forward of the same model on a dense
# copy of the operator (no kernel), and the two formats against each other,
# as relative Frobenius errors.  This bound is loose by necessity: L x cancels
# (|L| reaches 1e6 at sliver triangles of these meshes, L x stays O(10)), so
# fp32 rounding is amplified through 15 batch norms, whose statistics every
# row shares.  The checks above are the element-wise ones; this one holds
# the whole model and the answers' vertex order (an answer left in RCM
# order reads about 1.4, and the run asserts that it is refused).
SERVE_FRO_RTOL = 0.75
# Training: the correspondence trunk's feature width (the SDDMM's C), the
# synthetic FAUST-like data, and launches expected per step: 16 applies per
# trunk forward, two trunks, forward and stored-transpose backward (64); one
# SDDMM per smoothness term (2), whose backward runs two ELL SpMMs, da and
# db over the pattern's transpose slot map (4); and one ELL SpMM for the
# streaming dcel head's mirror over the target's inverse (1).  So ELL steps
# launch 64 + 4 + 1 = 69 ell_matmul, BSR steps 64 bsr_matmul and 5
# ell_matmul.
FEATURES = 120
TRAIN_ARGS = ["--synthetic", "4", "--synthetic-points", "7000", "--seed", "0", "--layer", str(LAYERS),
              "--smooth-reg", "0.1", "--xz-rotate", "--num-updates", "8", "--num-epoch", "1", "--device", "cuda"]
EXPECTED_PER_STEP = {
    "ell": {"bsr_matmul": 0, "ell_matmul": 69, "sddmm": 2},
    "bsr": {"bsr_matmul": 64, "ell_matmul": 5, "sddmm": 2},
}
# Step 0 on the card (fp32, kernels) against the same step in fp64 with
# dense operators and no kernel.  The whole step's loss, as a relative error,
# is loose for the reason SERVE_FRO_RTOL is, and more: the dcel head's
# softmax is near one-hot, so fp32 rounding of the features moves the loss.
# For the same reason the whole step's gradients are reported, not bounded.
# The gradients are held module by module instead: the head and each trunk
# module run in fp64 from the card's own inputs and output cotangents.  The
# chain (the head's loss and feature cotangents, each module's input
# cotangent) must agree with the card's within STEP0_CHAIN_RTOL, each
# parameter's gradient (a sum over 14,000 vertices that cancels) within
# STEP0_PARAM_RTOL, as relative Frobenius errors.  A detached apply breaks
# the chain: about 1.0.  PERF.md gives the measurements behind the bounds.
STEP0_LOSS_RTOL = 1.0
STEP0_CHAIN_RTOL = 0.2
STEP0_PARAM_RTOL = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float) -> None:
    log(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")


def time_ms(fn, reps: int = 20, per_rep: int = 10) -> float:
    """Device time of one ``fn()``: the median over ``reps`` of CUDA-event
    time of ``per_rep`` back-to-back calls, divided by ``per_rep``.  A sleep
    kernel holds the stream while the host queues the calls, so host
    overhead between launches does not enter the device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)  # ~2.5 ms at H100 clocks
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    times.sort()
    return times[len(times) // 2]


def host_us(fn, calls: int = 50) -> float:
    """Host time of one ``fn()`` call, not waiting for the device."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # keep the device busy so no call waits on it
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return dt


def bound_ms(n_bytes: int, flops: int, flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time for the work: bytes over HBM's rate or operations over
    ``flop_per_s`` (fp32 FMA unless given), whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cold_ms(fn, flush, reps: int = 15) -> float:
    """Device time of one ``fn()`` with a cold L2 cache: before each launch
    ``flush`` (``L2_FLUSH_BYTES``) is written, which evicts what the cache
    held, and the launch alone is timed by its own events.  Median over
    ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # the host queues the rest meanwhile
        flush.add_(1.0)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _np(a):
    return a.detach().double().cpu().numpy() if hasattr(a, "cpu") else np.asarray(a, dtype=np.float64)


def worst(got, ref, scale, rtol: float) -> tuple[float, float]:
    """(max |got - ref|, max over elements of |got - ref| / (rtol * scale +
    TINY)); ``scale`` is |A| |x| at each element.  Non-finite reads inf."""
    got, ref, scale = _np(got), _np(ref), _np(scale)
    err = np.abs(got - ref)
    ratio = float((err / (rtol * scale + TINY)).max()) if np.isfinite(got).all() else float("inf")
    return float(err.max()), ratio


def check(name: str, got, ref, scale, rtol: float) -> float:
    """Max-abs error of ``got`` vs ``ref``; raises unless every element is
    within its limit (see ``worst``)."""
    err, ratio = worst(got, ref, scale, rtol)
    log(f"  {name}: max_abs_err={err:.3e} max|ref|={np.abs(_np(ref)).max():.3e} "
        f"worst element {ratio:.3e} of its limit (tol {rtol:g} of |A||x|) {'ok' if ratio <= 1 else 'FAIL'}")
    if not ratio <= 1:
        raise AssertionError(f"{name}: result disagrees with its reference")
    return err


def refused(name: str, got, ref, scale, rtol: float) -> None:
    """The check's own test: a deliberately wrong result must read above its
    limit, or the run fails."""
    err, ratio = worst(got, ref, scale, rtol)
    log(f"  mutant {name}: max_abs_err={err:.3e}, worst element {ratio:.3e} of its limit "
        f"{'refused' if ratio > 1 else 'NOT refused'}")
    if not ratio > 1:
        raise AssertionError(f"mutant {name} passes the check")


def tf32_round(t):
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: what one tensor-core pass makes of an fp32 input."""
    import torch

    return ((t.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def kernel_phase(device) -> dict:
    """Hold the three kernels against their plain versions, in fp32 and in
    fp64, at the paths' shapes and at ragged, narrow, wide and batched ones;
    prove the checks refuse wrong results; time kernel, plain version and
    one library call, warm and with a cold L2 cache."""
    import torch

    from surfacenetworks_tpu_torch.data import Buckets, fit_bsr_k, laplacian_batch, rcm_reorder_sample
    from surfacenetworks_tpu_torch.data.datasets import random_blob_mesh
    from surfacenetworks_tpu_torch.geometry import igl_style_laplacian
    from surfacenetworks_tpu_torch.sparse import kernels, operator_from_scipy

    rng = np.random.default_rng(SEED + 100)
    V, F = random_blob_mesh(rng, 7000)
    sample = rcm_reorder_sample({"V": V, "F": F, "input": V.astype(np.float32),
                                 "L": igl_style_laplacian(V, F, hack=1.0)})
    buckets = Buckets(n_vertices=BUCKET)
    fit_bsr_k([sample], buckets)
    ell = laplacian_batch([sample], buckets, target_key="input", fmt="ell").operator.fwd.to(device)
    bsr = laplacian_batch([sample], buckets, target_key="input", fmt="bsr").operator.fwd.to(device)
    cols, vals = ell.cols[0], ell.vals[0]
    bcols, bvals = bsr.block_cols[0], bsr.block_vals[0]
    log(f"  operator: n={V.shape[0]} padded to {BUCKET}; ELL K={cols.shape[1]}; "
        f"BSR NB={bcols.shape[0]} KB={bcols.shape[1]}")
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"ell_matmul": 0.0, "bsr_matmul": 0.0}

    def held(kname, name, got, plain, c_, v_, *dense):
        """``got`` against ``plain`` on the same fp32 inputs and on them
        widened to fp64, each element within KERNEL_RTOL of its |A||x|."""
        ref = plain(c_, v_, *dense)
        scale = plain(c_, v_.double().abs(), *(t.double().abs() for t in dense))
        errs[kname] = max(errs[kname], check(f"{name} vs fp32 plain", got, ref, scale, KERNEL_RTOL))
        check(f"{name} vs fp64 plain", got, plain(c_, v_.double(), *(t.double() for t in dense)), scale, KERNEL_RTOL)

    def ell(name, c_, v_, x):
        held("ell_matmul", name, kernels.ell_matmul(c_, v_, x), kernels.ell_matmul_plain, c_, v_, x)

    def bsr(name, c_, v_, x, ref_cols=None, ref_vals=None):
        got = kernels.bsr_matmul(c_, v_, x)
        held("bsr_matmul", name, got, kernels.bsr_matmul_plain,
             c_ if ref_cols is None else ref_cols, v_ if ref_vals is None else ref_vals, x)

    for c in (WIDTH, FEATURES, 3):
        x = torch.randn(BUCKET, c, device=device, generator=gen)
        ell(f"ell_matmul R={BUCKET} K={cols.shape[1]} C={c}", cols, vals, x)
    for c in (WIDTH, FEATURES, 3, 136):
        x = torch.randn(BUCKET, c, device=device, generator=gen)
        bsr(f"bsr_matmul NB={bcols.shape[0]} KB={bcols.shape[1]} C={c}", bcols, bvals, x)
    # ragged ELL: the unpadded operator, R = n not a multiple of 128
    rag = operator_from_scipy(sample["L"]).fwd.to(device)
    x = torch.randn(rag.n_cols, WIDTH, device=device, generator=gen)
    ell(f"ell_matmul ragged R={rag.n_rows} K={rag.k} C={WIDTH}", rag.cols, rag.vals, x)
    # ragged K: 13 slots (the scalar pair loads), and 40 (two vector chunks and a partial one)
    x = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
    ell(f"ell_matmul ragged K=13 C={FEATURES}", cols[:, :13].contiguous(), vals[:, :13].contiguous(), x)
    c40 = torch.cat([cols, cols.roll(1, 0), cols[:, :8].roll(2, 0)], 1).contiguous()
    v40 = torch.cat([vals, vals.roll(1, 0) * 0.5, vals[:, :8].roll(2, 0) * 0.25], 1).contiguous()
    ell(f"ell_matmul ragged K=40 C={FEATURES}", c40, v40, x)
    # batched launch (B=2): the leading batch axis is one launch
    xb = torch.randn(2, BUCKET, WIDTH, device=device, generator=gen)
    ell("ell_matmul batched B=2", torch.stack([cols, cols]), torch.stack([vals, vals.flip(0)]), xb)
    bsr("bsr_matmul batched B=2", torch.stack([bcols, bcols]), torch.stack([bvals, bvals * 0.5]), xb)
    # block-columns outside [0, N/128): skipped by the kernel, held against
    # the plain version on the same slots emptied
    oob_cols, oob_vals = bcols.clone(), bvals.clone()
    n_blocks = BUCKET // 128
    for i, s, col in ((3, 0, -1), (bcols.shape[0] // 2, 1, n_blocks), (bcols.shape[0] - 1, 0, 1 << 20)):
        oob_cols[i, s] = col
        oob_vals[i, s] = 0
    ref_cols = torch.where((oob_cols < 0) | (oob_cols >= n_blocks), 0, oob_cols)
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen)
    bsr("bsr_matmul with 3 block-columns out of range", oob_cols, bvals, x, ref_cols, oob_vals)

    # the checks' power: a kernel that dropped one slot of one row must fail them
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen)
    r = BUCKET // 2
    s = int(torch.nonzero(vals[r])[0])
    dropped = vals.clone()
    dropped[r, s] = 0
    refused(f"ell_matmul without slot {s} of row {r}", kernels.ell_matmul(cols, dropped, x),
            kernels.ell_matmul_plain(cols, vals, x), kernels.ell_matmul_plain(cols, vals.abs(), x.abs()),
            KERNEL_RTOL)
    i = bcols.shape[0] // 2
    s = int(torch.nonzero(bvals[i].flatten(1).abs().sum(1))[0])
    dropped = bvals.clone()
    dropped[i, s] = 0
    bscale = kernels.bsr_matmul_plain(bcols, bvals.abs(), x.abs())
    bref = kernels.bsr_matmul_plain(bcols, bvals, x)
    refused(f"bsr_matmul without slot {s} of block-row {i}", kernels.bsr_matmul(bcols, dropped, x), bref, bscale,
            KERNEL_RTOL)
    # ... and one TF32 pass instead of three: the product of TF32-rounded inputs
    refused("bsr_matmul in one TF32 pass (inputs rounded to TF32)",
            kernels.bsr_matmul_plain(bcols, tf32_round(bvals), tf32_round(x)), bref, bscale, KERNEL_RTOL)

    # SDDMM at the smoothness term's shapes: the same fixed-k pattern, C=120
    errs["sddmm"] = 0.0

    def sdd(name, c_, v_, a, b):
        ref = kernels.sddmm_plain(c_, v_, a, b)
        scale = kernels.sddmm_plain(c_, v_, a.abs(), b.abs())  # sum_c |a_rc| |b_jc| at live slots
        errs["sddmm"] = max(errs["sddmm"], check(name, kernels.sddmm(c_, v_, a, b), ref, scale, KERNEL_RTOL))

    for c in (FEATURES, 3):
        a = torch.randn(BUCKET, c, device=device, generator=gen)
        b = torch.randn(BUCKET, c, device=device, generator=gen)
        sdd(f"sddmm R={BUCKET} K={cols.shape[1]} C={c}", cols, vals, a, b)
    fn = torch.nn.functional.normalize(a.new_empty(BUCKET, FEATURES).normal_(generator=gen), dim=-1)
    sdd(f"sddmm a=b (unit rows) C={FEATURES}", cols, vals, fn, fn)
    a = torch.randn(rag.n_rows, FEATURES, device=device, generator=gen)
    sdd(f"sddmm ragged R={rag.n_rows} K={rag.k}", rag.cols, rag.vals, a, a.flip(0))
    ab = torch.randn(2, BUCKET, FEATURES, device=device, generator=gen)
    sdd("sddmm batched B=2", torch.stack([cols, cols]), torch.stack([vals, vals.flip(0)]), ab, ab.flip(0))
    # the kernel's edges: each row's slots permuted, so padding sits between
    # live slots; K cut to 5, or widened past one chunk (17) and past one
    # group of 32 slots (33); C on the scalar path (3, 130, 257) and past 128
    # channels on the float4 path (264)
    perm = torch.argsort(torch.rand(cols.shape, device=device, generator=gen), dim=1)
    pc, pv = cols.gather(1, perm), vals.gather(1, perm)
    live = pv != 0
    log(f"  sddmm permuted pattern: {int((~live[:, :-1] & live[:, 1:]).any(1).sum())} of {BUCKET} rows have a "
        f"live slot after a padding slot")
    wide = {5: (pc[:, :5], pv[:, :5]),
            17: (torch.cat([pc, pc[:, :1].roll(1, 0)], 1), torch.cat([pv, pv[:, :1].roll(1, 0)], 1)),
            33: (torch.cat([pc, pc.roll(1, 0), pc[:, :1].roll(2, 0)], 1),
                 torch.cat([pv, pv.roll(1, 0) * 0.5, pv[:, :1].roll(2, 0)], 1))}
    wide = {kk: (c_.contiguous(), v_.contiguous()) for kk, (c_, v_) in wide.items()}
    for kk, (c_, v_) in [(cols.shape[1], (pc, pv)), *wide.items()]:
        a = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
        b = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
        sdd(f"sddmm permuted slots K={kk} C={FEATURES} (up to {int((v_ != 0).sum(1).max())} live slots a row)",
            c_, v_, a, b)
    for c in (3, 130, 257, 264):
        a = torch.randn(BUCKET, c, device=device, generator=gen)
        b = torch.randn(BUCKET, c, device=device, generator=gen)
        sdd(f"sddmm permuted slots K={cols.shape[1]} C={c}", pc, pv, a, b)
    a = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
    b = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
    for label, (c_, v_) in {"K=16": (cols, vals), "permuted K=33": wide[33]}.items():
        same = torch.equal(kernels.sddmm(c_, v_, a, b), kernels.sddmm(c_, v_, a, b))
        log(f"  sddmm {label}: two launches on the same inputs {'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"sddmm {label}: two launches on the same inputs differ")
    # the checks' power: a kernel that dropped one slot of one row must fail
    # them, and so must one that stopped after its first chunk of live slots
    r = BUCKET // 2
    s = int(torch.nonzero(vals[r])[0])
    dropped = vals.clone()
    dropped[r, s] = 0
    refused(f"sddmm without slot {s} of row {r}", kernels.sddmm(cols, dropped, a, b),
            kernels.sddmm_plain(cols, vals, a, b), kernels.sddmm_plain(cols, vals, a.abs(), b.abs()), KERNEL_RTOL)
    c33, v33 = wide[33]
    r = int((v33 != 0).sum(1).argmax())
    s = int(torch.nonzero(v33[r])[-1])
    dropped = v33.clone()
    dropped[r, s] = 0
    refused(f"sddmm permuted K=33 without the last live slot ({s}) of row {r}, which has "
            f"{int((v33[r] != 0).sum())}", kernels.sddmm(c33, dropped, a, b),
            kernels.sddmm_plain(c33, v33, a, b), kernels.sddmm_plain(c33, v33, a.abs(), b.abs()), KERNEL_RTOL)

    # timing at the serving shape (C=128)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen)
    csr = sample["L"].tocsr().astype(np.float32)
    csr.resize((BUCKET, BUCKET))
    lib_csr = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int64)), torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.data), size=csr.shape).to(device)
    csr_ms = time_ms(lambda: torch.sparse.mm(lib_csr, x))
    report = {}

    nnz = int((vals != 0).sum())
    out = torch.empty(BUCKET, WIDTH, device=device)
    log(f"  ell_matmul: {nnz} live slots, {nnz / BUCKET:.2f} per row: the gathers read "
        f"{nnz * WIDTH * 4 / 1e6:.1f} MB of x rows through the L2 cache at C={WIDTH}, x itself is "
        f"{BUCKET * WIDTH * 4 / 1e6:.1f} MB")
    b_ms, b_by = bound_ms(nbytes(cols, vals, x, out), 2 * nnz * WIDTH)
    report["ell_matmul"] = {
        "ms": time_ms(lambda: kernels.ell_matmul(cols, vals, x)),
        "cold_ms": cold_ms(lambda: kernels.ell_matmul(cols, vals, x), flush),
        "plain_ms": time_ms(lambda: kernels.ell_matmul_plain(cols, vals, x)),
        "library_ms": csr_ms,
        "library_call": "torch.sparse.mm(csr, x)",
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(cols, vals, x, out), "flops": 2 * nnz * WIDTH,
    }
    nnzb = int((bvals != 0).flatten(2).any(dim=2).sum())
    flops = 2 * nnzb * 128 * 128 * WIDTH
    # the kernel's products run on the tensor cores in three TF32 passes;
    # the fp32-FMA bound (67 TFLOP/s, outside the tensor cores) is kept beside it
    b_ms, b_by = bound_ms(nbytes(bcols, bvals, x, out), TF32_PASSES * flops, TF32_FLOP_PER_S)
    fma_ms, fma_by = bound_ms(nbytes(bcols, bvals, x, out), flops)
    lib_ms, lib_call = csr_ms, "torch.sparse.mm(csr, x)"
    try:  # the same operator in PyTorch's own BSR layout, where CUDA supports it
        lib_bsr = lib_csr.to_dense().to_sparse_bsr((128, 128))
        lib_ms, lib_call = time_ms(lambda: torch.sparse.mm(lib_bsr, x)), "torch.sparse.mm(bsr128, x)"
    except (RuntimeError, NotImplementedError) as e:
        log(f"  library BSR call unavailable ({type(e).__name__}: {str(e)[:120]}); using CSR")
    report["bsr_matmul"] = {
        "ms": time_ms(lambda: kernels.bsr_matmul(bcols, bvals, x)),
        "cold_ms": cold_ms(lambda: kernels.bsr_matmul(bcols, bvals, x), flush),
        "plain_ms": time_ms(lambda: kernels.bsr_matmul_plain(bcols, bvals, x)),
        "library_ms": lib_ms, "library_call": lib_call,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(bcols, bvals, x, out), "flops": flops,
        "fp32_fma_bound_ms": fma_ms, "fp32_fma_bound_by": fma_by,
        "nonzero_blocks": nnzb, "slots": bcols.numel(),
    }
    # how much of the stored blocks is zero in each CTA's 64-row x 32-deep chunk
    sub = (bvals != 0).reshape(bvals.shape[0], bvals.shape[1], 2, 64, 4, 32).any(dim=5).any(dim=3)
    log(f"  bsr_matmul: {float(sub.float().mean()):.3f} of the stored blocks' 64x32 chunks hold a nonzero "
        f"(the rest multiply zeros); {nnzb} of {bcols.numel()} stored blocks do")
    log(f"  bsr_matmul bound: {b_ms:.5f} ms by {b_by} (3 TF32 passes at 495 TFLOP/s: "
        f"{TF32_PASSES * flops / TF32_FLOP_PER_S * 1e3:.5f} ms; bytes at 3.35 TB/s: "
        f"{nbytes(bcols, bvals, x, out) / HBM_BYTES_PER_S * 1e3:.5f} ms); the fp32-FMA bound "
        f"(67 TFLOP/s) reads {fma_ms:.5f} ms by {fma_by}")
    # SDDMM timing at the smoothness term's shape (C=120)
    live = vals != 0
    nnz = int(live.sum())
    sd_out = torch.empty(BUCKET, cols.shape[1], device=device)
    b_ms, b_by = bound_ms(nbytes(cols, vals, a, b, sd_out), 2 * nnz * FEATURES)
    crow = torch.zeros(BUCKET + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(live.sum(1), 0)
    pattern = torch.sparse_csr_tensor(crow, cols[live].long(), torch.ones(nnz, device=device),
                                      size=(BUCKET, BUCKET))
    bt = b.T.contiguous()
    lib_ms, lib_call = None, "torch.sparse.sampled_addmm(csr, a, b.T, beta=0)"
    try:
        lib_ms = time_ms(lambda: torch.sparse.sampled_addmm(pattern, a, bt, beta=0.0))
    except (RuntimeError, NotImplementedError) as e:
        log(f"  library SDDMM unavailable ({type(e).__name__}: {str(e)[:120]})")
    log(f"  sddmm bound: {b_ms:.5f} ms by {b_by} ({nbytes(cols, vals, a, b, sd_out) / 1e6:.1f} MB, a and b read "
        f"once each); where a and b are one tensor, as in the smoothness term, it reads "
        f"{nbytes(cols, vals, a, sd_out) / 1e6:.1f} MB: {nbytes(cols, vals, a, sd_out) / HBM_BYTES_PER_S * 1e3:.5f} ms "
        f"(information only)")
    report["sddmm"] = {
        "ms": time_ms(lambda: kernels.sddmm(cols, vals, a, b)),
        "cold_ms": cold_ms(lambda: kernels.sddmm(cols, vals, a, b), flush),
        "plain_ms": time_ms(lambda: kernels.sddmm_plain(cols, vals, a, b)),
        "library_ms": lib_ms, "library_call": lib_call,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(cols, vals, a, b, sd_out),
        "flops": 2 * nnz * FEATURES,
    }
    l2_bytes = nnz * FEATURES * 4 + nbytes(cols, vals, a, sd_out)
    log(f"  sddmm: the gathers read {nnz * FEATURES * 4 / 1e6:.1f} MB of b rows through the L2 cache; with a, the "
        f"pattern and the output the kernel moves {l2_bytes / 1e6:.1f} MB, {l2_bytes / report['sddmm']['ms'] / 1e9:.2f} "
        f"TB/s at its warm time")
    # ell_matmul at the widths of the backward's sums: C=120 over the transpose map
    x120 = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
    report["ell_matmul"]["ms_c120"] = time_ms(lambda: kernels.ell_matmul(cols, vals, x120))
    report["sddmm"]["host_us"] = host_us(lambda: kernels.sddmm(cols, vals, a, b))
    report["ell_matmul"]["host_us"] = host_us(lambda: kernels.ell_matmul(cols, vals, x))
    report["bsr_matmul"]["host_us"] = host_us(lambda: kernels.bsr_matmul(bcols, bvals, x))
    del flush
    for name, r in report.items():
        r["max_abs_err"] = errs[name]
        lib = "not measured" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name}: {r['ms']:.5f} ms warm, {r['cold_ms']:.5f} ms cold L2 (plain {r['plain_ms']:.4f}, "
            f"{r['library_call']} {lib}, bound {r['bound_ms']:.5f} by {r['bound_by']}); "
            f"host {r['host_us']:.1f} us per call")
    log(f"  ell_matmul at C={FEATURES}: {report['ell_matmul']['ms_c120']:.5f} ms warm")
    return report


def serve_phase(device) -> tuple[dict, dict, dict]:
    """Serve LapDeepModel-15 on four ~7,000-vertex requests in both formats;
    returns the kernels' launch counts from that run, the latencies, and
    (server, first prepared request) per format."""
    import torch

    from surfacenetworks_tpu_torch.data import Buckets, laplacian_batch
    from surfacenetworks_tpu_torch.data.datasets import random_blob_mesh
    from surfacenetworks_tpu_torch.geometry import igl_style_laplacian
    from surfacenetworks_tpu_torch.models import LapDeepModel, init_weights
    from surfacenetworks_tpu_torch.serve import NormalServer
    from surfacenetworks_tpu_torch.sparse import kernels

    rng = np.random.default_rng(SEED)
    meshes = [random_blob_mesh(rng, int(rng.integers(6500, 7001))) for _ in range(N_REQUESTS)]
    model = init_weights(LapDeepModel(3, 3, layers=LAYERS), torch.Generator().manual_seed(SEED))
    servers = {fmt: NormalServer(model, device=device, fmt=fmt, bucket=BUCKET) for fmt in ("ell", "bsr")}
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the served model must run in full fp32, not TF32")
    log(f"  tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    prepared = {fmt: [s.prepare(V, F) for V, F in meshes] for fmt, s in servers.items()}
    log(f"  host build of {2 * N_REQUESTS} operators: {time.perf_counter() - t0:.3f} s; "
        f"vertices {[V.shape[0] for V, _ in meshes]}")
    for fmt, s in servers.items():  # warm-up: first-call library set-up
        s.answer(prepared[fmt][0])
        s.device_ms = []

    # the main path: every count is 0 just before it and read just after
    kernels.reset_launch_counts()
    answers, latency = {}, {}
    for fmt, s in servers.items():
        other = "bsr_matmul" if fmt == "ell" else "ell_matmul"
        mine = f"{fmt}_matmul"
        answers[fmt] = []
        for req in prepared[fmt]:
            before = dict(kernels.launches)
            answers[fmt].append(s.answer(req))
            d_mine = kernels.launches[mine] - before[mine]
            d_other = kernels.launches[other] - before[other]
            if d_mine != APPLIES_PER_FORWARD or d_other != 0:
                raise AssertionError(f"{fmt} forward launched {mine} {d_mine}x and {other} {d_other}x")
        latency[fmt] = {"median_ms": float(np.median(s.device_ms)), "ms": s.device_ms}
    counts = dict(kernels.launches)
    log(f"  launches on the main path: {counts}")
    for fmt in servers:
        log(f"  {fmt}: per-request device ms {['%.3f' % t for t in latency[fmt]['ms']]}, "
            f"median {latency[fmt]['median_ms']:.3f}")

    # fp64 forward on a dense operator, no kernel: the arbiter of both formats
    from surfacenetworks_tpu_torch.nn import apply_operator

    model64 = copy.deepcopy(servers["ell"].model).double()
    for i, (V, F) in enumerate(meshes):
        n = V.shape[0]
        L = igl_style_laplacian(V, F, hack=1.0).astype(np.float32).astype(np.float64)
        x = V.astype(np.float32).astype(np.float64)
        lx, scale = L @ x, abs(L) @ abs(x)
        for fmt in servers:
            req = prepared[fmt][i]
            with torch.inference_mode():
                rows = apply_operator(req.operator, req.inputs)[0, :n].double().cpu().numpy()
            got = rows.copy()
            if req.perm is not None:
                got[req.perm] = rows
            check(f"request {i} {fmt} operator pipeline", got, lx, scale, PIPELINE_RTOL)
            if i == 0 and req.perm is not None:  # the check's power: rows left in RCM order
                refused(f"request {i} {fmt} operator rows left in RCM order", rows, lx, scale, PIPELINE_RTOL)
        sample = {"V": V, "F": F, "input": V, "L": L}
        batch = laplacian_batch([sample], Buckets(n_vertices=BUCKET), target_key="input", fmt="dense")
        with torch.inference_mode():
            ref = model64(batch.operator.to(device).double(), batch.mask.to(device).double(),
                          batch.inputs.to(device).double())[0, :n].cpu().numpy()
        fro = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(ref))
        e, b = answers["ell"][i], answers["bsr"][i]
        ok = (e.shape == b.shape == (n, 3) and np.isfinite(e).all() and np.isfinite(b).all()
              and max(fro(e, ref), fro(b, ref), fro(e, b)) <= SERVE_FRO_RTOL)
        log(f"  request {i} (n={n}): rel_fro ell-fp64={fro(e, ref):.3e} bsr-fp64={fro(b, ref):.3e} "
            f"ell-bsr={fro(e, b):.3e} max|ell-bsr|={np.abs(e - b).max():.3e} max|ref|={np.abs(ref).max():.3e} "
            f"(tol {SERVE_FRO_RTOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"request {i}: served answers disagree")
        if i == 0:  # the check's power: the BSR answer left in RCM order
            wrong = fro(b[prepared["bsr"][i].perm], ref)
            log(f"  mutant request {i} bsr answer left in RCM order: rel_fro {wrong:.3e} "
                f"{'refused' if wrong > SERVE_FRO_RTOL else 'NOT refused'}")
            if not wrong > SERVE_FRO_RTOL:
                raise AssertionError("a served answer in the wrong vertex order passes the check")
    return counts, latency, {fmt: (s, prepared[fmt][0]) for fmt, s in servers.items()}


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(self device us, count, name) of the device's own work, largest
    first: kernels and copies, not the user-annotated ranges that the
    profiler also puts on the device's timeline (the optimizer's
    ``Optimizer.step#Adam.step``), which would count their kernels twice."""
    import torch

    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        if getattr(e, "is_user_annotation", False):
            log(f"    (not device work: annotated range {e.key[:60]})")
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return sorted(rows, reverse=True)


def profile_phase(served: dict) -> dict:
    """Where one forward's time goes: host wall time of a synchronised
    forward, and the device time of its kernels from ``torch.profiler``
    (events on the device only: the host operators that launch them carry
    the same time again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for fmt, (server, req) in served.items():
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.answer(req)
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            server.answer(req)
        rows = device_rows(prof)
        busy_ms = sum(r[0] for r in rows) / 1e3
        wall = sorted(walls)[len(walls) // 2]
        log(f"  {fmt}: host wall per forward {wall:.3f} ms (median of 5); device busy {busy_ms:.3f} ms "
            f"in {sum(r[1] for r in rows)} device ops; device idle share {1 - busy_ms / wall:.3f}")
        shown = rows[:8] + [r for r in rows[8:] if "spmm_kernel" in r[2]]
        for dev_us, count, key in shown:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        out[fmt] = {"wall_ms": wall, "device_busy_ms": busy_ms}
    return out


def backward_phase(device) -> None:
    """Each autograd Function's backward on the card (the kernels on
    ``op.bwd``; for the SDDMM two ``ell_matmul``, ``da`` on the pattern and
    ``db`` on its transpose slot map) against autograd through the plain
    forward versions, which derives the transpose itself.  The cotangent is a slice of a wider tensor, not
    contiguous, as the ``[x || L x]`` concat's backward hands it on."""
    import torch

    from surfacenetworks_tpu_torch.data import Buckets, fit_bsr_k, laplacian_batch, rcm_reorder_sample
    from surfacenetworks_tpu_torch.data.datasets import random_blob_mesh
    from surfacenetworks_tpu_torch.geometry import igl_style_laplacian
    from surfacenetworks_tpu_torch.sparse import kernels, ops

    rng = np.random.default_rng(SEED + 200)
    V, F = random_blob_mesh(rng, 7000)
    sample = rcm_reorder_sample({"V": V, "F": F, "input": V.astype(np.float32),
                                 "L": igl_style_laplacian(V, F, hack=1.0)})
    buckets = Buckets(n_vertices=BUCKET)
    fit_bsr_k([sample], buckets)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    def plain_grads(fn, inputs, g):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        fn(*leaves).backward(g)
        return [t.grad for t in leaves]

    for fmt in ("ell", "bsr"):
        op = laplacian_batch([sample], buckets, target_key="input", fmt=fmt).operator.to(device)
        x = torch.randn(1, BUCKET, WIDTH, device=device, generator=gen).requires_grad_()
        g = torch.randn(1, BUCKET, 2 * WIDTH, device=device, generator=gen)[..., WIDTH:]
        assert not g.is_contiguous()
        apply, plain = (ops.spmm, kernels.ell_matmul_plain) if fmt == "ell" else (ops.bsr_spmm, kernels.bsr_matmul_plain)
        m = op.fwd
        parts = (m.cols, m.vals) if fmt == "ell" else (m.block_cols, m.block_vals)
        apply(op, x).backward(g)
        (ref,) = plain_grads(lambda t: plain(*parts, t), [x], g)
        (scale,) = plain_grads(lambda t: plain(parts[0], parts[1].abs(), t), [x.abs()], g.abs())
        check(f"{'spmm' if fmt == 'ell' else 'bsr_spmm'} backward x_bar (|A^T||g|)", x.grad, ref, scale, KERNEL_RTOL)

    op = laplacian_batch([sample], buckets, target_key="input", fmt="ell").operator.to(device)
    m = op.fwd
    a = torch.randn(1, BUCKET, FEATURES, device=device, generator=gen).requires_grad_()
    b = torch.randn(1, BUCKET, FEATURES, device=device, generator=gen).requires_grad_()
    g = torch.randn(1, BUCKET, 2 * m.k, device=device, generator=gen)[..., m.k:]
    ops.sddmm(op, a, b).backward(g)
    ref_a, ref_b = plain_grads(lambda p, q: kernels.sddmm_plain(m.cols, m.vals, p, q), [a, b], g)
    gm = torch.where(m.vals != 0, g, 0.0).abs()
    check("sddmm backward da (|g||b|)", a.grad, ref_a, kernels.ell_matmul_plain(m.cols, gm, b.abs()), KERNEL_RTOL)
    # |g||a| summed into each row of b, in fp64: a tolerance's scale, in any order
    contrib = (gm[0, :, :, None].double() * a.detach()[0, :, None, :].double().abs()).reshape(-1, FEATURES)
    scale_b = torch.zeros(BUCKET, FEATURES, dtype=torch.float64, device=device).index_add_(
        0, m.cols[0].reshape(-1).long(), contrib)[None]
    check("sddmm backward db over the transpose slot map (|g||a|)", b.grad, ref_b, scale_b, KERNEL_RTOL)


def _plain_smoothness(op, f):
    """``losses.corr_feature_smoothness`` through the plain SDDMM (autograd
    through its gather): no kernel."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    fn = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp_min(1e-9)
    cols, vals = op.fwd.cols, op.fwd.vals
    scores = kernels.sddmm_plain(cols, vals, fn, fn)
    w = vals.abs() * (cols != torch.arange(cols.shape[-2], device=cols.device)[:, None])
    return -(w * scores).sum() / (w.sum() + 1e-9)


def _dense64(trainer, i):
    """Sample ``i``'s operator as a dense fp64 ``[1, N, N]`` on the card (the
    fp32 values the kernels see, widened)."""
    import torch

    dev, N = trainer.device, trainer.N
    L = trainer.data[i]["L"].tocoo()
    dense = torch.zeros(N, N, dtype=torch.float64, device=dev)
    dense.index_put_((torch.from_numpy(L.row).long().to(dev), torch.from_numpy(L.col).long().to(dev)),
                     torch.from_numpy(L.data.astype(np.float32).astype(np.float64)).to(dev), accumulate=True)
    return dense[None]


def _plain_head(trainer, fa, fb, ia, ib):
    """The step's loss from features ``fa, fb [1, N, 120]`` with no kernel:
    dcel over the full logits plus the smoothness terms through the plain
    SDDMM."""
    import torch

    from surfacenetworks_tpu_torch.train import losses

    loss = losses.corr_delta_cross_entropy_from_target(torch.einsum("bnc,bmc->bnm", fa, fb)[0],
                                                       trainer.pair_target(ia, ib))
    return loss + trainer.smooth_w * (_plain_smoothness(trainer.dev_sample(ia)["reg_op"], fa)
                                      + _plain_smoothness(trainer.dev_sample(ib)["reg_op"], fb))


def _model(state0, device, dtype):
    from surfacenetworks_tpu_torch.models import SiameseModel

    model = SiameseModel("lap", LAYERS)
    model.load_state_dict(state0)
    return model.to(device, dtype)


def _dense_step0(trainer, state0, ia, ib, rots, dense, dtype):
    """The whole step 0 with dense operators, the full-logits dcel and the
    plain SDDMM (no kernel), in ``dtype``.  Returns (loss, gradients)."""
    from surfacenetworks_tpu_torch.cli.train_correspondence import rot_matrix

    model = _model(state0, trainer.device, dtype)
    args = []
    for k, i in enumerate((ia, ib)):
        d = trainer.dev_sample(i)
        x = d["inputs"].to(dtype) @ rot_matrix(float(rots[2 * k]), float(rots[2 * k + 1]), trainer.device, dtype)
        args.append(((dense[k].to(dtype), d["mask"].to(dtype)), x))
    fa, fb = model.features(args[0][0], args[1][0], args[0][1], args[1][1])
    loss = _plain_head(trainer, fa, fb, ia, ib)
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach() for k, p in model.named_parameters()}


class StepCapture:
    """Forward hooks on the trunk and its modules that keep, for each call
    (shape A, then shape B), the module's inputs and output and, once
    backward has run, the output's cotangent.  Reading only: the step runs
    as without them."""

    def __init__(self, trunk):
        self.names = ["conv1"] + [f"rn{i}" for i in range(trunk.layers)] + ["conv2"]
        self.calls = {name: [] for name in self.names + ["trunk"]}
        mods = [(n, getattr(trunk, n)) for n in self.names] + [("trunk", trunk)]
        self.handles = [m.register_forward_hook(self._hook(n)) for n, m in mods]

    def _hook(self, name):
        def hook(module, args, out):
            rec = {"args": [a.detach() if hasattr(a, "detach") else a for a in args], "out": out.detach()}
            out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
            self.calls[name].append(rec)
        return hook

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _rel_fro(got, ref) -> float:
    return float((got.double() - ref).norm() / ref.norm().clamp_min(1e-300))


def modulewise_errors(trainer, state0, cap: StepCapture, loss: float, grads: dict, ia, ib, dense) -> dict:
    """Step 0 against fp64, module by module at the card's own activations:
    the loss and the features' cotangent from the head in fp64 on the card's
    features; then for each trunk module, both shapes' calls in fp64 (dense
    operators, no kernel) from the card's inputs and output cotangents, and
    their input cotangents and parameter gradients held against the card's.
    Returns each comparison's relative (Frobenius) error."""
    import torch

    errs = {}
    feats = [rec["out"].double().requires_grad_() for rec in cap.calls["trunk"]]
    loss64 = _plain_head(trainer, feats[0], feats[1], ia, ib)
    loss64.backward()
    errs["loss on the card's features"] = abs(loss - float(loss64.detach())) / abs(float(loss64.detach()))
    for k, (f, rec) in enumerate(zip(feats, cap.calls["trunk"])):
        errs[f"head cotangent of features {'AB'[k]}"] = _rel_fro(rec["g"], f.grad)
    model64 = _model(state0, trainer.device, torch.float64)
    masks = [trainer.dev_sample(i)["mask"].double() for i in (ia, ib)]
    for j, name in enumerate(cap.names):
        mod = getattr(model64.trunk, name)
        for k in range(2):
            rec = cap.calls[name][k]
            if name == "conv2":  # from the last block's output, through the trunk's ELU
                x = cap.calls[cap.names[j - 1]][k]["out"].double().requires_grad_()
                out = mod(torch.nn.functional.elu(x))
            else:
                x = rec["args"][-1].double().requires_grad_()
                out = mod(x) if name == "conv1" else mod(dense[k], masks[k], x)
            out.backward(rec["g"].double())
            if j > 0:  # the card's cotangent at this input is the one at the previous module's output
                errs[f"{name} input cotangent {'AB'[k]}"] = _rel_fro(cap.calls[cap.names[j - 1]][k]["g"], x.grad)
        for pname, p in mod.named_parameters():
            errs[f"{name}.{pname} gradient"] = _rel_fro(grads[f"trunk.{name}.{pname}"], p.grad)
    return errs


def _detached_step0(trainer, state0, ia, ib, rots):
    """The mutant: step 0 with operator applies that return the kernel's
    output detached (no gradient flows through L), captured like the real
    step.  Returns (loss, gradients, capture)."""
    from surfacenetworks_tpu_torch.cli.train_correspondence import objective
    from surfacenetworks_tpu_torch.models import SiameseModel
    from surfacenetworks_tpu_torch.nn import blocks
    from surfacenetworks_tpu_torch.sparse import kernels

    model = SiameseModel("lap", LAYERS)
    model.load_state_dict(state0)
    model = model.to(trainer.device)
    cap = StepCapture(model.trunk)
    saved = blocks.spmm, blocks.bsr_spmm
    blocks.spmm = lambda op, x: kernels.ell_matmul(op.fwd.cols, op.fwd.vals, x.contiguous()).detach()
    blocks.bsr_spmm = lambda op, x: kernels.bsr_matmul(op.fwd.block_cols, op.fwd.block_vals, x.contiguous()).detach()
    try:
        loss = objective(model, trainer.dev_sample(ia), trainer.dev_sample(ib), [float(r) for r in rots],
                         trainer.pair_target(ia, ib), trainer.smooth_w, trainer.use_stream)
        loss.backward()
    finally:
        blocks.spmm, blocks.bsr_spmm = saved
        cap.remove()
    return float(loss.detach()), {k: p.grad.detach() for k, p in model.named_parameters()}, cap


def step0_check(fmt, trainer, state0, res, ia, ib, rots) -> list[str]:
    """Step 0 against fp64 with dense operators and no kernel, and the
    detached-apply mutant against the same; returns the failures."""
    failures = []
    import torch

    dense = [_dense64(trainer, i) for i in (ia, ib)]
    ref_loss, ref_grads = _dense_step0(trainer, state0, ia, ib, rots, dense, torch.float64)
    whole = {k: _rel_fro(g, ref_grads[k]) for k, g in res["grads0"].items()}
    loss_rel = abs(res["loss"][0] - ref_loss) / abs(ref_loss)
    log(f"  {fmt}: step 0 vs the whole fp64 step: loss {res['loss'][0]:.6f} vs {ref_loss:.6f} (rel {loss_rel:.3e}, "
        f"tol {STEP0_LOSS_RTOL:g}); gradient rel_fro median {np.median(list(whole.values())):.3e}, "
        f"max {max(whole.values()):.3e} (reported, not bounded: the near-one-hot softmax of the dcel head "
        f"turns fp32 rounding of the features into other argmax rows)")
    # the same fp32 rounding without any kernel: dense operators in fp32
    p_loss, p_grads = _dense_step0(trainer, state0, ia, ib, rots, dense, torch.float32)
    plain = [_rel_fro(g, ref_grads[k]) for k, g in p_grads.items()]
    log(f"  {fmt}: the same step in fp32 with dense operators and no kernel vs fp64: loss rel "
        f"{abs(p_loss - ref_loss) / abs(ref_loss):.3e}; gradient rel_fro median {np.median(plain):.3e}, "
        f"max {max(plain):.3e}")
    if not loss_rel <= STEP0_LOSS_RTOL:
        failures.append(f"{fmt}: step-0 loss {res['loss'][0]} vs fp64 {ref_loss}")
    for label, (loss, grads, cap) in {"real": (res["loss"][0], res["grads0"], res["capture"]),
                                      "mutant detached applies": _detached_step0(trainer, state0, ia, ib, rots)}.items():
        errs = modulewise_errors(trainer, state0, cap, loss, grads, ia, ib, dense)
        groups = {"chain": {k: v for k, v in errs.items() if not k.endswith("gradient")},
                  "parameter": {k: v for k, v in errs.items() if k.endswith("gradient")}}
        worst = {g: max(e.items(), key=lambda kv: kv[1]) for g, e in groups.items()}
        ok = worst["chain"][1] <= STEP0_CHAIN_RTOL and worst["parameter"][1] <= STEP0_PARAM_RTOL
        verdict = ("ok" if ok else "FAIL") if label == "real" else ("NOT refused" if ok else "refused")
        log(f"  {fmt} {label}: module-wise vs fp64: loss on the card's features rel "
            f"{errs['loss on the card\'s features']:.3e}; chain ({len(groups['chain'])}) worst "
            f"{worst['chain'][0]} {worst['chain'][1]:.3e} (tol {STEP0_CHAIN_RTOL:g}), median "
            f"{np.median(list(groups['chain'].values())):.3e}; parameter gradients ({len(groups['parameter'])}) "
            f"worst {worst['parameter'][0]} {worst['parameter'][1]:.3e} (tol {STEP0_PARAM_RTOL:g}), median "
            f"{np.median(list(groups['parameter'].values())):.3e}; {verdict}")
        if label == "real":
            top = sorted(errs.items(), key=lambda kv: -kv[1])[:6]
            log(f"  {fmt} {label}: largest: " + ", ".join(f"{k} {v:.3e}" for k, v in top))
            res["step0"] = {"loss_rel": loss_rel, "whole_grad_fro_median": float(np.median(list(whole.values()))),
                            "worst": worst}
            if not ok:
                failures.append(f"{fmt}: step 0 disagrees with fp64 at {worst}")
        else:
            res["step0"]["mutant_worst"] = worst
            if ok:
                failures.append(f"{fmt}: the detached-apply mutant passes the step-0 check")
    return failures


def train_phase(device, smi: str) -> tuple[dict, dict]:
    """The FAUST siamese trainer in both formats: build each trainer and its
    device caches, then (counts at 0) 8 updates and the test pass each;
    returns the train path's launch counts and per-format results."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from surfacenetworks_tpu_torch.cli import train_correspondence as tc
    from surfacenetworks_tpu_torch.sparse import kernels

    trainers, plans, states, opt_states, rng_states = {}, {}, {}, {}, {}
    for fmt in ("ell", "bsr"):
        t0 = time.perf_counter()
        argv = TRAIN_ARGS + ["--operator-format", fmt]
        trainer = tc.CorrespondenceTrainer(tc.parser.parse_args(argv), log=lambda m: log(f"  [{fmt}] {m}"))
        rng_states[fmt] = copy.deepcopy(trainer.rng.bit_generator.state)
        plans[fmt] = trainer.epoch_plan()
        for ia, ib in plans[fmt][0]:  # operators, geodesics, pair targets and their inverses on the card first
            trainer.pair_target(int(ia), int(ib))
            if trainer.use_stream:
                trainer.pair_inverse(int(ia), int(ib))
        for i in range(trainer.n_train, len(trainer.data)):
            trainer.dev_sample(i)
        torch.cuda.synchronize()
        states[fmt] = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        opt_states[fmt] = copy.deepcopy(trainer.opt.state_dict())
        trainers[fmt] = trainer
        log(f"  {fmt}: bucket {trainer.N}, n_train {trainer.n_train}, streaming head {trainer.use_stream}, "
            f"{'bsr_k ' + str(trainer.buckets.bsr_k) if fmt == 'bsr' else 'ell_k 16'}; "
            f"set-up {time.perf_counter() - t0:.2f} s; plan pairs {plans[fmt][0].tolist()}")
        mult = {f"{a},{b}": int(inv[0].shape[1]) for (a, b), inv in trainer._inverses.items()}
        log(f"  {fmt}: largest multiplicity of each pair's dcel target (the mirror's ELL width) {mult}; "
            f"transpose slot map of the smoothness pattern K_t "
            f"{[int(trainer.dev_sample(i)['reg_op'].transpose_map()[0].shape[-1]) for i in range(len(trainer.data))]}")

    # the main path: every count is 0 just before it and read just after
    kernels.reset_launch_counts()
    results = {}
    for fmt, trainer in trainers.items():
        pair_idx, rots = plans[fmt]
        res = {"loss": [], "device_ms": [], "wall_ms": [], "per_step": []}
        for u, ((ia, ib), r) in enumerate(zip(pair_idx, rots)):
            before = dict(kernels.launches)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            if u == 0:  # step 0 runs with the module-wise capture (reading only)
                cap = StepCapture(trainer.model.trunk)
                loss = trainer.update(int(ia), int(ib), r)
                cap.remove()
                res["capture"] = cap
            elif u == len(pair_idx) - 1:  # the last step runs under the profiler
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    loss = trainer.update(int(ia), int(ib), r)
                    torch.cuda.synchronize()
            else:
                loss = trainer.update(int(ia), int(ib), r)
            end.record()
            end.synchronize()
            res["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            res["device_ms"].append(start.elapsed_time(end))
            res["loss"].append(float(loss))
            res["per_step"].append({k: kernels.launches[k] - before[k] for k in before})
            if u == 0:
                res["grads0"] = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}
        before = dict(kernels.launches)
        res["test"] = trainer.test_pass(0)
        res["test_launches"] = {k: kernels.launches[k] - before[k] for k in before}
        rows = device_rows(prof)
        res["busy_ms"] = sum(r[0] for r in rows) / 1e3
        res["device_ops"] = sum(r[1] for r in rows)
        res["top"] = rows[:8] + [r for r in rows[8:] if "spmm_kernel" in r[2] or "sddmm_kernel" in r[2]]
        results[fmt] = res
    counts = dict(kernels.launches)
    log(f"  launches on the train path (8 updates + test pass per format): {counts}")

    # the same 8 updates and test pass again, from step 0's weights, Adam
    # state and random state, on the same data and device caches
    for fmt, trainer in trainers.items():
        trainer.model.load_state_dict(states[fmt])
        trainer.opt.load_state_dict(opt_states[fmt])
        trainer.rng.bit_generator.state = rng_states[fmt]
        pair_idx, rots = trainer.epoch_plan()
        same_plan = np.array_equal(pair_idx, plans[fmt][0]) and np.array_equal(rots, plans[fmt][1])
        again = [float(trainer.update(int(ia), int(ib), r)) for (ia, ib), r in zip(pair_idx, rots)]
        results[fmt]["repeat"] = {"same_plan": same_plan, "loss": again, "test": trainer.test_pass(0)}

    for fmt, res in results.items():
        steady = slice(1, len(res["loss"]) - 1)  # not the first step, not the profiled one
        dev_med = float(np.median(res["device_ms"][steady]))
        wall_med = float(np.median(res["wall_ms"][steady]))
        res.update(device_ms_median=dev_med, wall_ms_median=wall_med, idle_share=1 - res["busy_ms"] / wall_med)
        log(f"  {fmt}: losses {['%.4f' % v for v in res['loss']]} ({smi})")
        log(f"  {fmt}: device ms per step (CUDA events) {['%.2f' % v for v in res['device_ms']]}, "
            f"median of steps 1-6 {dev_med:.3f}; host wall per step {['%.2f' % v for v in res['wall_ms']]}, "
            f"median {wall_med:.3f}; profiled step device busy {res['busy_ms']:.3f} ms in {res['device_ops']} "
            f"device ops, idle share {res['idle_share']:.3f} ({smi})")
        for dev_us, count, key in res["top"]:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        log(f"  {fmt}: launches per step {res['per_step'][0]} (expected {EXPECTED_PER_STEP[fmt]}); "
            f"test pass {res['test_launches']} ({smi})")
        log(f"  {fmt}: test metrics {res['test']} ({smi})")
        rep = res["repeat"]
        res["reproduced"] = rep["same_plan"] and rep["loss"] == res["loss"] and rep["test"] == res["test"]
        log(f"  {fmt}: two runs of 8 steps from the same state: losses run 1 {[repr(v) for v in res['loss']]}, "
            f"run 2 {[repr(v) for v in rep['loss']]}; test metrics run 1 {res['test']}, run 2 {rep['test']}; "
            f"{'bit-identical' if res['reproduced'] else 'DIFFERENT'}")

    # the checks: each failure below fails the run
    failures = []
    for fmt, res in results.items():
        trainer = trainers[fmt]
        if not all(np.isfinite(res["loss"])):
            failures.append(f"{fmt}: a loss is not finite")
        if any(step != EXPECTED_PER_STEP[fmt] for step in res["per_step"]):
            failures.append(f"{fmt}: launches per step {res['per_step']} != {EXPECTED_PER_STEP[fmt]}")
        if not res["reproduced"]:
            failures.append(f"{fmt}: a second run of the 8 steps from the same state gave other losses or metrics")
        for k, g in res["grads0"].items():
            if not (bool(torch.isfinite(g).all()) and bool((g != 0).any())):
                failures.append(f"{fmt}: step-0 gradient of {k} is not finite and non-zero")
        ia, ib = (int(v) for v in plans[fmt][0][0])
        failures += step0_check(fmt, trainer, states[fmt], res, ia, ib, plans[fmt][1][0])
        del res["capture"], res["grads0"]
    if failures:
        raise AssertionError("; ".join(failures))
    return counts, results


KERNEL_SYMBOLS = {"bsr_matmul": "bsr_spmm_kernel", "ell_matmul": "ell_spmm_kernel", "sddmm": "sddmm_kernel"}


def _variant(symbol: str) -> str:
    """A kernel's name and template argument from its mangled symbol."""
    for kname, fn in KERNEL_SYMBOLS.items():
        if fn in symbol:
            return f"{fn}<{'true' if 'ILb1E' in symbol else 'false'}>"
    return symbol[:60]


def ptxas_report(text: str) -> dict:
    """Registers and spills of each kernel from ``nvcc -Xptxas -v``; logs
    them and returns ``{variant: {"registers": n, "spill_stores": n,
    "spill_loads": n}}``."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = _variant(m.group(1))
            out.setdefault(cur, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    for name, r in sorted(out.items()):
        log(f"  ptxas: {name}: {r.get('registers')} registers, spill stores {r.get('spill_stores')} bytes, "
            f"spill loads {r.get('spill_loads')} bytes")
    return out


def sass_check(lib_path: str) -> None:
    """``cuobjdump -sass`` of the built library, where the toolkit has it:
    every variant of the BSR kernel must run TF32 tensor-core products
    (``HMMA`` on ``TF32`` operands), or the run fails."""
    import os
    import re
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if not tool:
        log("  SASS check: no cuobjdump in this toolkit; not checked")
        return
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    found = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = _variant(part.split("\n", 1)[0].strip())
        hmma = [ln.strip() for ln in part.splitlines() if "HMMA" in ln]
        found[name] = (len(hmma), sum("TF32" in ln for ln in hmma), hmma[0] if hmma else "")
    for name, (n_hmma, n_tf32, first) in sorted(found.items()):
        log(f"  SASS: {name}: {n_hmma} HMMA, {n_tf32} on TF32 operands{'; e.g. ' + first[:90] if first else ''}")
    bsr = [v for k, v in found.items() if k.startswith("bsr_spmm_kernel")]
    if not bsr or any(n_tf32 == 0 for _, n_tf32, _ in bsr):
        raise AssertionError("the BSR kernel's SASS holds no TF32 HMMA instruction")


def main() -> int:
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a CUDA card",
              file=sys.stderr)
        return 1
    from surfacenetworks_tpu_torch.sparse import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {name} count {torch.cuda.device_count()}")
    phase("device", t0)

    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info
    log(f"  nvcc build {info['seconds']:.2f} s -> {info['path']}" if "seconds" in info
        else f"  library already built: {info['path']}")
    registers = ptxas_report(info.get("log", ""))
    sddmm_regs = {k: v for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS["sddmm"])}
    if not sddmm_regs or any(v.get("registers", 99) > 64 or v.get("spill_stores") or v.get("spill_loads")
                             for v in sddmm_regs.values()):
        raise AssertionError(f"the SDDMM kernel must fit in 64 registers without spills: {sddmm_regs}")
    sass_check(info["path"])
    phase("build", t0)

    t0 = time.perf_counter()
    report = kernel_phase(device)
    phase("kernels", t0)

    t0 = time.perf_counter()
    counts, latency, served = serve_phase(device)
    phase("serve", t0)

    t0 = time.perf_counter()
    profile_phase(served)
    phase("profile", t0)

    t0 = time.perf_counter()
    backward_phase(device)
    phase("backward", t0)

    t0 = time.perf_counter()
    train_counts, trained = train_phase(device, smi)
    phase("train", t0)

    replaces = {
        "bsr_matmul": "surfacenetworks_tpu/sparse/pallas_kernels.py:163",
        "ell_matmul": "surfacenetworks_tpu/sparse/pallas_kernels.py:239",
        "sddmm": "surfacenetworks_tpu/sparse/pallas_kernels.py:320",
    }
    # ``launches`` counts the train path, which runs all three kernels;
    # ``serve_launches`` the serving path.  ``ms`` and ``max_abs_err`` are
    # kept under the names ``kernel_ms`` and ``max_err_vs_plain`` too, so
    # readers of either set of names find them.
    entries = []
    for kname in ("bsr_matmul", "ell_matmul", "sddmm"):
        r = report[kname]
        if train_counts[kname] == 0:
            raise AssertionError(f"{kname} was not launched on the train path")
        entries.append({
            "name": kname, "route": "cuda", "source": "surfacenetworks_tpu_torch/sparse/csrc/spmm.cu",
            "replaces": replaces[kname], "launches": train_counts[kname], "serve_launches": counts[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_call": r["library_call"], "max_err_vs_plain": r["max_abs_err"], "kernel_ms": r["ms"],
            "bytes": r["bytes"], "flops": r["flops"], "card": smi, "cold_ms": r["cold_ms"],
            "registers": {k: v.get("registers") for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS[kname])},
            "spill_bytes": {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                            for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS[kname])},
        })
        if kname == "bsr_matmul":
            entries[-1].update(fp32_fma_bound_ms=r["fp32_fma_bound_ms"], fp32_fma_bound_by=r["fp32_fma_bound_by"])
    log(f"serve median ms per request: ell {latency['ell']['median_ms']:.3f}, "
        f"bsr {latency['bsr']['median_ms']:.3f} ({smi})")
    log("train median per step: " + ", ".join(
        f"{fmt} device {r['device_ms_median']:.3f} ms, wall {r['wall_ms_median']:.3f} ms"
        for fmt, r in trained.items()) + f" ({smi})")
    log(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
