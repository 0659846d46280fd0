"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``surfacenetworks_tpu_torch/sparse/csrc``
with one ``nvcc`` call, holds each kernel against its plain PyTorch version
at the serving path's shapes and times both, then serves LapDeepModel-15 at
width 128 through ``NormalServer`` on four ~7,000-vertex meshes in the ELL
and the BSR operator format, and checks the answers against each other and
against an fp64 forward that uses no kernel.  It needs a CUDA card; without
one (or without the package beside it) it exits non-zero and prints no
result.  The last two lines are a JSON ``kernels`` report and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FMA
# outside the tensor cores, flop/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

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


def bound_ms(n_bytes: int, flops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _np(a):
    return a.double().cpu().numpy() if hasattr(a, "cpu") else np.asarray(a, dtype=np.float64)


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


def kernel_phase(device) -> dict:
    """Hold both kernels against their plain versions at the serving shapes
    and time kernel, plain version and one library call."""
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

    def ell(name, c_, v_, x):
        ref = kernels.ell_matmul_plain(c_, v_, x)
        scale = kernels.ell_matmul_plain(c_, v_.abs(), x.abs())
        errs["ell_matmul"] = max(errs["ell_matmul"], check(
            name, kernels.ell_matmul(c_, v_, x), ref, scale, KERNEL_RTOL))

    def bsr(name, c_, v_, x):
        ref = kernels.bsr_matmul_plain(c_, v_, x)
        scale = kernels.bsr_matmul_plain(c_, v_.abs(), x.abs())
        errs["bsr_matmul"] = max(errs["bsr_matmul"], check(
            name, kernels.bsr_matmul(c_, v_, x), ref, scale, KERNEL_RTOL))

    for c in (WIDTH, 3):
        x = torch.randn(BUCKET, c, device=device, generator=gen)
        ell(f"ell_matmul R={BUCKET} K={cols.shape[1]} C={c}", cols, vals, x)
        bsr(f"bsr_matmul NB={bcols.shape[0]} KB={bcols.shape[1]} C={c}", bcols, bvals, x)
    # ragged ELL: the unpadded operator, R = n not a multiple of 128
    rag = operator_from_scipy(sample["L"]).fwd.to(device)
    x = torch.randn(rag.n_cols, WIDTH, device=device, generator=gen)
    ell(f"ell_matmul ragged R={rag.n_rows} K={rag.k} C={WIDTH}", rag.cols, rag.vals, x)
    # batched launch (B=2): the leading batch axis is one launch
    xb = torch.randn(2, BUCKET, WIDTH, device=device, generator=gen)
    ell("ell_matmul batched B=2", torch.stack([cols, cols]), torch.stack([vals, vals.flip(0)]), xb)
    bsr("bsr_matmul batched B=2", torch.stack([bcols, bcols]), torch.stack([bvals, bvals * 0.5]), xb)

    # the check's power: a kernel that dropped one slot of one row must fail it
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
    refused(f"bsr_matmul without slot {s} of block-row {i}", kernels.bsr_matmul(bcols, dropped, x),
            kernels.bsr_matmul_plain(bcols, bvals, x), kernels.bsr_matmul_plain(bcols, bvals.abs(), x.abs()),
            KERNEL_RTOL)

    # timing at the serving shape (C=128)
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
    b_ms, b_by = bound_ms(nbytes(cols, vals, x, out), 2 * nnz * WIDTH)
    report["ell_matmul"] = {
        "ms": time_ms(lambda: kernels.ell_matmul(cols, vals, x)),
        "plain_ms": time_ms(lambda: kernels.ell_matmul_plain(cols, vals, x)),
        "library_ms": csr_ms,
        "library_call": "torch.sparse.mm(csr, x)",
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(cols, vals, x, out), "flops": 2 * nnz * WIDTH,
    }
    nnzb = int((bvals != 0).flatten(2).any(dim=2).sum())
    flops = 2 * nnzb * 128 * 128 * WIDTH
    b_ms, b_by = bound_ms(nbytes(bcols, bvals, x, out), flops)
    lib_ms, lib_call = csr_ms, "torch.sparse.mm(csr, x)"
    try:  # the same operator in PyTorch's own BSR layout, where CUDA supports it
        lib_bsr = lib_csr.to_dense().to_sparse_bsr((128, 128))
        lib_ms, lib_call = time_ms(lambda: torch.sparse.mm(lib_bsr, x)), "torch.sparse.mm(bsr128, x)"
    except (RuntimeError, NotImplementedError) as e:
        log(f"  library BSR call unavailable ({type(e).__name__}: {str(e)[:120]}); using CSR")
    report["bsr_matmul"] = {
        "ms": time_ms(lambda: kernels.bsr_matmul(bcols, bvals, x)),
        "plain_ms": time_ms(lambda: kernels.bsr_matmul_plain(bcols, bvals, x)),
        "library_ms": lib_ms, "library_call": lib_call,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(bcols, bvals, x, out), "flops": flops,
        "nonzero_blocks": nnzb, "slots": bcols.numel(),
    }
    report["ell_matmul"]["host_us"] = host_us(lambda: kernels.ell_matmul(cols, vals, x))
    report["bsr_matmul"]["host_us"] = host_us(lambda: kernels.bsr_matmul(bcols, bvals, x))
    for name, r in report.items():
        r["max_abs_err"] = errs[name]
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, {r['library_call']} "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}); "
            f"host {r['host_us']:.1f} us per call")
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
        rows = []
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if e.device_type != torch.autograd.DeviceType.CPU and dev_us > 0:
                rows.append((dev_us, e.count, e.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        wall = sorted(walls)[len(walls) // 2]
        log(f"  {fmt}: host wall per forward {wall:.3f} ms (median of 5); device busy {busy_ms:.3f} ms "
            f"in {sum(r[1] for r in rows)} device ops; device idle share {1 - busy_ms / wall:.3f}")
        shown = rows[:8] + [r for r in rows[8:] if "spmm_kernel" in r[2]]
        for dev_us, count, key in shown:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        out[fmt] = {"wall_ms": wall, "device_busy_ms": busy_ms}
    return out


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
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            log(f"  {line.strip()}")
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

    replaces = {
        "bsr_matmul": "surfacenetworks_tpu/sparse/pallas_kernels.py:163",
        "ell_matmul": "surfacenetworks_tpu/sparse/pallas_kernels.py:239",
    }
    # ``ms`` and ``max_abs_err`` are kept under the names ``kernel_ms`` and
    # ``max_err_vs_plain`` too, so readers of either set of names find them.
    entries = []
    for kname in ("bsr_matmul", "ell_matmul"):
        r = report[kname]
        if counts[kname] == 0:
            raise AssertionError(f"{kname} was not launched on the main path")
        entries.append({
            "name": kname, "route": "cuda", "source": "surfacenetworks_tpu_torch/sparse/csrc/spmm.cu",
            "replaces": replaces[kname], "launches": counts[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_call": r["library_call"], "max_err_vs_plain": r["max_abs_err"], "kernel_ms": r["ms"],
            "bytes": r["bytes"], "flops": r["flops"], "card": smi,
        })
    log(f"serve median ms per request: ell {latency['ell']['median_ms']:.3f}, "
        f"bsr {latency['bsr']['median_ms']:.3f} ({smi})")
    log(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
