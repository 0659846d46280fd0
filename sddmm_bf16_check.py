"""Hold the bf16 ``sddmm`` kernel against another build of it, bit for bit, and time both, on one CUDA card.

    python3 sddmm_bf16_check.py --against OTHER_SPMM_CU [--out FILE]

``OTHER_SPMM_CU`` is another version of ``surfacenetworks_tpu_torch/sparse/
csrc/spmm.cu`` (an earlier commit's, written out with ``git show
<commit>:surfacenetworks_tpu_torch/sparse/csrc/spmm.cu > FILE``).  It is
built with the port's flags while the port's own library builds, and both
libraries' ``snx_sddmm_bf16`` are called on the same inputs at every shape
of ``chip_smoke.py``'s bf16 SDDMM checks and more: K=16, C=120 with a = b
(unit rows, the smoothness term); slots permuted within each row at K 5,
16 and 33; C 3, 8, 16, 64, 120, 130 and 264; the unpadded operator (R =
7,000, no multiple of the rows a warp holds); two stacked operators (B=2).
The two outputs must be equal (``torch.equal``) everywhere, and the port's
within one bf16 ulp of the plain version more than 1e-5 of ``|a||b|``.
Then both are timed warm and with a cold L2 at K=16, C=120 (a and b apart,
and a = b), in two rounds, with each build's registers and spills.

It prints the card's name and power limit, and, as its last line, one JSON
object with every reading (also written to ``--out`` if given).  Without a
CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.snx_sddmm_bf16
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    return fn


def _call(fn, cols, vals, a, b):
    """One ``snx_sddmm_bf16`` call on [B, R, K] (or [R, K]) slots, as
    ``kernels.sddmm`` makes it."""
    import torch

    batched = cols.dim() == 3
    c_, v_, a_, b_ = (t if batched else t[None] for t in (cols, vals, a, b))
    B, R, K = c_.shape
    n, c = b_.shape[1:]
    out = torch.empty(B, R, K, device=b.device, dtype=torch.bfloat16)
    vec = c % 8 == 0 and a_.data_ptr() % 16 == 0 and b_.data_ptr() % 16 == 0
    code = fn(c_.data_ptr(), v_.data_ptr(), a_.data_ptr(), b_.data_ptr(), out.data_ptr(), B, R, K, n, c, int(vec),
              ctypes.c_void_p(torch.cuda.current_stream(b.device).cuda_stream))
    if code != 0:
        raise RuntimeError(f"snx_sddmm_bf16 failed with cudaError {code}")
    return out if batched else out[0]


def cases(device) -> dict:
    """name -> (cols, vals, a, b): the shapes the check covers."""
    import torch

    from surfacenetworks_tpu_torch.sparse import operator_from_scipy

    bf = torch.bfloat16
    sample, ell_op, _ = cs.bf16_operands(device)
    cols, vals = ell_op.fwd.cols[0], ell_op.fwd.vals[0]
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 17)

    def ab(rows, n, c, lead=()):
        return (torch.randn(*lead, rows, c, device=device, generator=gen).to(bf),
                torch.randn(*lead, n, c, device=device, generator=gen).to(bf))

    out = {}
    fn = torch.nn.functional.normalize(torch.randn(cs.BUCKET, cs.FEATURES, device=device, generator=gen), dim=-1)
    out[f"K=16 C={cs.FEATURES} a=b (unit rows)"] = (cols, vals, fn.to(bf), fn.to(bf))
    perm = torch.argsort(torch.rand(cols.shape, device=device, generator=gen), dim=1)
    pc, pv = cols.gather(1, perm), vals.gather(1, perm)
    c33 = torch.cat([pc, pc.roll(1, 0), pc[:, :1].roll(2, 0)], 1).contiguous()
    v33 = torch.cat([pv, pv.roll(1, 0) * 0.5, pv[:, :1].roll(2, 0)], 1).contiguous()
    for kk, (c_, v_) in {5: (pc[:, :5].contiguous(), pv[:, :5].contiguous()), 16: (pc, pv), 33: (c33, v33)}.items():
        out[f"permuted K={kk} C={cs.FEATURES}"] = (c_, v_, *ab(cs.BUCKET, cs.BUCKET, cs.FEATURES))
    for c in (3, 8, 16, 64, 120, 130, 264):
        out[f"permuted K=16 C={c}"] = (pc, pv, *ab(cs.BUCKET, cs.BUCKET, c))
    rag = operator_from_scipy(sample["L"]).fwd.to(device)
    for c in (cs.FEATURES, 64, 8):
        out[f"ragged R={rag.n_rows} K={rag.k} C={c}"] = (rag.cols, rag.vals, *ab(rag.n_rows, rag.n_cols, c))
    for c in (cs.FEATURES, 64):
        out[f"batched B=2 K=16 C={c}"] = (torch.stack([cols, cols]), torch.stack([vals, vals.flip(0)]),
                                          *ab(cs.BUCKET, cs.BUCKET, c, (2,)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, help="another spmm.cu to build and hold the port's build against")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sddmm_bf16_check: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 1
    from surfacenetworks_tpu_torch.sparse import _build, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    device = torch.device("cuda", 0)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="sddmm_check_", dir=_build.BUILD_DIR))
    try:
        other_lib = tmp / "libsnx_spmm_other.so"
        t0 = time.perf_counter()
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(other_lib), args.against],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            _build.load()
            o_out, o_err = proc.communicate()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {args.against}:\n{o_err}")
        cs.log(f"  both builds in {time.perf_counter() - t0:.2f} s")
        fns = {"port": _bind(Path(_build.build_info["path"])), "other": _bind(other_lib)}
        regs = {"port": cs.ptxas_report(_build.build_info.get("log", "")), "other": cs.ptxas_report(o_err + o_out)}
        regs = {k: {s: v for s, v in r.items() if s.startswith("sddmm_bf16_kernel")} for k, r in regs.items()}
        for k, r in regs.items():
            cs.log(f"  {k} build: " + "; ".join(f"{s} {v}" for s, v in r.items()))

        failures, worst, shapes = [], 0.0, cases(device)
        for name, (c_, v_, a, b) in shapes.items():
            got, other = _call(fns["port"], c_, v_, a, b), _call(fns["other"], c_, v_, a, b)
            same = torch.equal(got, other)
            splain = kernels.sddmm_plain
            worst = max(worst, cs.check(f"sddmm bf16 {name} (port build)", got, splain(c_, v_, a, b),
                                        splain(c_, v_, a.double().abs(), b.double().abs()), cs.KERNEL_RTOL, ulps=1))
            cs.log(f"  {name}: port build and {args.against}: {'bit-identical' if same else 'DIFFER'}")
            if not same:
                failures.append(name)
        if failures:
            raise AssertionError(f"the builds differ at {failures}")

        _, ell_op, _ = cs.bf16_operands(device)
        cols, vals = ell_op.fwd.cols[0], ell_op.fwd.vals[0]
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 7)
        a = torch.randn(cs.BUCKET, cs.FEATURES, device=device, generator=gen).to(torch.bfloat16)
        b = torch.randn(cs.BUCKET, cs.FEATURES, device=device, generator=gen).to(torch.bfloat16)
        fn = torch.nn.functional.normalize(a.float(), dim=-1).to(torch.bfloat16)
        out = torch.empty(cs.BUCKET, cols.shape[1], device=device, dtype=torch.bfloat16)
        nnz = int((vals != 0).sum())
        bound = dict(zip(("bound_ms", "bound_by"), cs.bound_ms(cs.nbytes(cols, vals, a, b, out), 2 * nnz * cs.FEATURES)))
        flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device=device)
        times = {k: {} for k in fns}
        for _ in range(2):
            for k, f in fns.items():
                row = times[k]
                row.setdefault("ms", []).append(cs.time_ms(lambda f=f: _call(f, cols, vals, a, b)))
                row.setdefault("cold_ms", []).append(cs.cold_ms(lambda f=f: _call(f, cols, vals, a, b), flush))
                row.setdefault("ms_a_is_b", []).append(cs.time_ms(lambda f=f: _call(f, cols, vals, fn, fn)))
        del flush
        for k, row in times.items():
            cs.log(f"  {k} build at R=N={cs.BUCKET} K={cols.shape[1]} C={cs.FEATURES}: warm {row['ms']} ms, cold "
                   f"{row['cold_ms']} ms, a is b {row['ms_a_is_b']} ms; bound {bound['bound_ms']:.5f} ms by "
                   f"{bound['bound_by']} ({smi})")
        result = {"card": smi, "against": args.against, "bit_identical_cases": list(shapes),
                  "max_abs_err": worst, "times": times, "bound": bound, "registers": regs}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
