"""Time the parts of the bf16 ``bsr_matmul`` kernel's design one by one on one CUDA card.

    python3 bsr_bf16_sweep.py [--tiles 64 128] [--stages 2 3 4 6 8 10] [--out FILE]

``surfacenetworks_tpu_torch/sparse/csrc/spmm.cu`` is built once for each
channel tile (``-DSNX_BF_TILE_N``: 64 or 128 channels per CTA) and ring depth
(``-DSNX_BF_STAGES``), every ``nvcc`` started together, beside the port's own
build (64 channels, 6 stages).  The operand is ``chip_smoke.py``'s bf16 BSR
operator (a ~7,000-vertex mesh Laplacian in 128x128 bf16 blocks, NB=55,
KB=5) at C=128.  The port's build is held against the plain version, and
every variant's result, on bf16 and on fp32 x, with and without the
operator's live-chunk mask, must equal the port's build bit for bit.  Then
each variant is timed warm and with a cold L2, in two rounds.  Three parts
of the design are thereby apart: the ring's depth (the stages at one
tile), the tiling (64 against 128 channels at the same depth), and the
skip of dead chunks (with against without the mask).  The script also
logs the live chunks that each CTA (a 64-row half block-row) takes, and
each variant's registers and spills.

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

import numpy as np

import chip_smoke as cs

PORT_TILE, PORT_STAGES = 64, 6  # spmm.cu's defaults, which the port builds


def _build_variants(variants: list[tuple[int, int]], out_dir: Path) -> dict:
    """Start one ``nvcc`` per (tile, stages) variant, build the port's own
    library meanwhile, and wait for all; returns ``{variant: (path,
    ptxas report)}`` with the port's build under ``(PORT_TILE,
    PORT_STAGES)``."""
    from surfacenetworks_tpu_torch.sparse import _build

    procs = {}
    for tile, stages in variants:
        lib = out_dir / f"libsnx_spmm_t{tile}_s{stages}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DSNX_BF_TILE_N={tile}", f"-DSNX_BF_STAGES={stages}",
               "-o", str(lib), str(_build.SOURCE)]
        procs[(tile, stages)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                        text=True))
    t0 = time.perf_counter()
    built = {}
    try:
        _build.load()
        built[(PORT_TILE, PORT_STAGES)] = (Path(_build.build_info["path"]), _build.build_info.get("log", ""))
        for key, (lib, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for tile {key[0]}, {key[1]} stages:\n{err}")
            built[key] = (lib, err + out)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cs.log(f"  {len(procs) + 1} builds in {time.perf_counter() - t0:.2f} s")
    return built


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.snx_bsr_spmm_bf16
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    return fn


def _caller(fn, bcols, bvals, x, live):
    """A call of one variant's ``snx_bsr_spmm_bf16`` on [NB, KB] blocks and
    [N, C] x (16-byte aligned, C % 8 == 0), as ``kernels.bsr_matmul`` makes
    it, with its output allocated once."""
    import torch

    nb, kb = bcols.shape
    n, c = x.shape
    out = torch.empty(nb * 128, c, device=x.device, dtype=torch.float32)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    args = (bcols.data_ptr(), bvals.data_ptr(), None if live is None else live.data_ptr(), x.data_ptr(),
            out.data_ptr(), 1, nb, kb, n, c, int(x.dtype == torch.bfloat16), 1, stream)

    def call():
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"snx_bsr_spmm_bf16 failed with cudaError {code}")
        return out

    return call


def per_cta_chunks(bcols, live, n_blocks: int) -> dict:
    """Depth chunks that each CTA (block-row i, half h) multiplies: with the
    mask its live ones, without it four per slot of an in-range column."""
    import torch

    bits = live.to(torch.int32)
    with_mask = torch.stack([sum(((bits >> (4 * h + d)) & 1).sum(dim=1) for d in range(4)) for h in range(2)])
    in_range = ((bcols >= 0) & (bcols < n_blocks)).sum(dim=1)
    every = torch.stack([4 * in_range, 4 * in_range])
    out = {}
    for name, t in (("live", with_mask), ("every", every)):
        v = np.sort(t.flatten().cpu().numpy())
        out[name] = {"min": int(v[0]), "median": float(np.median(v)), "max": int(v[-1]), "sum": int(v.sum()),
                     "histogram": {int(k): int(n) for k, n in zip(*np.unique(v, return_counts=True))}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[64, 128], choices=[64, 128])
    ap.add_argument("--stages", type=int, nargs="+", default=[2, 3, 4, 6, 8, 10])
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bsr_bf16_sweep: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 1
    from surfacenetworks_tpu_torch.sparse import _build, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    device = torch.device("cuda", 0)
    variants = sorted({(t, s) for t in args.tiles for s in args.stages} | {(PORT_TILE, PORT_STAGES)})
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="sweep_", dir=_build.BUILD_DIR))
    try:
        built = _build_variants([v for v in variants if v != (PORT_TILE, PORT_STAGES)], tmp)
        fns, regs = {}, {}
        for key, (path, report) in built.items():
            fns[key] = _bind(path)
            regs[key] = {k: v for k, v in cs.ptxas_report(report).items() if k.startswith("bsr_spmm_bf16_kernel")}
            if any(v.get("spill_stores") or v.get("spill_loads") for v in regs[key].values()):
                raise AssertionError(f"tile {key[0]}, {key[1]} stages spills: {regs[key]}")

        _, _, bsr_op = cs.bf16_operands(device)
        bcols, bvals, blive = bsr_op.fwd.block_cols[0], bsr_op.fwd.block_vals[0], bsr_op.fwd_live[0]
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 11)
        xs = {"bf16": torch.randn(cs.BUCKET, cs.WIDTH, device=device, generator=gen).to(torch.bfloat16)}
        xs["fp32"] = torch.randn(cs.BUCKET, cs.WIDTH, device=device, generator=gen)
        masks = {"live": blive, "every": None}
        port = (PORT_TILE, PORT_STAGES)
        ref = {}
        for xname, x in xs.items():
            scale = kernels.bsr_matmul_plain(bcols, bvals.double().abs(), x.to(torch.bfloat16).double().abs())
            for mname, m in masks.items():
                ref[xname, mname] = _caller(fns[port], bcols, bvals, x, m)().clone()
                cs.check(f"port build, {xname} x, {mname} chunks", ref[xname, mname],
                         kernels.bsr_matmul_plain(bcols, bvals, x), scale, cs.KERNEL_RTOL)
        for key in variants:
            for (xname, mname), r in ref.items():
                got = _caller(fns[key], bcols, bvals, xs[xname], masks[mname])()
                if not torch.equal(got, r):
                    raise AssertionError(f"tile {key[0]}, {key[1]} stages, {xname} x, {mname} chunks: "
                                         f"differs from the port's build")
        cs.log(f"  every variant equals the port's build bit for bit ({len(variants)} variants x 2 x dtypes x "
               f"with and without the mask)")

        out = torch.empty(cs.BUCKET, cs.WIDTH, device=device)
        work = {}
        for xname, x in xs.items():
            live_bytes, live_flops = cs.bsr_live_work(bcols, bvals, blive, x, out)
            nnzb = int((bvals != 0).flatten(2).any(dim=2).sum())
            work[xname] = {
                "live": dict(zip(("bound_ms", "bound_by"), cs.bound_ms(live_bytes, live_flops,
                                                                      cs.BF16_TENSOR_FLOP_PER_S)),
                             bytes=live_bytes, flops=live_flops),
                "every": dict(zip(("bound_ms", "bound_by"), cs.bound_ms(cs.nbytes(bcols, bvals, x, out),
                                                                       2 * nnzb * 128 * 128 * cs.WIDTH,
                                                                       cs.BF16_TENSOR_FLOP_PER_S)),
                              bytes=cs.nbytes(bcols, bvals, x, out), flops=2 * nnzb * 128 * 128 * cs.WIDTH)}
        chunks = per_cta_chunks(bcols, blive, cs.BUCKET // 128)
        cs.log(f"  live chunks per CTA: {chunks['live']}; without the mask: {chunks['every']}")

        flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device=device)
        rounds = 2
        times = {f"t{t}_s{s}": {} for t, s in variants}
        for rnd in range(rounds):
            for key in variants:
                row = times[f"t{key[0]}_s{key[1]}"]
                for xname, x in xs.items():
                    for mname, m in masks.items():
                        call = _caller(fns[key], bcols, bvals, x, m)
                        row.setdefault(f"{xname}_{mname}_ms", []).append(cs.time_ms(call))
                        row.setdefault(f"{xname}_{mname}_cold_ms", []).append(cs.cold_ms(call, flush))
        del flush
        for (t, s), row in zip(variants, times.values()):
            a = row["bf16_live_ms"]
            share = work["bf16"]["live"]["bound_ms"] / min(a)
            cs.log(f"  tile {t}, {s} stages: bf16 x {a} ms (mask; {share:.1%} of its bound), "
                   f"{row['bf16_every_ms']} (every chunk), fp32 x {row['fp32_live_ms']} / {row['fp32_every_ms']}; "
                   f"cold bf16 x {row['bf16_live_cold_ms']} / {row['bf16_every_cold_ms']}")
        # bytes the CTAs ask of L2: each channel tile reads its half block-row's chunks again
        l2 = {f"t{t}": {"block_bytes": chunks["live"]["sum"] * 64 * 32 * 2 * (cs.WIDTH // t),
                        "x_bytes_bf16": chunks["live"]["sum"] * 32 * cs.WIDTH * 2,
                        "ctas": (cs.WIDTH // t) * 2 * bcols.shape[0]} for t in args.tiles}
        result = {"card": smi, "shape": {"nb": bcols.shape[0], "kb": bcols.shape[1], "n": cs.BUCKET, "c": cs.WIDTH},
                  "port": {"tile": PORT_TILE, "stages": PORT_STAGES}, "times": times, "work": work,
                  "chunks_per_cta": chunks, "l2_requests": l2,
                  "registers": {f"t{t}_s{s}": regs[(t, s)] for t, s in variants}}
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
