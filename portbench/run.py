"""Run one cell of the benchmark once on the card and print its result as
the last line of standard output::

    python3 portbench/run.py --workload lap15-normal-b32 --seed 7 --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  The run fails, printing no
result, where no CUDA card is found, where the program is missing, or where
JAX or the JAX package was loaded.  Every number compared for ``correct``
is printed beside its limit as the last lines of standard error.
"""

import time

T0 = time.perf_counter()  # set-up counts from here: before the imports

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# kernel caches at fixed paths inside the checkout, so a second run finds what the first built
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import bench

    cell = bench.load_cell(ROOT, args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    banned = bench.banned_modules()
    if banned:
        print(f"no result: loaded {banned}", file=sys.stderr)
        return 4
    for name, c in result.compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
