"""Meta-launcher: compose and run a trainer's command (counterpart of
``surfacenetworks_tpu/cli/launch.py``, the reference's ``run_normal.py:8-37``).

Selects the task's trainer in this package, folds the high-level options
into its flags (a ``--preset`` among them) and runs it in a subprocess.
``--platform cpu`` passes ``--device cpu`` to the trainer (it runs on the
card otherwise), and ``--devices`` sets ``CUDA_VISIBLE_DEVICES``::

    python -m surfacenetworks_tpu_torch.cli.launch --task normal --model lap \\
        --layer 15 --preset normal-lap --dry-run
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

TASKS = {
    "normal": "surfacenetworks_tpu_torch.cli.train_normal",
    "mnist": "surfacenetworks_tpu_torch.cli.train_mnist",
    "vae": "surfacenetworks_tpu_torch.cli.train_vae",
    "arap": "surfacenetworks_tpu_torch.cli.train_arap",
    "correspondence": "surfacenetworks_tpu_torch.cli.train_correspondence",
}

parser = argparse.ArgumentParser(description="Surface Networks launcher (PyTorch)")
parser.add_argument("--task", default="normal", choices=sorted(TASKS))
parser.add_argument("--model", default="lap")
parser.add_argument("--layer", type=int, default=None)
parser.add_argument("--batch-size", type=int, default=None)
parser.add_argument("--lr", type=float, default=None)
parser.add_argument("--preset", default=None)
parser.add_argument("--config", default=None)
parser.add_argument("--platform", default=None, help="cpu runs the trainer with --device cpu (default: the card)")
parser.add_argument("--devices", default=None, help="visible device ids, comma separated (CUDA_VISIBLE_DEVICES)")
parser.add_argument("--dry-run", action="store_true", help="print the command, do not run")
parser.add_argument("rest", nargs=argparse.REMAINDER, help="extra flags passed through (after --)")


def build_command(args) -> tuple[list[str], dict]:
    cmd = [sys.executable, "-m", TASKS[args.task]]
    prefix_parts = [args.task, args.model]
    for flag in ["model", "layer", "batch_size", "lr", "preset", "config"]:
        val = getattr(args, flag)
        if val is not None:
            cmd += [f"--{flag.replace('_', '-')}", str(val)]
            if flag in ("layer",):
                prefix_parts.append(str(val))
    rest = [a for a in args.rest if a != "--"]
    if not any(a.startswith("--result-prefix") for a in rest):
        cmd += ["--result-prefix", "_".join(prefix_parts)]
    if args.platform == "cpu" and not any(a.startswith("--device") for a in rest):
        cmd += ["--device", "cpu"]
    cmd += rest
    env = dict(os.environ)
    if args.devices:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    return cmd, env


def main(argv=None):
    args = parser.parse_args(argv)
    if args.platform not in (None, "cpu", "cuda"):
        raise SystemExit(f"--platform {args.platform}: the PyTorch port runs on cuda (default) or cpu")
    cmd, env = build_command(args)
    print(" ".join(cmd))
    if args.dry_run:
        return 0
    return subprocess.run(cmd, env=env).returncode


if __name__ == "__main__":
    raise SystemExit(main())
