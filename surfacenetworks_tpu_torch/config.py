"""Per-task presets and JSON run configs (counterpart of
``surfacenetworks_tpu/config.py``, copied so that the port imports nothing of
the JAX package).

* every trainer accepts ``--config run.json`` and/or ``--preset NAME``;
* values resolve as: parser defaults < preset < JSON file < explicit flags;
* keys a task does not know exit with the JAX package's message;
* ``dump_config(args, path)`` records the resolved run config beside the
  checkpoints.

The presets are the reference's default configurations (BASELINE.md).  Two
differences from the JAX package: a preset or file value that the task's
parser restricts by ``choices`` is checked against them as a flag would be
(argparse does not check defaults), so ``--preset arap-dirac`` stops in the
ARAP parser, whose models have no ``dirac`` (the JAX trainer stops later,
at its model table); and the parser's defaults are put back after the parse,
so a second call in the same process starts from the parser's own.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any

# Per-task presets: the reference's shipped default configurations.
PRESETS: dict[str, dict[str, Any]] = {
    # run_normal.py:9-29 + train_4_normal.py defaults
    "normal-lap": {
        "model": "lap", "layer": 15, "batch_size": 32, "num_updates": 1250,
        "num_epoch": 300, "lr": 1e-3, "half_lr": 20, "optimizer": "adam",
    },
    "normal-dirac": {
        "model": "dirac", "layer": 15, "batch_size": 32, "num_updates": 1250,
        "num_epoch": 300, "lr": 1e-3, "half_lr": 20, "optimizer": "adam",
    },
    # mesh_mnist/models.py:27-35, main.py:41
    "mnist-lap": {"model": "lap", "batch_size": 64, "num_epoch": 100, "lr": 1e-3},
    "mnist-dirac": {"model": "dirac", "batch_size": 64, "num_epoch": 100, "lr": 1e-3},
    # mesh_mnist/models_vae.py:26-36, main_vae.py
    "vae-lap": {"model": "lap", "batch_size": 64, "num_epoch": 100, "lr": 1e-3,
                "latent": 100, "kld_warmup": 10},
    # as_rigid_as_possible/main.py:38-53
    "arap-lap": {"model": "lap", "layer": 15, "batch_size": 32, "num_updates": 1000,
                 "num_epoch": 110, "lr": 1e-3},
    "arap-dirac": {"model": "dirac", "layer": 15, "batch_size": 32,
                   "num_updates": 1000, "num_epoch": 110, "lr": 1e-3},
    # dense_correspondence/main.py:40-53
    "faust-lap": {"model": "lap", "layer": 15, "batch_size": 1, "num_epoch": 100,
                  "lr": 1e-3, "loss": "dcel"},
    "faust-dirac": {"model": "dirac", "layer": 15, "batch_size": 1,
                    "num_epoch": 100, "lr": 1e-3, "loss": "dcel"},
}


def add_config_flags(parser: argparse.ArgumentParser) -> None:
    """Attach ``--config`` / ``--preset`` to a task parser."""
    parser.add_argument("--config", default=None, help="JSON config file")
    parser.add_argument(
        "--preset", default=None, choices=sorted(PRESETS), help="named default config"
    )


def parse_with_config(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse argv with preset/json-file layered under explicit flags.

    Pre-parses ``--config``/``--preset``, folds their values into the parser
    defaults (json keys use the dest naming, ``_`` for ``-``), then parses
    the full argv so explicit flags win.
    """
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    pre.add_argument("--preset", default=None)
    known, _ = pre.parse_known_args(argv)
    layered: dict[str, Any] = {}
    if known.preset:
        if known.preset not in PRESETS:  # the full parse names the choices
            return parser.parse_args(argv)
        layered.update(PRESETS[known.preset])
    if known.config:
        with open(known.config) as fp:
            layered.update(json.load(fp))
    actions = {a.dest: a for a in parser._actions}
    unknown = set(layered) - set(actions)
    if unknown:
        raise SystemExit(f"config keys not recognized by this task: {sorted(unknown)}")
    for key, value in layered.items():
        choices = actions[key].choices
        if choices is not None and value not in choices:
            parser.error(f"argument --{key.replace('_', '-')}: invalid choice: {value!r} "
                         f"(choose from {', '.join(map(repr, choices))})")
    saved = {k: actions[k].default for k in layered}
    parser.set_defaults(**layered)
    try:
        return parser.parse_args(argv)
    finally:
        # a trainer's parser is a module global that later calls parse
        # again: take the layer back off
        parser.set_defaults(**saved)


def dump_config(args: argparse.Namespace, path: str) -> None:
    """Write the fully-resolved run config as JSON (reproducibility artifact)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {k: v for k, v in vars(args).items() if not k.startswith("_")}
    with open(path, "w") as fp:
        json.dump(payload, fp, indent=2, default=str)
