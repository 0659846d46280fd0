"""Flax parameters -> PyTorch ``state_dict``.

The JAX package stores parameters as nested dicts (what
``flax.serialization.msgpack_restore`` returns for a checkpoint's
``["params"]``).  A Dense ``kernel [in, out]`` becomes a Linear
``weight [out, in]``; Dense and BatchNorm ``bias`` stay ``bias``; BatchNorm
``scale`` becomes ``weight``.  The port never imports flax: the caller
decodes the checkpoint.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def params_from_flax(tree: Mapping, like: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Convert a flax params tree into a ``state_dict``.

    With ``like``, the keys and shapes must match ``like.state_dict()``
    exactly: a missing or surplus key, or a shape that differs, raises.
    """
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{name}.")
                continue
            arr = np.asarray(val, dtype=np.float32)
            if name == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"{prefix}kernel: expected a Dense kernel [in, out], got {arr.shape}")
                key, arr = "weight", arr.T
            elif name == "scale":
                key = "weight"
            elif name == "bias":
                key = "bias"
            else:
                raise KeyError(f"unknown flax leaf {prefix}{name}")
            out[prefix + key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))

    walk(tree, "")
    if like is not None:
        want = like.state_dict()
        missing = sorted(set(want) - set(out))
        surplus = sorted(set(out) - set(want))
        if missing or surplus:
            raise KeyError(f"flax params do not match the module: missing {missing}, surplus {surplus}")
        for k, v in want.items():
            if tuple(v.shape) != tuple(out[k].shape):
                raise ValueError(f"{k}: flax shape {tuple(out[k].shape)} != module shape {tuple(v.shape)}")
    return out
