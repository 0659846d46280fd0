"""Flax parameters and optax optimizer state -> PyTorch.

The JAX package stores parameters as nested dicts (what
``flax.serialization.msgpack_restore`` returns for a checkpoint's
``["params"]``).  A Dense ``kernel [in, out]`` becomes a Linear
``weight [out, in]``; Dense and BatchNorm ``bias`` stay ``bias``; BatchNorm
``scale`` becomes ``weight``.  ``optimizer_state_from_optax`` maps a
checkpoint's ``["opt_state"]`` onto the port's optimizer ``state_dict``.
The port never imports flax: ``train.checkpoint`` decodes the file.
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


# Per-parameter state keys of the port's optimizers (``train/optim.py``).
OPT_STATE_KEYS = {
    "Adam": {"step", "exp_avg", "exp_avg_sq"},
    "Amsgrad": {"step", "exp_avg", "exp_avg_sq", "nu_max"},
    "SGD": {"momentum_buffer"},
}
# optax moment fields -> the port's state keys, per optimizer
_OPTAX_FIELDS = {
    "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "Amsgrad": {"mu": "exp_avg", "nu": "exp_avg_sq", "nu_max": "nu_max"},
    "SGD": {"trace": "momentum_buffer"},
}


def optimizer_state_from_optax(tree: Mapping, model: nn.Module, optimizer: torch.optim.Optimizer) -> dict | None:
    """An optax state tree, as the JAX package's checkpoints hold it, as
    ``optimizer.state_dict()`` would hold it; None where its structure does
    not fit the optimizer's.

    The trees the JAX package's ``train/optim.py`` builds, with ``{}`` for an
    empty state: ``adam``/``amsgrad``/``sgd`` give ``{"0": moments, "1":
    lr}``, and with weight decay ``{"0": {}, "1": {"0": moments, "1": lr}}``
    (``chain(add_decayed_weights, ...)``).  ``moments`` is optax's
    ``ScaleByAdamState`` (``count, mu, nu``), ``ScaleByAmsgradState`` (and
    ``nu_max``) or ``TraceState`` (``trace``); ``lr`` is ``{}`` for a
    constant rate, ``{"count"}`` for a schedule.  ``count`` becomes each
    parameter's ``step``, the schedule's count each group's
    ``schedule_count``; moment trees convert as the parameters do (Dense
    kernels transposed)."""
    kind = type(optimizer).__name__
    fields = _OPTAX_FIELDS.get(kind)
    if fields is None or len(optimizer.param_groups) != 1:
        return None
    group = optimizer.param_groups[0]
    node = tree
    if group["weight_decay"]:
        if not isinstance(node, Mapping) or set(node) != {"0", "1"} or node["0"] != {}:
            return None
        node = node["1"]
    if not isinstance(node, Mapping) or set(node) != {"0", "1"}:
        return None
    moments, lr = node["0"], node["1"]
    want = set(fields) | ({"count"} if kind != "SGD" else set())
    scheduled = "schedule_count" in group
    if not isinstance(moments, Mapping) or set(moments) != want or set(lr) != ({"count"} if scheduled else set()):
        return None
    try:
        converted = {key: params_from_flax(moments[f], like=model) for f, key in fields.items()}
    except (KeyError, ValueError):
        return None
    names = {id(p): n for n, p in model.named_parameters()}
    state = {}
    for i, p in enumerate(group["params"]):
        st = {k: v[names[id(p)]] for k, v in converted.items()}
        if kind != "SGD":
            st["step"] = torch.tensor(float(np.asarray(moments["count"])), dtype=torch.float32)
        state[i] = st
    groups = optimizer.state_dict()["param_groups"]
    if scheduled:
        groups[0]["schedule_count"] = int(np.asarray(lr["count"]))
    return {"state": state, "param_groups": groups}
