"""Checkpoints (counterpart of ``surfacenetworks_tpu/train/checkpoint.py`` and
``train/loop.py::check_finite``).

The port writes its own checkpoints with ``torch.save``: ``{"params":
model.state_dict(), "opt_state": optimizer.state_dict(), "epoch", "step"}``.
It also reads the JAX package's files, which ``flax.serialization.
msgpack_serialize`` wrote, through ``load_flax_msgpack``: a decoder of the
subset of msgpack that flax writes for a checkpoint (maps with str keys,
ints, floats, bools, nil, ext 1 = ndarray ``(shape, dtype name, bytes)``,
ext 3 = numpy scalar), with no import of flax or msgpack.  Anything else
raises, flax's chunked form of arrays over its chunk size included.

``restore_training`` takes either file.  A parameter keeps its initialised
value where the file lacks its key or holds another shape
(``fuzzy_restore``); the optimizer's state is loaded only where its
structure fits the optimizer's; ``step`` is the trainer's update count
(``TrainState.step`` in the JAX package), 0 where the file has none.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

from surfacenetworks_tpu_torch import convert

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Decoder of flax's msgpack subset over one ``bytes`` buffer."""

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}  # str 8/16/32
        if b in sizes:
            return self.take(self.unpack(sizes[b])).decode()
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sizes:
            return self.take(self.unpack(sizes[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8/16/32
        if b in sizes:
            n = self.unpack(sizes[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"msgpack: type byte 0x{b:02x} is not in flax's checkpoint subset")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"msgpack: map key {key!r} is not a str")
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("msgpack: flax's chunked array form (arrays over 1 GiB) is not supported")
        return out


def _ext(code: int, data: bytes):
    """flax's ext types: 1 an ndarray, 3 a numpy scalar, each packed as
    ``(shape, dtype name, C-order bytes)``."""
    if code not in (1, 3):
        raise ValueError(f"msgpack: ext type {code} is not in flax's checkpoint subset")
    r = _Reader(data)
    shape, dtype_name, raw = r.value()
    if r.pos != len(data) or not isinstance(raw, bytes):
        raise ValueError("msgpack: malformed ndarray payload")
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()
    return arr[()] if code == 3 else arr


def decode_flax_msgpack(buf: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns for ``buf``."""
    r = _Reader(buf)
    out = r.value()
    if r.pos != len(buf):
        raise ValueError("msgpack: trailing bytes after the top-level value")
    return out


def load_flax_msgpack(path: str) -> dict:
    with open(path, "rb") as fh:
        return decode_flax_msgpack(fh.read())


def save_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer | None = None,
                    epoch: int = 0, step: int = 0) -> None:
    """The port's checkpoint: parameters, optimizer state, epoch and step."""
    payload = {"params": model.state_dict(), "epoch": int(epoch), "step": int(step)}
    if optimizer is not None:
        payload["opt_state"] = optimizer.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def load_checkpoint(path: str) -> dict:
    """A checkpoint of either package: the port's (a ``torch.save`` zip) as
    saved, the JAX package's as ``{"params": flax tree, "opt_state": optax
    state tree, "epoch", "step"}``, with a ``"format"`` of ``"torch"`` or
    ``"flax"``."""
    with open(path, "rb") as fh:
        is_zip = fh.read(4) == b"PK\x03\x04"  # torch.save's container; flax files open with a map
    if is_zip:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return {**ckpt, "format": "torch"}
    return {**load_flax_msgpack(path), "format": "flax"}


def fuzzy_restore(model: torch.nn.Module, loaded: dict[str, torch.Tensor]) -> list[str]:
    """Copy into ``model`` each entry of ``loaded`` (a ``state_dict``) whose
    key the model has with the same shape; the others keep their values.
    Returns the model's keys left as they were."""
    own = model.state_dict()
    kept = []
    with torch.no_grad():
        for k, v in own.items():
            src = loaded.get(k)
            if src is not None and tuple(src.shape) == tuple(v.shape):
                v.copy_(torch.as_tensor(src))
            else:
                kept.append(k)
    return kept


def _state_fits(optimizer: torch.optim.Optimizer, sd: dict) -> bool:
    """Whether ``sd`` (an optimizer ``state_dict``) has this optimizer's
    groups, parameters, per-parameter state keys and shapes."""
    groups = optimizer.param_groups
    if len(sd.get("param_groups", ())) != len(groups):
        return False
    params = []
    for g, sg in zip(groups, sd["param_groups"]):
        if len(g["params"]) != len(sg["params"]) or ("schedule_count" in g) != ("schedule_count" in sg):
            return False
        params += list(zip(g["params"], sg["params"]))
    want = convert.OPT_STATE_KEYS.get(type(optimizer).__name__)
    for p, idx in params:
        st = sd["state"].get(idx)
        if st is None:
            continue
        if want is not None and set(st) != want:
            return False
        if any(torch.is_tensor(v) and v.dim() > 0 and tuple(v.shape) != tuple(p.shape) for v in st.values()):
            return False
    return True


def restore_training(path: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer | None = None) -> tuple[int, int, bool]:
    """Restore ``model`` (fuzzily) and, where it fits, ``optimizer`` from a
    checkpoint of either package.  Returns ``(epoch, step, optimizer
    loaded)``."""
    ckpt = load_checkpoint(path)
    if ckpt["format"] == "flax":
        params = convert.params_from_flax(ckpt["params"])
    else:
        params = ckpt["params"]
    fuzzy_restore(model, params)
    epoch, step = int(ckpt.get("epoch", 0)), int(ckpt.get("step", 0))
    loaded = False
    if optimizer is not None and "opt_state" in ckpt:
        sd = ckpt["opt_state"]
        if ckpt["format"] == "flax":
            sd = convert.optimizer_state_from_optax(sd, model, optimizer)
        if sd is not None and _state_fits(optimizer, sd):
            optimizer.load_state_dict(sd)
            loaded = True
    return epoch, step, loaded


def check_finite(metrics: dict, context: str = "") -> None:
    """Raise ``FloatingPointError`` if any metric is not finite."""
    for k, v in metrics.items():
        if not bool(torch.isfinite(torch.as_tensor(v)).all()):
            raise FloatingPointError(f"non-finite metric {k}={v} {context}")
