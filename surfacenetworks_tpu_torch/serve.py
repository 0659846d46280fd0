"""Serving normal prediction (counterpart of ``surfacenetworks_tpu/serve.py``).

Two ways.  ``export_forward`` / ``load`` / ``export_info`` follow the JAX
package's contract: a model's forward on one bucketed operator is exported
once (``torch.export``) to bytes and served from them::

    blob = serve.export_forward(model, state, operator, mask, example_inputs)
    fn = serve.load(blob)
    out = fn(inputs)          # [B, N, Cin] -> [B, N, Cout]

The operator (and mask) are baked into the artifact by default; with
``bake_operator=False`` they are runtime arguments, ``fn(inputs, mask,
*operator leaves)`` (``operator_leaves``).  ``cli/export_model.py`` writes
such artifacts for the Lap and Dirac models.  ``NormalServer`` serves the
``nn.Module`` directly: it holds LapDeepModel on the card and answers
requests, each one mesh ``(V [n,3], F [m,3])``, with per-vertex outputs
``[n,3]`` in the request's own vertex order::

    server = NormalServer(model, state_dict, device="cuda", fmt="bsr")
    normals = server.serve([(V, F), ...])   # list of [n, 3] arrays
    server.device_ms                         # device time of each request

Per request the host builds the igl-style Laplacian (``hack=1.0``), for
``"bsr"`` RCM-reorders the vertices (and un-permutes the answer), pads to a
bucket of a multiple of 128 rows with mask ``[1, N, 1]``, packs the operator
and copies it to the device once.  Every request's operator is built before
the first forward, so the device times cover the forward alone.  Batch norm
uses batch statistics over all rows, padding included, as the reference
does, so each request is its own batch of one.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Any, Callable, Iterable

import numpy as np
import torch

from surfacenetworks_tpu_torch.data.batching import (
    Buckets,
    fit_bsr_k,
    laplacian_batch,
    rcm_reorder_sample,
    round_up,
)
from surfacenetworks_tpu_torch.geometry import igl_style_laplacian
from surfacenetworks_tpu_torch.sparse import kernels

ROW_MULTIPLE = 128


@dataclasses.dataclass
class PreparedRequest:
    """A request with its operator, mask and inputs on the server's device."""

    n: int
    operator: Any
    mask: torch.Tensor  # [1, N, 1]
    inputs: torch.Tensor  # [1, N, 3]
    perm: np.ndarray | None = None  # RCM order: padded row i holds vertex perm[i]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``cuda`` unless the caller names another device; raise rather than
    fall back to the CPU when CUDA is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class NormalServer:
    """LapDeepModel serving on one device with the ELL or BSR operator format.

    ``state_dict`` (for instance from ``convert.params_from_flax``), when
    given, replaces ``model``'s weights.  ``bucket`` fixes the padded row
    count (a multiple of 128) for every request that fits in it.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        state_dict: dict | None = None,
        device: str | torch.device | None = None,
        fmt: str = "ell",
        bucket: int = 0,
    ):
        self.device = resolve_device(device)
        if fmt not in ("ell", "bsr"):
            raise ValueError(f"operator format {fmt!r}: expected 'ell' or 'bsr'")
        if bucket % ROW_MULTIPLE:
            raise ValueError(f"bucket={bucket} is not a multiple of {ROW_MULTIPLE}")
        # the model is fp32 throughout: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.fmt = fmt
        self.bucket = bucket
        self.device_ms: list[float] = []  # per request of the last serve() on a card

    def prepare(self, V: np.ndarray, F: np.ndarray) -> PreparedRequest:
        """Build, pack and place one request's operator (host side)."""
        V = np.asarray(V, dtype=np.float64)
        F = np.asarray(F, dtype=np.int32)
        n = V.shape[0]
        sample = {
            "V": V.astype(np.float32),
            "F": F,
            "input": V.astype(np.float32),
            "L": igl_style_laplacian(V, F, hack=1.0),
        }
        buckets = Buckets(n_vertices=max(round_up(n, ROW_MULTIPLE), self.bucket))
        perm = None
        if self.fmt == "bsr":
            sample = rcm_reorder_sample(sample)
            perm = sample["rcm_perm"]
            fit_bsr_k([sample], buckets)
        batch = laplacian_batch([sample], buckets, target_key="input", fmt=self.fmt)
        return PreparedRequest(
            n=n,
            operator=batch.operator.to(self.device),
            mask=batch.mask.to(self.device),
            inputs=batch.inputs.to(self.device),
            perm=perm,
        )

    def answer(self, req: PreparedRequest) -> np.ndarray:
        """Run the forward for one prepared request; ``[n, 3]`` in the
        request's vertex order.  On a card, appends the forward's device
        time (CUDA events) to ``device_ms``."""
        on_card = self.device.type == "cuda"
        with torch.inference_mode():
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            out = self.model(req.operator, req.mask, req.inputs)
            if on_card:
                end.record()
                end.synchronize()
                self.device_ms.append(start.elapsed_time(end))
            rows = out[0, : req.n].float().cpu().numpy()
        if req.perm is None:
            return rows
        result = np.empty_like(rows)
        result[req.perm] = rows
        return result

    def serve(self, meshes: Iterable[tuple[np.ndarray, np.ndarray]]) -> list[np.ndarray]:
        """Answer each ``(V, F)`` request; every operator is built before the
        first forward runs."""
        reqs = [self.prepare(V, F) for V, F in meshes]
        self.device_ms = []
        return [self.answer(r) for r in reqs]


# ---------------------------------------------------------------------------
# exported artifacts (the JAX package's export_forward / load / export_info)
# ---------------------------------------------------------------------------

_META = "snx_meta.json"  # the artifact's own metadata, beside the program


def operator_leaves(operator: Any) -> tuple[list[torch.Tensor], Any]:
    """An operator's tensors in the order JAX's ``tree_flatten`` gives its
    ``EllOperator``/``BsrOperator``/``DiracOperator`` (fields in order,
    nested, None skipped; ints static), the port's own fields last (the
    BSR live-chunk masks, the Dirac overflow map); and the structure that
    ``operator_from_leaves`` rebuilds it from."""
    leaves: list[torch.Tensor] = []

    def spec(o):
        if isinstance(o, torch.Tensor):
            leaves.append(o)
            return ("leaf",)
        if dataclasses.is_dataclass(o):
            return ("dataclass", type(o), [(f.name, spec(getattr(o, f.name))) for f in dataclasses.fields(o)])
        if isinstance(o, (tuple, list)):
            return ("seq", type(o), [spec(x) for x in o])
        return ("const", o)  # None, ints

    return leaves, spec(operator)


def operator_from_leaves(structure: Any, leaves) -> Any:
    """Inverse of ``operator_leaves``."""
    it = iter(leaves)

    def build(sp):
        kind = sp[0]
        if kind == "leaf":
            return next(it)
        if kind == "dataclass":
            return sp[1](**{name: build(sub) for name, sub in sp[2]})
        if kind == "seq":
            return sp[1](build(sub) for sub in sp[2])
        return sp[1]

    return build(structure)


class _Forward(torch.nn.Module):
    """``model(operator, mask, inputs)`` with the operator and mask baked in
    as buffers, or taken as ``forward(inputs, mask, *leaves)``."""

    def __init__(self, model: torch.nn.Module, structure: Any, leaves: list, mask: torch.Tensor | None):
        super().__init__()
        self.model, self.structure = model, structure
        self.n_leaves = len(leaves)
        self.baked = mask is not None
        if self.baked:
            self.register_buffer("mask", mask)
            for i, t in enumerate(leaves):
                self.register_buffer(f"op_{i}", t)

    def forward(self, inputs, *runtime):
        if self.baked:
            mask, leaves = self.mask, [getattr(self, f"op_{i}") for i in range(self.n_leaves)]
        else:
            mask, leaves = runtime[0], runtime[1:]
        return self.model(operator_from_leaves(self.structure, leaves), mask, inputs)


def _aval(t) -> str:
    return f"{str(t.dtype).replace('torch.', '')}[{','.join(str(int(d)) for d in t.shape)}]"


def export_forward(model: torch.nn.Module, state: dict | None, operator: Any, mask, example_inputs,
                   bake_operator: bool = True, platforms: tuple[str, ...] | None = None) -> bytes:
    """``model(operator, mask, inputs)`` exported (``torch.export``) and
    serialised (``torch.export.save``) to bytes.

    ``state`` (a ``state_dict``, e.g. from ``convert.params_from_flax`` or a
    checkpoint), when given, replaces the model's weights.
    ``example_inputs`` fixes the served bucket ``[B, N, Cin]``.  With
    ``bake_operator`` the operator and ``mask`` are part of the artifact,
    which takes ``inputs`` only; else it takes ``inputs, mask, *leaves``
    (``operator_leaves``).  Batch norm stays on batch statistics, as in
    ``NormalServer`` and the JAX package's ``model.apply``.  ``platforms``
    names one device, ``("cuda",)`` (the default) or ``("cpu",)``: the
    artifact holds the program for it, and the kernels as ``snx::`` custom
    ops (``sparse/kernels.py``).

    Known difference from the JAX package: its StableHLO artifact runs
    without the model code and on several platforms.  A torch program runs
    on the device it was exported for, and calls the ``snx::`` ops, so
    ``load`` needs this package's ``sparse`` module imported (it registers
    them, and builds the CUDA kernels from ``csrc/`` at their first launch).
    """
    platforms = tuple(platforms or ("cuda",))
    if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
        raise SystemExit(f"platforms {list(platforms)}: a torch artifact runs on one device, 'cuda' or 'cpu' (the JAX "
                         "package's multi-platform StableHLO artifact has no torch counterpart)")
    device = resolve_device(platforms[0])
    if state is not None:
        model.load_state_dict(state, strict=True)
    model = model.to(device).eval()
    leaves, structure = operator_leaves(operator)
    leaves = [t.to(device) for t in leaves]
    mask = torch.as_tensor(mask).to(device)
    inputs = torch.as_tensor(example_inputs).to(device)
    if bake_operator:
        module, args = _Forward(model, structure, leaves, mask), (inputs,)
    else:
        module, args = _Forward(model, structure, leaves, None), (inputs, mask, *leaves)
    with torch.no_grad(), kernels.through_ops():
        program = torch.export.export(module, args)
    out = [n for n in program.graph.nodes if n.op == "output"][0].args[0]
    meta = {"platforms": list(platforms), "in_avals": [_aval(a) for a in args],
            "out_avals": [_aval(o.meta["val"]) for o in out], "nr_devices": 1}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def _load_program(blob: bytes) -> tuple[Any, dict]:
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return program, json.loads(extra[_META])


def load(blob: bytes) -> Callable:
    """The exported forward as a callable that takes what the artifact was
    exported with (``inputs``, or ``inputs, mask, *operator leaves``) on
    the artifact's device, and runs it without autograd."""
    program, _ = _load_program(blob)
    module = program.module()

    def forward(*args):
        with torch.no_grad():
            return module(*args)

    return forward


def export_info(blob: bytes) -> dict:
    """The artifact's platforms, input and output shapes and dtypes
    (``float32[1,128,3]``) and device count, as the JAX package's
    ``export_info`` gives them, without running it."""
    return _load_program(blob)[1]
