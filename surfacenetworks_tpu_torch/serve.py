"""Serving normal prediction (counterpart of ``surfacenetworks_tpu/serve.py``
and ``cli/export_model.py``).

The JAX package exports a traced forward to a StableHLO artifact.  The port
serves the ``nn.Module`` directly: ``NormalServer`` holds LapDeepModel on the
card and answers requests, each one mesh ``(V [n,3], F [m,3])``, with
per-vertex outputs ``[n,3]`` in the request's own vertex order::

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
from typing import Any, Iterable

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
