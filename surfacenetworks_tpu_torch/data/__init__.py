"""Host-side data: seeded meshes and bucketed batching (counterpart of
``surfacenetworks_tpu/data``)."""

from surfacenetworks_tpu_torch.data import datasets
from surfacenetworks_tpu_torch.data.batching import (
    Buckets,
    MeshBatch,
    bsr_k_needed,
    choose_operator_format,
    correspondence_batch,
    fit_bsr_k,
    laplacian_batch,
    pad_rows,
    rcm_reorder_sample,
    round_up,
)

__all__ = [
    "Buckets",
    "MeshBatch",
    "bsr_k_needed",
    "choose_operator_format",
    "correspondence_batch",
    "datasets",
    "fit_bsr_k",
    "laplacian_batch",
    "pad_rows",
    "rcm_reorder_sample",
    "round_up",
]
