"""Host-side data: seeded meshes and bucketed batching (counterpart of
``surfacenetworks_tpu/data``)."""

from surfacenetworks_tpu_torch.data import datasets
from surfacenetworks_tpu_torch.data.batching import (
    Buckets,
    MeshBatch,
    arap_batch,
    bsr_k_needed,
    choose_operator_format,
    correspondence_batch,
    dense_dirac_pair,
    dirac_batch,
    fit_bsr_k,
    laplacian_batch,
    pad_rows,
    rcm_reorder_sample,
    round_up,
)

__all__ = [
    "Buckets",
    "MeshBatch",
    "arap_batch",
    "bsr_k_needed",
    "choose_operator_format",
    "correspondence_batch",
    "datasets",
    "dense_dirac_pair",
    "dirac_batch",
    "fit_bsr_k",
    "laplacian_batch",
    "pad_rows",
    "rcm_reorder_sample",
    "round_up",
]
