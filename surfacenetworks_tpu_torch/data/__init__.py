"""Host-side data: seeded meshes and bucketed batching (counterpart of
``surfacenetworks_tpu/data``)."""

from surfacenetworks_tpu_torch.data import datasets
from surfacenetworks_tpu_torch.data.batching import (
    Buckets,
    BucketSet,
    MeshBatch,
    arap_batch,
    bsr_k_needed,
    cascade_batch,
    choose_operator_format,
    correspondence_batch,
    dense_dirac_pair,
    dirac_batch,
    fit_bsr_k,
    laplacian_batch,
    mnist_batch,
    pad_rows,
    rcm_reorder_sample,
    round_up,
    vae_batch,
)

__all__ = [
    "BucketSet",
    "Buckets",
    "MeshBatch",
    "arap_batch",
    "bsr_k_needed",
    "cascade_batch",
    "choose_operator_format",
    "correspondence_batch",
    "datasets",
    "dense_dirac_pair",
    "dirac_batch",
    "fit_bsr_k",
    "laplacian_batch",
    "mnist_batch",
    "pad_rows",
    "rcm_reorder_sample",
    "round_up",
    "vae_batch",
]
