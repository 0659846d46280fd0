"""Host-side data: seeded meshes and bucketed batching (counterpart of
``surfacenetworks_tpu/data``).

``datasets`` imports no torch, so the offline stage (``cli.preprocess``,
whose pool forks) reads and writes files without it; the batching and
pipeline names below load ``data/batching.py`` or ``data/pipeline.py`` (and
torch) on first use.
"""

from surfacenetworks_tpu_torch.data import datasets

_BATCHING = (
    "Buckets",
    "BucketSet",
    "MeshBatch",
    "arap_batch",
    "bsr_k_needed",
    "cascade_batch",
    "choose_operator_format",
    "correspondence_batch",
    "dense_dirac_pair",
    "dirac_batch",
    "fit_bsr_k",
    "laplacian_batch",
    "mnist_batch",
    "pad_rows",
    "padded_vertex_fraction",
    "rcm_reorder_sample",
    "rcm_reorder_sequence",
    "round_up",
    "vae_batch",
)

_PIPELINE = (
    "DeviceDataset",
    "IndexedBatch",
    "MetricAccumulator",
    "OperatorCache",
    "padded_vertex_count",
    "prefetch",
    "prefetch_over",
)

__all__ = sorted(_BATCHING + _PIPELINE + ("datasets",), key=str.lower)


def __getattr__(name: str):
    if name in _BATCHING:
        from surfacenetworks_tpu_torch.data import batching

        return getattr(batching, name)
    if name in _PIPELINE:
        from surfacenetworks_tpu_torch.data import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
