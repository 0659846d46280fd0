"""Command-line entry points (counterpart of ``surfacenetworks_tpu/cli``)."""
