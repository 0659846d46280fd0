"""The port's graph-parallel mesh-MNIST classifier and VAE on the CPU
(``train_mnist`` and ``train_vae`` at ``--graph-parallel 2``, ``lap`` and
``dirac``, batch 4, on ``tests/fixtures/mnist_plus.np``), held against the
port's single-device step and against the JAX package's graph-parallel
step, with JAX's dropout mask and noise handed in.  The cases, the
tolerances and why are in ``tests/test_torch_dist_gp_train.py``'s
docstring; the checks live in ``tests/torch_dist_gp.py``.  The ranks run
in ``tests/_torch_dist_worker.py``: four gloo ranks started once for this
file, under a hard timeout that kills them."""

import pytest

import torch_dist_gp as gp

NAMES = [c for c in gp.CASES if gp.CASES[c][0] in ("mnist", "vae")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return gp.run_cases(tmp_path_factory.mktemp("dist_gp_mesh"), NAMES + ["mnist_lap_bf16"])


@pytest.mark.parametrize("case", sorted(NAMES))
def test_gp_step_matches_single_device(case, runs):
    """One update on every rank's rows (the pooled head, its dropout mask or
    the VAE's noise the same on every rank) equals the update alone on the
    whole batch, and the ranks hold the same parameters afterwards."""
    gp.hold_single_device(case, runs)


@pytest.mark.parametrize("case", sorted(NAMES))
def test_gp_step_matches_jax(case, runs):
    """The port's fp64 graph-parallel step against the JAX package's (the
    classifier in ``make_graph_sharded_apply``, the VAE in its trainer's own
    ``shard_map``): the loss, every gradient and the well-conditioned
    parameters after one Adam update within 1e-6 (the VAE: see
    ``torch_dist_gp.hold_against_jax``)."""
    gp.hold_against_jax(case, runs)


def test_gp_bf16_matches_single_device(runs):
    """``--bf16`` under ``--graph-parallel`` (the classifier, JAX's dropout
    mask handed in) against the same bf16 step alone on the whole batch:
    the parameters by the sharded steps' fp32 rule (2 lr + 1e-7), the loss within
    bf16's unit roundoff (``torch_dist_gp.BF16_LOSS``: measured 2.3e-4,
    where the fp32 rule's 3e-5 holds only for the fp32 step)."""
    gp.hold_single_device("mnist_lap_bf16", runs)
