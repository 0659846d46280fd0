"""The port's graph-parallel trainers on the CPU (the paths that run a
``PartitionedDirac``, the partitioned GAT attend, and ``--graph-parallel``
in every trainer but ``train_normal --model lap``), held against the
port's single-device step and against the JAX package's graph-parallel
step.

The cases and checks live in ``tests/torch_dist_gp.py``; this file holds
the normal, ARAP and FAUST cases and ``tests/test_torch_dist_gp_mesh.py``
the mesh-MNIST and VAE ones, so each file stays well inside its time.  The
ranks run in ``tests/_torch_dist_worker.py`` (it imports only the port):
four gloo ranks started once for each file, each case on the first ranks
of that group, inputs and outputs through ``.npz`` files, the whole
run under a hard timeout that kills the ranks.  Cases, each at
``--graph-parallel 2``, 2 layers, on the fixtures: ``train_normal`` with
``--model dirac`` (also on a 2 x 2 grid with ``--data-parallel 2``, with
``--no-device-store`` and with a rank-local batch-norm mutant) and ``--model
gat`` (batch 2; ``tests/test_dirac_partition.py`` and
``tests/test_gat.py``'s partitioned models); ``train_arap`` ``lap`` and
``dir`` (batch 4); ``train_mnist`` and ``train_vae``, ``lap`` and
``dirac`` (batch 4; the Dirac models at 1 layer, as
``tests/test_torch_mnist.py``'s); ``train_correspondence`` dcel with the ``lap`` trunk
(ELL and BSR interiors) and the ``dir`` trunk (``tests/
test_graph_parallel.py``'s siamese pair and fast path).  Each rank takes
one update on its shard of the first global batch (FAUST: the epoch plan's
first pair and rotations), in fp64 and in fp32; rank 0 also takes it alone
on the whole batch: the same ordered, padded rows through the
unpartitioned operator.  The weights are seeded flax parameters converted
by ``params_from_flax``; the mesh-MNIST dropout mask and the VAE's noise
are JAX's (read from its single-device forward with the key its
graph-parallel step draws from: the same bits inside ``shard_map``) and
handed to the port.

Tolerances, as the first data- and graph-parallel steps': fp64 against the
single-device step, the loss to 1e-12 and every gradient to 1e-9 relative
to its largest element, the parameters after one Adam update to 1e-9 of
the largest (wherever Adam's first step is well conditioned, every element
equal to the update of its own gradient: ``torch_parity.
hold_adam_update``'s rule); fp32, the loss to 3e-5 relative and every parameter within 2 x
lr (plus 1e-7, the rounding of an fp32 parameter) of the single-device
one: Adam's first step is +-lr wherever the gradient is far above its eps,
so an element whose fp32 gradient sits at rounding level may step either
way.  The normal Dirac runs are held to 1e-9 (loss) and 1e-7 (gradients)
in fp64: their outputs equal the single-device ones module by module to
4e-14, but the cosine loss normalises each output row, and a row of small
norm turns that into 3.4e-11 in the loss and 5.6e-9 in the gradients
(measured), and their parameters are held to 1e-7 too; the rank-local batch-norm mutant moves the loss by 1.4e-2 and
the gradients by 34 times their size.  DirDeepModel's last block adds its
vertex output's biases right before conv2's batch norm, which removes
them: those two gradients are zero in exact arithmetic and held to 1e-12 of
the largest gradient (``torch_parity.hold_grads``).  Against JAX
(``make_graph_sharded_apply``, or the VAE's own ``shard_map``, on the
conftest's virtual CPU devices, fp64 under ``enable_x64``): the loss and
every gradient to 1e-6, and the parameters after optax's Adam to 1e-6
wherever Adam's first step is well conditioned, every element equal to the
update of its own gradient (``torch_parity.hold_adam_update``'s rule).
JAX's BSR interior sums in fp32 by design, so the FAUST BSR case is held
against JAX's ELL-interior run on the same rows.  The rank-local
batch-norm mutant must fail the single-device check; the host route must
equal the device store bit for bit.
"""

import numpy as np
import pytest

import torch_dist_gp as gp

NAMES = [c for c in gp.CASES if gp.CASES[c][0] in ("normal", "arap", "correspondence")]


EXTRA = sorted(c for c in gp.EXTRA if gp.EXTRA[c][0] in ("normal", "arap", "correspondence"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return gp.run_cases(tmp_path_factory.mktemp("dist_gp_train"), NAMES + EXTRA)


@pytest.mark.parametrize("case", sorted(NAMES))
def test_gp_step_matches_single_device(case, runs):
    """One update on every rank's rows equals the update alone on the whole
    batch (see the module docstring for the tolerances), and every rank of
    the grid holds the same parameters afterwards, bit for bit."""
    gp.hold_single_device(case, runs)


@pytest.mark.parametrize("case", ["faust_lap_remat", "normal_dirac_bf16"])
def test_gp_remat_and_bf16_match_single_device(case, runs):
    """``--remat`` (FAUST's lap trunk) and ``--bf16`` (normal Dirac) under
    ``--graph-parallel``, which JAX's graph-parallel paths take: the remat
    step by the fp64 and fp32 rules, the bf16 step by the sharded steps' fp32 rules
    (loss 3e-5 relative, parameters 2 lr + 1e-7), against the same step
    alone on the whole batch."""
    gp.hold_single_device(case, runs)


@pytest.mark.parametrize("case", [c for c in gp.JAX_CASES if c in NAMES])
def test_gp_step_matches_jax(case, runs):
    """The port's fp64 graph-parallel step against the JAX package's on the
    same batch and weights (on the conftest's virtual CPU devices, under
    ``enable_x64``): the loss, every gradient and the well-conditioned
    parameters after one Adam update within 1e-6."""
    gp.hold_against_jax(case, runs)


def test_rank_local_batch_norm_is_refused(runs):
    """A graph-parallel Dirac step whose batch norms (the vertex and the
    face streams') take rank-local statistics computes another model: the
    single-device check refuses it."""
    r = runs("normal_dirac_local_bn")
    with pytest.raises(AssertionError):
        gp.hold_single(r, "rank-local batch norm", "normal_dirac", gp.state0(runs, "normal_dirac"))
    assert abs(float(r["loss64"]) - float(r["ref.loss64"])) > 1e-3 * abs(float(r["ref.loss64"]))


def test_device_store_and_host_routes_agree(runs):
    """``--no-device-store`` (each batch built on the host, cut to the
    rank's rows and uploaded) gives the graph store's Dirac step bit for
    bit."""
    a, b = runs("normal_dirac_host"), runs("normal_dirac")
    for key in [k for k in a if not k.startswith("ref.") and k != "names"]:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
