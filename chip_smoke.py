"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``surfacenetworks_tpu_torch/sparse/csrc``
with one ``nvcc`` call (logging each kernel's registers and spills, and
checking in the SASS that the BSR kernel runs TF32 tensor-core products),
holds each kernel against its plain PyTorch version in fp32 and in fp64 at
the paths' shapes and more (the SDDMM also with padding between live slots,
K from 5 to 33 and C from 3 to 264, and two launches bit for bit), times
both (and each kernel again with a cold L2 cache), and holds each autograd
Function's backward against autograd through the plain versions.  Then it
drives twenty paths, each with the launch counts set to 0 just before it
and read just after (in the processes of the ``--multihost`` runs, each
process's own):

* serving: LapDeepModel-15 at width 128 through ``NormalServer`` on four
  ~7,000-vertex meshes in the ELL and the BSR operator format, checked
  against each other and against an fp64 forward that uses no kernel;
* training: the FAUST siamese Lap-15 trainer (width 128, 120-d features)
  taking 8 updates with ``--smooth-reg 0.1`` on ~7,000-vertex synthetic
  scans in both formats, then its test pass; step 0's loss and gradients
  are checked against the same step in fp64 with dense operators and no
  kernel, and a trunk whose operator applies return detached outputs must
  fail that check.  Then each format runs the 8 updates and the test pass
  again from step 0's weights, optimizer state and random state, and the
  two runs' losses, test metrics and weights must be bit-identical (the
  same run and repeat as every other trainer: ``_train_run`` over
  ``FaustRun``);
* the rest of FAUST correspondence: the same trainer, data and widths
  with the amp trunk (ELL on the squared-Laplacian pyramid, K=125:
  ``ell_matmul`` and its backward at that K against the plain version in
  fp32 and fp64, each level timed warm and cold with its bounds and
  ``torch.sparse.mm``, ``sddmm`` at the same K), the dir, avg and mlp
  trunks, the sl1 and cel losses, the lap trunk with and without
  ``--remat`` in ELL and BSR, ``--intrinsic`` and the light path (forced),
  4 updates and the test pass each, every run repeated bit for bit; step 0
  of dir against fp64 module by module (the dense fp64 Dirac pair), of amp
  against the same modules in fp32 with the kernels' plain versions (its
  replay against dense fp64 pyramid levels reported: level 2's |L x| of
  1e24 overflows fp32 in the batch norms' variances), the detached mutants
  refused; ``--remat`` and
  the light path bit-identical to their plain runs, peaks beside them;
  ``--eval-only`` on a checkpoint of the amp run against the device's
  metrics of the same predictions;
* normal training: ``cli/train_normal.py`` (LapDeepModel-15 at width 128,
  batch 1) taking 8 updates on ~7,000-vertex synthetic meshes in ELL and
  in BSR, then its test pass; step 0 is checked against fp64 as above (the
  detached mutant refused); the run is repeated from step 0's state, and
  resumed in a fresh trainer from a checkpoint saved after step 4, and both
  must be bit-identical.  The dense format, at 2,000 vertices, is measured;
* the rest of the normal zoo: the same trainer with ``--model gat``
  (GatDeepModel-15: masked 4-head attention over the ELL pattern in RCM
  order, here with ``--flip-variants 1``), ``avg``, ``mlp``, ``id`` and
  ``gat --bf16``, 4 updates and the test pass each, none launching a
  kernel; step 0 against fp64 module by module (a GAT whose attends are
  detached refused); every run repeated bit for bit; the attends' device
  time in the profiled step and alone;
* the multiresolution cascade: the same trainer with ``--model cas``
  (EfficientCascade at width 128 over a 4-level Laplacian pyramid of 875 /
  1,750 / 3,500 / 7,000 rows, ELL at K=32 per level) on the normal data:
  ``ell_matmul`` and its backward at each level's shape against the plain
  version (fp32, fp64, bf16 x; two launches bit for bit; the item-0
  mutant refused), each level timed warm and cold with both bounds and
  ``torch.sparse.mm``; 8 updates and the test pass, 28 launches a step;
  step 0 against fp64 module by module with the glue between the modules
  (pooling, upsampling, skips) replayed in fp64, the finest level's
  applies detached and an upsampling that tiles refused; how far a
  max(dim) pooling moves step 0's gradients reported; the repeat and a
  resume bit for bit; then 8 ``--bf16`` updates (step 0 against the plain
  versions in bf16, the repeat bit for bit);
* ``--rotate-augment`` (JAX's threefry draws, ``train/prng.py``) on the
  normal Lap-15 ELL run, 4 updates: the card's rotations against the
  host's in fp64, orthonormal with determinant 1, each update's drawn at
  its step; the repeat bit for bit; and ``--buckets 3`` on meshes of
  3,000, 5,000 and 7,000 vertices, 8 updates drawn tier by tier, 32
  launches a step in every tier, the repeat bit for bit, a timing row per
  tier;
* Dirac training: the same trainer with ``--model dirac`` (DirDeepModel-15,
  the structured Dirac tables packed to a base valence): each Dirac apply
  and backward against the fp64 scipy pair (mutants without a slot or
  without the overflow rows refused) and timed, then 8 updates and the test
  pass, which must launch none of the three kernels; step 0 against fp64
  module by module (the detached mutant refused); the repeat and the resume
  bit-identical; the applies' device time and share of the step;
* ARAP training: ``cli/train_arap.py`` (Model-15 at width 128, batch 32,
  2 frames in, 40 out) on 2,000-vertex synthetic sequences: ``ell_matmul``
  and its backward on the first batch's 32 stacked operators against the
  plain version (a mutant applying item 0's operator to every item
  refused) and timed; 8 updates and the test pass in ELL, 32 launches per
  step, step 0 against fp64 module by module (the detached mutant refused);
  the same in ``--dense`` and, for 4 updates, with ``--model dir`` (its
  batched Dirac applies held against the scipy pairs), neither launching a
  kernel; every run repeated from its start bit for bit;
* mesh-MNIST training: ``cli/train_mnist.py`` (Model-5 at width 64) and
  ``cli/train_vae.py`` (LapVAE-5 at width 128, a 100-d latent), batch 64,
  on 320 synthetic 210-vertex height fields: ``ell_matmul`` and its
  backward on the classifier's first ELL batch of 64 stacked operators at
  C=64 against the plain version (the item-0 mutant refused) and timed; per
  trainer 8 updates and the test pass with the default format (dense here)
  and in ELL (20 and 40 launches per step), and 4 with the Dirac model;
  step 0 of the ELL and Dirac runs against fp64 module by module with the
  step's own dropout mask or noise (the detached mutants refused); every
  run repeated from its start bit for bit; the dense and ELL losses
  compared;
* serving from exported artifacts (``serve.export_forward``, ``load``):
  the serve phase's LapDeepModel-15 on its first ELL request with the
  operator baked in, as a runtime argument (also on the second request)
  and in bf16, and DirDeepModel-15 on a 7,000-vertex synthetic mesh; each
  answer bit-identical to the eager module's, the fp32 ones within the
  serve bound of an fp64 forward, 16 ``ell_matmul`` a Lap forward counted
  inside the artifact, its device ms beside the eager forward's, its size;
  and the host time of one eager kernel call, direct and through the
  ``snx::ell_matmul`` custom op;
* the host input pipeline: the normal Lap-15 ELL run with
  ``--no-device-store`` (batches built and pinned on the prefetch thread,
  uploaded without blocking) against the same run from its device store,
  losses and weights bit for bit; FAUST Lap-15 ``--loss sl1`` and ``cel``
  past the device budget (forced) on the FAUST scans, the JAX trainer's host
  path: 4 updates and the test pass, the bytes uploaded a step, step 0
  against fp64 module by module (the detached mutant refused), the run
  repeated bit for bit;
* the reference's presets: ``train_normal --preset normal-lap`` and
  ``normal-dirac`` at their batch of 32 on 40 synthetic 7,000-vertex
  meshes, 4 updates and the test pass each (ELL for Lap: 32 launches a
  step, each over 32 operators);
* the offline stage into the trainers: ``cli/preprocess.py mnist``,
  ``normal`` (lap and ``--operator dirac``) and ``arap``, each as its own
  process with a worker per core, on 192 seeded digits written as MNIST idx
  files, 5 synthetic 7,000-vertex meshes written as ``.obj`` and
  ``synthetic_arap_sequences(5, 50, 2000)``'s frames written as ``.obj``
  directories; then ``train_mnist`` (Model-5, ELL, batch 64, 4 updates),
  ``train_normal`` (Lap-15 ELL, 8 updates; Dir-15, 4) and ``train_arap``
  (Model-15 ELL, batch 32, 4 updates) on the files: launches per step (20,
  32, none, 32), step 0 against fp64 module by module (the detached mutants
  refused), every run repeated bit for bit, and the Lap run's losses, test
  metrics and weights bit-identical to a run on the ``.obj`` trees through
  the lazy path;
* the large-mesh trunk (``benchmarks/large_mesh.py``'s configuration):
  LapDeepModel-15 at width 128 with ``remat=True`` on ``random_blob_mesh``
  at 25,000 and 100,000 vertices, BSR over RCM order, one forward and
  backward of the masked magnitude loss, fp32 and at 100,000 also bf16: 48
  launches (16 forward, 16 backward, 16 replays), the device busy and peak
  memory; at 25,000 the same step without remat bit-identical (its peak
  beside), the BSR apply element by element and the output against fp64;
* ``train_normal --jax-profile DIR`` on Lap-15 ELL for 2 updates (run
  before the export phase, whose ``torch.export`` costs later traces in the
  process some kernel records): the Chrome trace must hold 32
  ``ell_spmm_kernel`` events a step;
* the distributed runtime (``dist/``): with the kernels built here first,
  two ranks spawned on the one card over gloo (NCCL refuses two ranks on
  one device): ``partitioned_spmm`` at 7,000 rows (ELL interior, K=16,
  C=128) and 7,168 rows (BSR interior), forward and stored-transpose
  backward, each rank's rows against the single-card ``ell_matmul`` /
  ``bsr_matmul`` on the whole operator within 1e-5 of ``|A||x|``, one
  interior and one boundary launch an apply, a dropped boundary slot and a
  zeroed halo refused, the local products timed with their bounds and
  ``torch.sparse.mm``; ``train_normal --graph-parallel 2`` (Lap-15, ELL
  and BSR interiors, 4 updates), ``train_normal --data-parallel 2`` at
  batch 2 and ``train_arap --data-parallel 2`` at batch 32 (2 updates):
  step 0 against the same step on one rank over the whole batch (loss,
  gradient, parameters; a rank-local batch norm refused), launches a step,
  and per rank the wall, device busy, idle share and the halo exchanged;
  the row-partitioned Dirac pair (``Di v``, ``DiA f`` and both backwards,
  each rank's rows bit-identical to the single-card structured applies,
  held within 1e-5 of ``|D||x|``; a dropped boundary face and a zeroed face
  halo refused) and the partitioned GAT attend (a zeroed payload halo
  refused); ``--graph-parallel 2`` in ``train_normal --model dirac|gat``,
  ``train_arap`` (batch 32), ``train_mnist`` (batch 64), ``train_vae
  --model dirac`` and ``train_correspondence`` (lap ELL and BSR, dir) at 7
  layers (5 for mesh-MNIST and the VAE): step 0 module by module against
  one rank, a rank-local batch norm refused on each, then 2 updates with
  their launches asserted;
  the overlap check (``dist/analysis.py``) of one partitioned ELL apply on
  each rank, which must issue its interior before the halo wait, and a
  ``torch.profiler`` trace of it in that order: the interior
  ``ell_spmm_kernel``, the halo's host-to-device copies, the boundary
  kernel; then one rank over NCCL takes a DP step and runs NCCL's ``all_reduce``
  and ``broadcast`` on the card (collectives across cards and NCCL's
  peer-to-peer sends are not exercised on one card);
* ``--multihost``: ``train_normal`` Lap-15 (``--graph-parallel 2`` with ELL
  and BSR interiors, ``--data-parallel 2`` at batch 2, 2 updates) and
  ``train_correspondence --graph-parallel 2`` (lap-7 ELL, sl1 and dcel),
  each as two processes started apart that meet at a coordinator on
  ``127.0.0.1`` (one rank each, both on the card over gloo), beside the
  one-launch run of the same flags: checkpoints and metrics bit-identical
  (dcel, which takes the host path under ``--multihost``, within the
  FAUST loss bound of the one-launch fast path), each process's launches
  asserted.  The ARAP ELL run also writes its ``--dump-rollout`` arrays
  (``train_arap.dump_rollout``): one forward's launches, the targets bit
  for bit, the prediction against the plain forward; without matplotlib the
  CLI must refuse the flag at its start.

Before the kernels, the native host runtime (``native/``, its own ``g++``
build) is held against the NumPy route bit for bit on a 7,000-vertex mesh
(``dirac_coeffs``, both ELL packers from (V, F), the one-pass CSR packer,
``vertex_normals``) and both are timed on the host.

Mixed precision (``--bf16``) adds a kernel phase and a training phase:

* the three kernels' bf16 variants (``bsr_matmul`` on bf16 blocks with fp32
  or bf16 x, ``ell_matmul`` on bf16 x, ``sddmm`` on bf16 a and b) against
  their plain versions at the paths' shapes and at ragged, narrow, wide and
  batched ones (``ell_matmul`` at every rows-per-warp case, C from 3 to
  264, and at the ARAP and mesh-MNIST batches; ``bsr_matmul`` with and
  without the operator's live-chunk mask, which must give the same bits),
  forward and backward, fp32 results within 1e-5 of ``|A||x|`` and bf16
  results within one bf16 ulp more; two launches bit for bit; a BSR mutant
  that truncates x to bf16 instead of rounding it, a live mask with one
  live chunk cleared, a dropped slot and the item-0 batch refused; the bf16
  BSR kernel's SASS must hold ``HMMA.16816.F32.BF16``, the bf16 BSR kernel
  must not spill and the bf16 ELL kernel must fit in 64 registers without
  spilling; each variant timed warm and cold against its bound at bf16
  bytes (BSR also without the mask, ELL beside the fp32 kernel);
* the five trainers with ``--bf16`` at the fp32 runs' widths, depths,
  batches and data: FAUST Lap-15 in ELL and BSR (bf16 blocks) with
  ``--smooth-reg 0.1``, where all three variants launch; normal Lap-15 in
  BSR, whose final loss after 8 steps must stay below 3x its fp32 run's +
  1e-3 (the JAX package's convergence check); ARAP Model-15 ELL at batch 32;
  the mesh-MNIST classifier and LapVAE-5 in ELL, the classifier in its
  default format (dense here, no kernel) and DirModel-5 at batch 64.
  Each run: launches per step, finite losses, step 0's gradients finite,
  non-zero and fp32, step 0 of each kernel run module by module against
  the same modules in bf16 with the kernels' plain versions (a
  detached-apply reference refused), the run again from its start bit for bit, and its wall, device
  busy, idle share and peak memory beside the fp32 run of the same path.

It needs a CUDA card; without one (or without the package beside it) it
exits non-zero and prints no result.  The last two lines are a JSON
``kernels`` report (the fp32 and the bf16 variants) and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()  # the device phase and the total count the imports below

import numpy as np  # noqa: E402

from surfacenetworks_tpu_torch.sparse import kernels as port_kernels  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FMA
# outside the tensor cores and dense TF32 on the tensor cores, flop/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TF32_PASSES = 3  # bsr_matmul's 3xTF32: three tensor-core products per multiply-add
BF16_TENSOR_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores: bsr_matmul's bf16 variant, one pass
L2_FLUSH_BYTES = 128 << 20  # written between cold-L2 launches: over twice the 50 MB L2

BUCKET = 7040  # one 128-multiple bucket for every ~7,000-vertex request
WIDTH = 128
LAYERS = 15
APPLIES_PER_FORWARD = 16  # 8 WideLapResNet2 blocks x 2 inner steps
N_REQUESTS = 4
SEED = 0
# The kernel and operator checks hold every element of a product A x to the
# size of the terms summed into it: |got - ref| <= RTOL * (|A| |x|) + TINY.
# fp32 accumulation of the K <= 16 nonzero terms of a row errs by at most
# about K * 6e-8 of that sum, whatever the cancellation; TINY only lets an
# element whose terms are all zero be zero.
TINY = 1e-30
# Kernel vs its plain version on the same fp32 inputs.
KERNEL_RTOL = 1e-5
# Each served request's operator, applied to its inputs through the kernel
# and put back in the request's vertex order, against L x in fp64 on the
# same fp32 L and x.
PIPELINE_RTOL = 1e-5
# Served answers (fp32) against an fp64 forward of the same model on a dense
# copy of the operator (no kernel), and the two formats against each other,
# as relative Frobenius errors.  This bound is loose by necessity: L x cancels
# (|L| reaches 1e6 at sliver triangles of these meshes, L x stays O(10)), so
# fp32 rounding is amplified through 15 batch norms, whose statistics every
# row shares.  The checks above are the element-wise ones; this one holds
# the whole model and the answers' vertex order (an answer left in RCM
# order reads about 1.4, and the run asserts that it is refused).
SERVE_FRO_RTOL = 0.75
# Training: the correspondence trunk's feature width (the SDDMM's C), the
# synthetic FAUST-like data, and launches expected per step: 16 applies per
# trunk forward, two trunks, forward and stored-transpose backward (64); one
# SDDMM per smoothness term (2), whose backward runs two ELL SpMMs, da and
# db over the pattern's transpose slot map (4); and one ELL SpMM for the
# streaming dcel head's mirror over the target's inverse (1).  So ELL steps
# launch 64 + 4 + 1 = 69 ell_matmul, BSR steps 64 bsr_matmul and 5
# ell_matmul.
FEATURES = 120
FAUST_DATA = {"num": 4, "n_points": 7000, "seed": SEED}  # the scans TRAIN_ARGS name, made once
TRAIN_ARGS = ["--synthetic", "4", "--synthetic-points", "7000", "--seed", "0", "--layer", str(LAYERS),
              "--smooth-reg", "0.1", "--xz-rotate", "--num-updates", "8", "--num-epoch", "1", "--device", "cuda",
              "--deser-option", "no"]
TRAIN_STEPS = 8


def launches_of(**counts) -> dict:
    """Launch counts of every kernel variant the port counts (the keys of
    ``kernels.launches``; the bf16 variants apart): those given, the rest 0."""
    assert set(counts) <= set(port_kernels.launches), counts
    return {k: counts.get(k, 0) for k in port_kernels.launches}


EXPECTED_PER_STEP = {
    "ell": launches_of(ell_matmul=69, sddmm=2),
    "bsr": launches_of(bsr_matmul=64, ell_matmul=5, sddmm=2),
}
# The rest of FAUST correspondence (the "faust zoo"): the same trainer,
# data and widths as the train phase (TRAIN_ARGS on FAUST_DATA: width 128,
# 120-d features, --smooth-reg 0.1, --xz-rotate) at FAUST_ZOO_LAYERS layers
# (the train phase runs 15; cut to keep the whole smoke near its time, the
# amp trunk still reaches its pyramid's third level at layer 4),
# FAUST_ZOO_STEPS updates and the test pass per run, each run repeated from
# its start bit for bit.  Per run (operator format, flags): the amp trunk on
# the squared-Laplacian pyramid (every level packed at the pyramid's widest
# row, K=125 on these scans); the dir, avg and mlp trunks (``auto``: the
# Dirac tables for dir, BSR over RCM order for avg, which reads no
# operator; mlp in ELL); the sl1 and cel losses (lap, full logits); the lap trunk in
# ELL and BSR with and without --remat; --intrinsic; and the light path
# forced through ``_FORCE_LIGHT``.  Launches per step: the trunk's applies
# (FAUST_ZOO_APPLIES per trunk forward, half as many again with --remat's
# recompute, two trunks, forward and backward) plus the smoothness terms' 2
# SDDMMs and their backward's 4 ELL sums, plus the streaming dcel head's
# mirror (1; sl1 and cel have the full-logits head and no mirror).  A test
# pair runs the two trunks' forwards where the trunk reads an operator; the
# light path skips the test pass.  --remat and the light path must give their plain runs' losses and
# weights bit for bit; step 0 of amp and dir is held against fp64 module by
# module with the train phase's bounds.
FAUST_ZOO_STEPS = 4
FAUST_ZOO_LAYERS = 7
FAUST_ZOO_DEPTH = ("--layer", str(FAUST_ZOO_LAYERS))
FAUST_ZOO_APPLIES = 2 * ((FAUST_ZOO_LAYERS + 1) // 2)  # two a Lap block, Lap blocks on even layers: 8
FAUST_ZOO_RUNS = {
    "amp": ("ell", ("--model", "amp")), "dir": ("auto", ("--model", "dir")),
    "avg": ("auto", ("--model", "avg")), "mlp": ("ell", ("--model", "mlp")),
    "sl1": ("ell", ("--loss", "sl1")), "cel": ("ell", ("--loss", "cel")),
    "lap ell": ("ell", ()), "remat ell": ("ell", ("--remat",)),
    "lap bsr": ("bsr", ()), "remat bsr": ("bsr", ("--remat",)),
    "intrinsic": ("ell", ("--intrinsic",)), "light": ("ell", ()),
}
FAUST_ZOO_PER_STEP = {
    **{k: launches_of(ell_matmul=4 * FAUST_ZOO_APPLIES + 4 + 1, sddmm=2)
       for k in ("amp", "lap ell", "intrinsic", "light")},
    **{k: launches_of(ell_matmul=4 + 1, sddmm=2) for k in ("dir", "avg", "mlp")},
    **{k: launches_of(ell_matmul=4 * FAUST_ZOO_APPLIES + 4, sddmm=2) for k in ("sl1", "cel")},
    "remat ell": launches_of(ell_matmul=6 * FAUST_ZOO_APPLIES + 4 + 1, sddmm=2),
    "lap bsr": launches_of(bsr_matmul=4 * FAUST_ZOO_APPLIES, ell_matmul=5, sddmm=2),
    "remat bsr": launches_of(bsr_matmul=6 * FAUST_ZOO_APPLIES, ell_matmul=5, sddmm=2),
}
FAUST_ZOO_PER_TEST = {k: launches_of(**{("bsr_matmul" if k.endswith("bsr") else "ell_matmul"):
                                         2 * FAUST_ZOO_APPLIES}) for k in FAUST_ZOO_RUNS}
FAUST_ZOO_PER_TEST.update({k: launches_of() for k in ("dir", "avg", "mlp", "light")})
FAUST_ZOO_SAME = {"remat ell": "lap ell", "remat bsr": "lap bsr", "light": "lap ell"}  # bit for bit
# The amp trunk's step 0 against fp64 is reported, not held: on these scans
# |L| reaches 6.6e6 (sliver triangles), so the pyramid's level 2 reaches
# |L x| of about 8e22, whose square overflows fp32 (3.4e38) in the 'pre'
# batch norm's variance: in fp32, with or without a kernel, those channels
# normalise to 0, where fp64 normalises them (the run counts them).  It is
# held module by module against the same modules in fp32 with the kernels'
# plain versions instead (``plain_step0_check``), which round and overflow
# at the same places and differ only in the applies' summation order.  On
# the card, at 15 layers, the chain read 2.4e-6 and the parameters 2.1e-6,
# the detached mutant's chain 8.5e2; the fp64 replay read about 1.0 for the
# real step and the mutant alike, and all 128 channels of the six level-2
# blocks overflow (PERF.md, section 6).
FAUST_AMP_PLAIN_CHAIN_RTOL = 1e-4
FAUST_AMP_PLAIN_PARAM_RTOL = 1e-4
# Step 0 on the card (fp32, kernels) against the same step in fp64 with
# dense operators and no kernel.  The whole step's loss, as a relative error,
# is loose for the reason SERVE_FRO_RTOL is, and more: the dcel head's
# softmax is near one-hot, so fp32 rounding of the features moves the loss.
# For the same reason the whole step's gradients are reported, not bounded.
# The gradients are held module by module instead: the head and each trunk
# module run in fp64 from the card's own inputs and output cotangents.  The
# chain (the head's loss and feature cotangents, each module's input
# cotangent) must agree with the card's within STEP0_CHAIN_RTOL, each
# parameter's gradient (a sum over 14,000 vertices that cancels) within
# STEP0_PARAM_RTOL, as relative Frobenius errors.  A detached apply breaks
# the chain: about 1.0.  PERF.md gives the measurements behind the bounds.
STEP0_LOSS_RTOL = 1.0
STEP0_CHAIN_RTOL = 0.2
STEP0_PARAM_RTOL = 0.5
# Normal training, the JAX package's first workload: LapDeepModel-15 at width
# 128 regressing vertex normals, batch 1 (the trainer's defaults), on five
# synthetic ~7,000-vertex meshes (the 80/20 split gives 4 train meshes and 1
# test mesh), 8 updates and the test pass per format; only the run length is
# cut.  Per step 16 applies forward and 16 stored-transpose applies backward:
# 32 launches of the format's kernel and nothing else.  The dense run, at one
# bucket of at most 2,048 vertices where ``auto`` picks dense, is measured
# only: it launches no kernel.
NORMAL_ARGS = ["--synthetic", "5", "--synthetic-points", "7000", "--seed", "0", "--layer", str(LAYERS),
               "--batch-size", "1", "--num-updates", "8", "--num-epoch", "1", "--device", "cuda"]
NORMAL_DENSE_ARGS = ["--synthetic", "5", "--synthetic-points", "2000", "--seed", "0", "--layer", str(LAYERS),
                     "--batch-size", "1", "--num-updates", "8", "--num-epoch", "1", "--device", "cuda"]
NORMAL_PER_STEP = {
    "ell": launches_of(ell_matmul=32),
    "bsr": launches_of(bsr_matmul=32),
    "dense": launches_of(),
}
NORMAL_RESUME_AFTER = 4  # the checkpoint is saved after this many updates
# Normal step 0 against the same step in fp64 with dense operators and no
# kernel: the loss as a relative error, then module by module with the FAUST
# step's bounds (STEP0_CHAIN_RTOL, STEP0_PARAM_RTOL).  fp32 rounding alone
# moves the loss: the same step in fp32 with dense operators and no kernel
# read 0.034 of fp64 on the card, the kernel steps 0.0044 (ELL) and 0.022
# (BSR); module by module the chain read at most 0.084 and the parameter
# gradients 0.20, the detached mutant's chain 1.0 (PERF.md, section 6).
NORMAL_STEP0_LOSS_RTOL = 0.1
# The rest of the normal zoo: the normal trainer at the normal phase's data
# and widths (LapDeepModel's WIDTH 128, batch 1, ~7,000-vertex meshes) at
# ZOO_LAYERS layers (the normal phase runs 15; cut to keep the whole smoke
# near its time) with --model gat (4 GatResNet2 blocks of 4 heads and 3 Avg
# blocks; ELL over RCM order, whatever the format flag says; here with
# --flip-variants 1, so 4 more train meshes), avg, mlp and id, 4 updates
# and the test pass each, and gat with --bf16.  None of them launches a
# kernel: GAT's attention is plain PyTorch (one gather of [R*K, H*ch + H]
# payload rows, a masked softmax over the K slots) and the other three read
# no operator.  Step 0 of each run against fp64 module by module with the
# normal phase's bounds (GAT's fp64 reference attends over the same ELL
# pattern; the bf16 run's modules too, from its bf16 inputs), the parameters
# that are zero in exact arithmetic by size (ZOO_NULL_GRADS); a GAT whose
# attends return detached outputs must fail that check.  On the card, at 15
# layers, the fp32 runs' chain read at most 6.2e-6 and their parameter gradients 9.0e-5,
# the bf16 GAT run's 5.4e-3 and 0.28 (bf16 rounding in batch-norm bias
# gradients whose rows cancel), the detached attends' chain 0.75 (PERF.md,
# section 6).
ZOO_STEPS = 4
ZOO_LAYERS = 7
ZOO_ARGS = ["--synthetic", "5", "--synthetic-points", "7000", "--seed", "0", "--layer", str(ZOO_LAYERS),
            "--batch-size", "1", "--num-updates", str(ZOO_STEPS), "--num-epoch", "1", "--device", "cuda"]
ZOO_RUNS = {"gat": ["--model", "gat", "--flip-variants", "1"], "avg": ["--model", "avg"], "mlp": ["--model", "mlp"],
            "id": ["--model", "id"], "gat bf16": ["--model", "gat", "--bf16"]}
# Zero in exact arithmetic: MlpModel passes a per-channel constant through
# every block unchanged (batch norms remove it, residuals carry it) to its
# final batch norm, which removes it, so conv1's bias and every block's
# fc biases are; IdDeepModel's last block output reaches only conv2's 'pre'
# batch norm, so its last conv's biases are.
ZOO_NULL_GRADS = {
    "mlp": {"conv1.fc.bias"} | {f"rn{i}.fc{j}.fc.bias" for i in range(ZOO_LAYERS) for j in (0, 1)},
    "id": {f"rn{ZOO_LAYERS - 1}.bn_fc1.fc.bias", f"rn{ZOO_LAYERS - 1}.bn_fc1.bn.bias"},
}
GAT_RANGE = "gat attend"  # the profiler range around each attend's forward in the profiled step
GAT_ATTENDS = 2 * ((ZOO_LAYERS + 1) // 2)  # two a GAT block, GAT blocks on even layers
# The multiresolution cascade (``--model cas``): EfficientCascade(3, 3) at
# the JAX trainer's defaults (4 pyramid levels, width 128, 2 inner layers),
# batch 1, on the normal cell's data: the finest bucket of 7,000 rows (the
# meshes' 7,000 vertices rounded to 8, then to 2**3), levels of 875 /
# 1,750 / 3,500 / 7,000 rows coarsest first, one ELL operator of 32 slots
# each.  8 updates and the test pass, then the same with --bf16.  Per step
# 14 applies forward (3 down blocks, lap0, 3 up blocks, 2 each: 8 / 8 / 8 /
# 4 by level with the backward) and 14 stored-transpose applies backward:
# 28 ell_matmul; under --bf16 the forward's 14 take bf16 x.  A test mesh
# runs the forward's 14.  Step 0 against fp64 module by module with the
# normal bounds, the glue between the modules (pooling, upsampling, skips,
# and their backward) replayed in fp64 from the card's module outputs and
# cotangents as rows of the chain; a step whose finest level's applies are
# detached, and one that upsamples by tiling, must fail it.  The bf16 run
# against the plain versions in bf16, as the other bf16 runs.
CASCADE_LEVELS = 4
CASCADE_STEPS = 8
CASCADE_ARGS = ["--synthetic", "5", "--synthetic-points", "7000", "--seed", str(SEED), "--model", "cas",
                "--cascade-levels", str(CASCADE_LEVELS), "--batch-size", "1", "--num-updates", str(CASCADE_STEPS),
                "--num-epoch", "1", "--device", "cuda"]
CASCADE_PER_STEP = launches_of(ell_matmul=28)
# --rotate-augment: the normal Lap-15 ELL run rotated (JAX's draws), 4
# updates; 32 ell_matmul a step, as unrotated.  The rotations on the card
# (fp32 cosines, sines and products of the host's angles) against the same
# angles' rotations in fp64 on the host, orthonormal with determinant 1.
ROTATE_STEPS = 4
ROTATE_ATOL = 1e-6
# --buckets 3: Lap-15 ELL, batch 1, on blob meshes of 3,000, 5,000 and
# 7,000 vertices written as .obj files (two of each to train, one of each
# to test, --test-path), three tiers of those sizes, 8 updates drawn tier
# by tier and the test pass; 32 ell_matmul a step in every tier; then 3
# updates in each tier alone, the last profiled, for a row per tier.
TIER_POINTS = (3000, 5000, 7000)
TIER_STEPS = 8
# Dirac training: the normal trainer with ``--model dirac`` at its defaults,
# DirDeepModel-15 (8 Dirac blocks, 7 Avg blocks) at width 128, batch 1, on
# the same five synthetic ~7,000-vertex meshes with Dirac coefficients
# (buckets 7,000 x 14,000, max valence 16 packed to a base of 8 with 280
# overflow rows); 8 updates and the test pass.  The Dirac applies are plain
# PyTorch (a gather and a batched product), so the path launches none of the
# three kernels, and the smoke asserts so.  Each apply and each backward is
# held element by element to 1e-5 of its own sum |q| |x| against the fp64
# scipy pair on the host (|q_fv| reaches 2e4 where the areas are small, so
# D x cancels as L x does); step 0 against the same step in fp64 on the
# dense fp64 pair of the float64 vertices (no structured apply), module by
# module: the parameter gradients with the Lap phases' bound, the chain with
# its own, DIRAC_STEP0_CHAIN_RTOL.  Against the structured path in fp64 the
# chain read at most 1.8e-4 on the card, the detached mutant's 1.0: 1e-2
# leaves a factor of about 50 on the real side and 100 on the mutant's
# (PERF.md, section 6).
# Two parameters have a zero gradient in exact arithmetic (DIRAC_NULL_GRADS:
# the last block's output biases, whose per-channel constant conv2's 'pre'
# batch norm removes): each card gradient is held to NULL_GRAD_RTOL of
# the largest fp64 gradient instead, as a Frobenius ratio.
DIRAC_POINTS = 7000
DIRAC_ARGS = ["--synthetic", "5", "--synthetic-points", str(DIRAC_POINTS), "--seed", str(SEED), "--model", "dirac",
              "--layer", str(LAYERS), "--batch-size", "1", "--num-updates", "8", "--num-epoch", "1", "--device", "cuda"]
DIRAC_STEPS = 8
DIRAC_BLOCKS = (LAYERS + 1) // 2  # Dirac blocks on even layers: one vf and one fv apply each
DIRAC_APPLY_RTOL = 1e-5
DIRAC_STEP0_CHAIN_RTOL = 1e-2
DIRAC_MUTANT_SCALE = 1.03  # a mutant whose applies pass back cotangents 3% too large must fail it
NULL_GRAD_RTOL = 1e-4
# the normal phase's module-wise bounds (also the zoo's, whose Mlp and Id
# models have null gradients of their own)
NORMAL_STEP0_BOUNDS = {"chain": STEP0_CHAIN_RTOL, "parameter": STEP0_PARAM_RTOL, "null": NULL_GRAD_RTOL}
DIRAC_RANGE = "dirac apply"  # the profiler range around each apply in the profiled step
DIRAC_NULL_GRADS = {f"rn{LAYERS - 1}.bn_fc1.fc.bias", f"rn{LAYERS - 1}.bn_fc1.bn.bias"}
# ARAP training: the JAX trainer's defaults but for the run length and the
# data.  Model-15 (8 Lap blocks, 7 Avg blocks) at width 128, batch 32, Adam
# 1e-3 with coupled weight decay 1e-5 under the halving schedule, random
# weights from a seeded generator, on synthetic_arap_sequences(5, 50 frames,
# 2,000 points, seed 0): 4 train and 1 test sequence, 8 valid offsets each,
# one 2,000-row bucket, 64,000 rows per batch.  8 updates and the test pass
# in ELL and in --dense; the Dir model (8 Dirac, 7 Avg blocks) 4 updates.
# Per Lap step 16 applies forward and 16 stored-transpose applies backward,
# each one launch over the 32 stacked operators: 32 ell_matmul and nothing
# else; a test pass 16.  Step 0 is held against the same step in fp64 on
# dense fp64 operators: its loss, then module by module, with bounds of its
# own.  On the card the loss read 3.4e-5 (the same step in fp32 with dense
# operators and no kernel the same), the chain at most 1.26e-4 and the
# parameter gradients 1.22e-3 (conv1's bias), the detached mutant's chain
# 1.0 and parameters 0.83 (PERF.md, section 6): the bounds below leave a
# factor of 30-80 on the real side and of 17-100 on the mutant's, where the
# Lap phases' 0.2 and 0.5 would leave 1.7 on the mutant's parameters.
ARAP_SEQUENCES = {"num_seq": 5, "n_frames": 50, "n_points": 2000, "seed": SEED}
ARAP_ARGS = ["--layer", str(LAYERS), "--batch-size", "32", "--num-updates", "8", "--num-epoch", "1",
             "--seed", str(SEED), "--device", "cuda"]
ARAP_STEPS = 8
ARAP_STEP0_LOSS_RTOL = 1e-3
ARAP_STEP0_CHAIN_RTOL = 1e-2
ARAP_STEP0_PARAM_RTOL = 5e-2
ARAP_DIR_STEPS = 4
ARAP_PER_STEP = {"ell": launches_of(ell_matmul=32), "dense": launches_of(), "dir": launches_of()}
# Mesh-MNIST, the reference paper's own workloads at its configurations:
# the classifier (Model-5: 5 Lap blocks at width 64, dropout 0.5, 10
# classes) and the VAE (LapVAE-5: 5 Lap blocks at width 128 in the encoder
# and in the decoder, a 100-d latent), batch 64, Adam 1e-3 with coupled
# weight decay 1e-5, random weights from a seeded generator, on
# synthetic_mnist_dataset(320, seed 0, 210 points): 256 train and 64 test
# height fields of 210 vertices (the reference's Poisson-disc sampler gives
# 204-216), one 216 x 416 bucket, 13,824 rows per batch.  Per family, 8
# updates (two epochs of 4; the VAE's KLD weight 0, then 0.1) and the test
# pass with the operator format ``auto`` (dense at this size, as in the JAX
# trainers) and in ELL (K=16); the Dirac model (DirModel-5, DirVAE-5) 4
# updates.  Per ELL step 2 applies per Lap block forward and 2
# stored-transpose applies backward, each one launch over the 64 stacked
# operators: 20 ell_matmul for the classifier, 40 for the VAE (its encoder
# on the lifted operators, its decoder on the flat ones); a test batch
# half.  Dense and Dirac launch none.  Step 0 of the ELL and Dirac runs is
# held against fp64 on dense fp64 operators (the Dirac runs: the dense fp64
# pairs) with the step's own dropout mask or noise, module by module, with
# the ARAP bounds; the whole step's loss (and the VAE's KLD) within 1e-2, not
# ARAP's 1e-3: on the card the VAE's ELL step read 1.41e-3 (loss) and
# 1.93e-3 (KLD) from fp64, and the same step in fp32 on dense operators
# with no kernel the same 1.41e-3 (fp32 rounding where the cotan Laplacians
# of the Delaunay height fields cancel; PERF.md, section 6).
MNIST_DATA = {"num": 320, "seed": SEED, "n_points": 210}
MESH_LAYERS = 5
MNIST_WIDTH = 64
MESH_ARGS = {"mnist": ["--layer", str(MESH_LAYERS), "--batch-size", "64", "--seed", str(SEED), "--device", "cuda"],
             "vae": ["--num-layers", str(MESH_LAYERS), "--batch-size", "64", "--seed", str(SEED), "--device", "cuda"]}
MESH_STEPS = 8
MESH_DIRAC_STEPS = 4
MESH_STEP0_LOSS_RTOL = 1e-2
MESH_STEP0_CHAIN_RTOL = ARAP_STEP0_CHAIN_RTOL
MESH_STEP0_PARAM_RTOL = ARAP_STEP0_PARAM_RTOL
MESH_PER_STEP = {family: {"dense": launches_of(), "ell": launches_of(ell_matmul=4 * MESH_LAYERS * n),
                          "dirac": launches_of()} for family, n in (("mnist", 1), ("vae", 2))}
# Mixed precision (``--bf16``): the five trainers at the fp32 runs' widths,
# depths, batches and data, fewer steps: FAUST Lap-15 in ELL and in BSR (bf16
# blocks), both with --smooth-reg 0.1, so all three bf16 variants launch;
# normal Lap-15 in BSR (8 steps, as its fp32 run: the convergence check);
# ARAP Model-15 ELL at batch 32; the mesh-MNIST classifier Model-5 and
# LapVAE-5 in ELL at batch 64, the classifier in its default format at these
# sizes, dense (no kernel: the promoting ``dense_bmm``), and DirModel-5 (no
# kernel).  Per step the
# forward's applies take bf16 x (the bf16 variants) and the backward's take
# the fp32 cotangent (the fp32 kernels, or BSR's bf16 variant, which rounds
# it as it stages it); the SDDMM's backward sums take bf16 features; the
# dcel head's mirror takes the fp32 features.
BF16_STEPS = 4
BF16_NORMAL_STEPS = 8
BF16_PER_STEP = {
    "faust ell": launches_of(ell_matmul=33, ell_matmul_bf16=36, sddmm_bf16=2),
    "faust bsr": launches_of(ell_matmul=1, bsr_matmul_bf16=64, ell_matmul_bf16=4, sddmm_bf16=2),
    "normal bsr": launches_of(bsr_matmul_bf16=32),
    "arap ell": launches_of(ell_matmul=16, ell_matmul_bf16=16),
    "mnist ell": launches_of(ell_matmul=4 * MESH_LAYERS // 2, ell_matmul_bf16=4 * MESH_LAYERS // 2),
    "mnist dense": launches_of(),
    "vae ell": launches_of(ell_matmul=4 * MESH_LAYERS, ell_matmul_bf16=4 * MESH_LAYERS),
    "mnist dirac": launches_of(),
    "normal cas": launches_of(ell_matmul=14, ell_matmul_bf16=14),
}
# a test batch (FAUST: a test pair) runs the forward only: bf16 x into every apply
BF16_PER_TEST_BATCH = {
    "faust ell": launches_of(ell_matmul_bf16=32), "faust bsr": launches_of(bsr_matmul_bf16=32),
    "normal bsr": launches_of(bsr_matmul_bf16=16), "arap ell": launches_of(ell_matmul_bf16=16),
    "mnist ell": launches_of(ell_matmul_bf16=2 * MESH_LAYERS), "vae ell": launches_of(ell_matmul_bf16=4 * MESH_LAYERS),
    "mnist dense": launches_of(), "mnist dirac": launches_of(), "normal cas": launches_of(ell_matmul_bf16=14),
}
# Step 0 of each kernel run, module by module against the same modules in
# bf16 on the card with the kernels' plain versions (autograd through them)
# on the card's own inputs and output cotangents.  Both sides round to bf16
# at the same places; they differ only in the applies' fp32 summation order
# (about 1e-7 of a sum) and, in BSR's backward, the kernel's rounding of the
# fp32 cotangent to bf16 (at most 2^-8 of each value).  Where that moves a
# value across a bf16 rounding boundary it lands one ulp (at most 2^-7 of it)
# away: an output or cotangent within 4 x 2^-8 (relative Frobenius) leaves
# room for a few percent of such elements; a parameter's gradient, summed
# over thousands of rows that cancel, within 16 x 2^-8.  The reference with
# detached applies (the L^T path cut) must read above the chain's bound.
BF16_STEP0_CHAIN_RTOL = 4 * 2.0**-8
BF16_STEP0_PARAM_RTOL = 16 * 2.0**-8
# The JAX package's decisive bf16 check (tests/test_bf16.py): over the same
# steps from the same weights and data, the bf16 loss ends below 3x the fp32
# loss + 1e-3 (normal Lap-15 BSR, 8 steps, against the fp32 run's).
BF16_CONVERGENCE_FACTOR = 3.0


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float) -> None:
    log(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")


def time_ms(fn, reps: int = 20, per_rep: int = 10) -> float:
    """Device time of one ``fn()``: the median over ``reps`` of CUDA-event
    time of ``per_rep`` back-to-back calls, divided by ``per_rep``.  A sleep
    kernel holds the stream while the host queues the calls, so host
    overhead between launches does not enter the device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)  # ~2.5 ms at H100 clocks
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    times.sort()
    return times[len(times) // 2]


def host_us(fn, calls: int = 50) -> float:
    """Host time of one ``fn()`` call, not waiting for the device."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # keep the device busy so no call waits on it
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return dt


def bound_ms(n_bytes: int, flops: int, flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time for the work: bytes over HBM's rate or operations over
    ``flop_per_s`` (fp32 FMA unless given), whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cold_ms(fn, flush, reps: int = 15) -> float:
    """Device time of one ``fn()`` with a cold L2 cache: before each launch
    ``flush`` (``L2_FLUSH_BYTES``) is written, which evicts what the cache
    held, and the launch alone is timed by its own events.  Median over
    ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # the host queues the rest meanwhile
        flush.add_(1.0)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def ell_live_bytes(cols, vals, x, out) -> int:
    """Bytes of ``ell_matmul`` at its least: the table (cols and vals, each
    read once), the distinct rows of x that some live slot reads (each read
    once) and out."""
    rows = int(cols[vals != 0].unique().numel())
    return nbytes(cols, vals, out) + rows * x.shape[-1] * x.element_size()


def bsr_live_work(bcols, bvals, live, x, out) -> tuple[int, int]:
    """Bytes and operations of the bf16 ``bsr_matmul`` handed the live-chunk
    mask ``live`` (uint8 [NB, KB]): the live 64x32 chunks of the blocks, the
    32-row slices of x that some live chunk multiplies (each read once), the
    block-columns, the mask and out; 2 * 64 * 32 * C operations per live
    chunk."""
    import torch

    c = x.shape[-1]
    bits = live.to(torch.int32)
    n_live = int(sum(((bits >> b) & 1).sum() for b in range(8)))
    # x slice 4 col + d is read where depth chunk d of either half is live
    used = torch.stack([((bits >> d) | (bits >> (d + 4))) & 1 for d in range(4)], dim=-1).bool()
    slices = (bcols.long()[..., None] * 4 + torch.arange(4, device=bcols.device))[used].unique().numel()
    n_bytes = (n_live * 64 * 32 * bvals.element_size() + slices * 32 * c * x.element_size()
               + nbytes(bcols, live, out))
    return n_bytes, 2 * n_live * 64 * 32 * c


def _f64(a, like=None):
    """``a`` (a tensor or an array) as an fp64 tensor, on ``like``'s device
    where given: the checks run where the results lie."""
    import torch

    t = a.detach().double() if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, dtype=np.float64))
    return t if like is None else t.to(like.device)


def worst(got, ref, scale, rtol: float, ulps: int = 0) -> tuple[float, float]:
    """(max |got - ref|, max over elements of |got - ref| / (rtol * scale +
    ulps * bf16_ulp(ref) + TINY)); ``scale`` is |A| |x| at each element;
    ``ulps`` bf16 units of the reference where the result is bf16.
    Non-finite reads inf.  Computed in fp64 on ``got``'s device."""
    import torch

    got = _f64(got)
    ref, scale = _f64(ref, got), _f64(scale, got)
    err = (got - ref).abs()
    limit = rtol * scale + ulps * bf16_ulp(ref) + TINY
    ratio = float((err / limit).max()) if bool(torch.isfinite(got).all()) else float("inf")
    return float(err.max()), ratio


def bf16_ulp(ref):
    """One unit in the last place of each value of the fp64 tensor ``ref``
    as a bf16 number (8 significant bits: 2^(e - 7) for |v| in
    [2^e, 2^(e+1))), 0 at 0."""
    import torch

    a = ref.abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(torch.where(a > 0, a, 1.0))) - 7), 0.0)


def check(name: str, got, ref, scale, rtol: float, ulps: int = 0) -> float:
    """Max-abs error of ``got`` vs ``ref``; raises unless every element is
    within its limit (see ``worst``)."""
    err, ratio = worst(got, ref, scale, rtol, ulps)
    tol = f"tol {rtol:g} of |A||x|" + (f" + {ulps} bf16 ulp" if ulps else "")
    log(f"  {name}: max_abs_err={err:.3e} max|ref|={float(_f64(ref).abs().max()):.3e} "
        f"worst element {ratio:.3e} of its limit ({tol}) {'ok' if ratio <= 1 else 'FAIL'}")
    if not ratio <= 1:
        raise AssertionError(f"{name}: result disagrees with its reference")
    return err


def refused(name: str, got, ref, scale, rtol: float, ulps: int = 0) -> None:
    """The check's own test: a deliberately wrong result must read above its
    limit, or the run fails."""
    err, ratio = worst(got, ref, scale, rtol, ulps)
    log(f"  mutant {name}: max_abs_err={err:.3e}, worst element {ratio:.3e} of its limit "
        f"{'refused' if ratio > 1 else 'NOT refused'}")
    if not ratio > 1:
        raise AssertionError(f"mutant {name} passes the check")


def tf32_round(t):
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: what one tensor-core pass makes of an fp32 input."""
    import torch

    return ((t.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def kernel_phase(device) -> dict:
    """Hold the three kernels against their plain versions, in fp32 and in
    fp64, at the paths' shapes and at ragged, narrow, wide and batched ones;
    prove the checks refuse wrong results; time kernel, plain version and
    one library call, warm and with a cold L2 cache."""
    import torch

    from surfacenetworks_tpu_torch.data import Buckets, fit_bsr_k, laplacian_batch, rcm_reorder_sample
    from surfacenetworks_tpu_torch.data.datasets import random_blob_mesh
    from surfacenetworks_tpu_torch.geometry import igl_style_laplacian
    from surfacenetworks_tpu_torch.sparse import kernels, operator_from_scipy

    rng = np.random.default_rng(SEED + 100)
    V, F = random_blob_mesh(rng, 7000)
    sample = rcm_reorder_sample({"V": V, "F": F, "input": V.astype(np.float32),
                                 "L": igl_style_laplacian(V, F, hack=1.0)})
    buckets = Buckets(n_vertices=BUCKET)
    fit_bsr_k([sample], buckets)
    ell = laplacian_batch([sample], buckets, target_key="input", fmt="ell").operator.fwd.to(device)
    bsr = laplacian_batch([sample], buckets, target_key="input", fmt="bsr").operator.fwd.to(device)
    cols, vals = ell.cols[0], ell.vals[0]
    bcols, bvals = bsr.block_cols[0], bsr.block_vals[0]
    log(f"  operator: n={V.shape[0]} padded to {BUCKET}; ELL K={cols.shape[1]}; "
        f"BSR NB={bcols.shape[0]} KB={bcols.shape[1]}")
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"ell_matmul": 0.0, "bsr_matmul": 0.0}

    def held(kname, name, got, plain, c_, v_, *dense):
        """``got`` against ``plain`` on the same fp32 inputs and on them
        widened to fp64, each element within KERNEL_RTOL of its |A||x|."""
        ref = plain(c_, v_, *dense)
        scale = plain(c_, v_.double().abs(), *(t.double().abs() for t in dense))
        errs[kname] = max(errs[kname], check(f"{name} vs fp32 plain", got, ref, scale, KERNEL_RTOL))
        check(f"{name} vs fp64 plain", got, plain(c_, v_.double(), *(t.double() for t in dense)), scale, KERNEL_RTOL)

    def ell(name, c_, v_, x):
        held("ell_matmul", name, kernels.ell_matmul(c_, v_, x), kernels.ell_matmul_plain, c_, v_, x)

    def bsr(name, c_, v_, x, ref_cols=None, ref_vals=None):
        got = kernels.bsr_matmul(c_, v_, x)
        held("bsr_matmul", name, got, kernels.bsr_matmul_plain,
             c_ if ref_cols is None else ref_cols, v_ if ref_vals is None else ref_vals, x)

    for c in (WIDTH, FEATURES, 3):
        x = torch.randn(BUCKET, c, device=device, generator=gen)
        ell(f"ell_matmul R={BUCKET} K={cols.shape[1]} C={c}", cols, vals, x)
    for c in (WIDTH, FEATURES, 3, 136):
        x = torch.randn(BUCKET, c, device=device, generator=gen)
        bsr(f"bsr_matmul NB={bcols.shape[0]} KB={bcols.shape[1]} C={c}", bcols, bvals, x)
    # ragged ELL: the unpadded operator, R = n not a multiple of 128
    rag = operator_from_scipy(sample["L"]).fwd.to(device)
    x = torch.randn(rag.n_cols, WIDTH, device=device, generator=gen)
    ell(f"ell_matmul ragged R={rag.n_rows} K={rag.k} C={WIDTH}", rag.cols, rag.vals, x)
    # ragged K: 13 slots (the scalar pair loads), and 40 (two vector chunks and a partial one)
    x = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
    ell(f"ell_matmul ragged K=13 C={FEATURES}", cols[:, :13].contiguous(), vals[:, :13].contiguous(), x)
    c40 = torch.cat([cols, cols.roll(1, 0), cols[:, :8].roll(2, 0)], 1).contiguous()
    v40 = torch.cat([vals, vals.roll(1, 0) * 0.5, vals[:, :8].roll(2, 0) * 0.25], 1).contiguous()
    ell(f"ell_matmul ragged K=40 C={FEATURES}", c40, v40, x)
    # batched launch (B=2): the leading batch axis is one launch
    xb = torch.randn(2, BUCKET, WIDTH, device=device, generator=gen)
    ell("ell_matmul batched B=2", torch.stack([cols, cols]), torch.stack([vals, vals.flip(0)]), xb)
    bsr("bsr_matmul batched B=2", torch.stack([bcols, bcols]), torch.stack([bvals, bvals * 0.5]), xb)
    # block-columns outside [0, N/128): skipped by the kernel, held against
    # the plain version on the same slots emptied
    oob_cols, oob_vals = bcols.clone(), bvals.clone()
    n_blocks = BUCKET // 128
    for i, s, col in ((3, 0, -1), (bcols.shape[0] // 2, 1, n_blocks), (bcols.shape[0] - 1, 0, 1 << 20)):
        oob_cols[i, s] = col
        oob_vals[i, s] = 0
    ref_cols = torch.where((oob_cols < 0) | (oob_cols >= n_blocks), 0, oob_cols)
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen)
    bsr("bsr_matmul with 3 block-columns out of range", oob_cols, bvals, x, ref_cols, oob_vals)

    # the checks' power: a kernel that dropped one slot of one row must fail them
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen)
    r = BUCKET // 2
    s = int(torch.nonzero(vals[r])[0])
    dropped = vals.clone()
    dropped[r, s] = 0
    refused(f"ell_matmul without slot {s} of row {r}", kernels.ell_matmul(cols, dropped, x),
            kernels.ell_matmul_plain(cols, vals, x), kernels.ell_matmul_plain(cols, vals.abs(), x.abs()),
            KERNEL_RTOL)
    i = bcols.shape[0] // 2
    s = int(torch.nonzero(bvals[i].flatten(1).abs().sum(1))[0])
    dropped = bvals.clone()
    dropped[i, s] = 0
    bscale = kernels.bsr_matmul_plain(bcols, bvals.abs(), x.abs())
    bref = kernels.bsr_matmul_plain(bcols, bvals, x)
    refused(f"bsr_matmul without slot {s} of block-row {i}", kernels.bsr_matmul(bcols, dropped, x), bref, bscale,
            KERNEL_RTOL)
    # ... and one TF32 pass instead of three: the product of TF32-rounded inputs
    refused("bsr_matmul in one TF32 pass (inputs rounded to TF32)",
            kernels.bsr_matmul_plain(bcols, tf32_round(bvals), tf32_round(x)), bref, bscale, KERNEL_RTOL)

    # SDDMM at the smoothness term's shapes: the same fixed-k pattern, C=120
    errs["sddmm"] = 0.0

    def sdd(name, c_, v_, a, b):
        ref = kernels.sddmm_plain(c_, v_, a, b)
        scale = kernels.sddmm_plain(c_, v_, a.abs(), b.abs())  # sum_c |a_rc| |b_jc| at live slots
        errs["sddmm"] = max(errs["sddmm"], check(name, kernels.sddmm(c_, v_, a, b), ref, scale, KERNEL_RTOL))

    for c in (FEATURES, 3):
        a = torch.randn(BUCKET, c, device=device, generator=gen)
        b = torch.randn(BUCKET, c, device=device, generator=gen)
        sdd(f"sddmm R={BUCKET} K={cols.shape[1]} C={c}", cols, vals, a, b)
    fn = torch.nn.functional.normalize(a.new_empty(BUCKET, FEATURES).normal_(generator=gen), dim=-1)
    sdd(f"sddmm a=b (unit rows) C={FEATURES}", cols, vals, fn, fn)
    a = torch.randn(rag.n_rows, FEATURES, device=device, generator=gen)
    sdd(f"sddmm ragged R={rag.n_rows} K={rag.k}", rag.cols, rag.vals, a, a.flip(0))
    ab = torch.randn(2, BUCKET, FEATURES, device=device, generator=gen)
    sdd("sddmm batched B=2", torch.stack([cols, cols]), torch.stack([vals, vals.flip(0)]), ab, ab.flip(0))
    # the kernel's edges: each row's slots permuted, so padding sits between
    # live slots; K cut to 5, or widened past one chunk (17) and past one
    # group of 32 slots (33); C on the scalar path (3, 130, 257) and past 128
    # channels on the float4 path (264)
    perm = torch.argsort(torch.rand(cols.shape, device=device, generator=gen), dim=1)
    pc, pv = cols.gather(1, perm), vals.gather(1, perm)
    live = pv != 0
    log(f"  sddmm permuted pattern: {int((~live[:, :-1] & live[:, 1:]).any(1).sum())} of {BUCKET} rows have a "
        f"live slot after a padding slot")
    wide = {5: (pc[:, :5], pv[:, :5]),
            17: (torch.cat([pc, pc[:, :1].roll(1, 0)], 1), torch.cat([pv, pv[:, :1].roll(1, 0)], 1)),
            33: (torch.cat([pc, pc.roll(1, 0), pc[:, :1].roll(2, 0)], 1),
                 torch.cat([pv, pv.roll(1, 0) * 0.5, pv[:, :1].roll(2, 0)], 1))}
    wide = {kk: (c_.contiguous(), v_.contiguous()) for kk, (c_, v_) in wide.items()}
    for kk, (c_, v_) in [(cols.shape[1], (pc, pv)), *wide.items()]:
        a = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
        b = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
        sdd(f"sddmm permuted slots K={kk} C={FEATURES} (up to {int((v_ != 0).sum(1).max())} live slots a row)",
            c_, v_, a, b)
    for c in (3, 130, 257, 264):
        a = torch.randn(BUCKET, c, device=device, generator=gen)
        b = torch.randn(BUCKET, c, device=device, generator=gen)
        sdd(f"sddmm permuted slots K={cols.shape[1]} C={c}", pc, pv, a, b)
    a = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
    b = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
    for label, (c_, v_) in {"K=16": (cols, vals), "permuted K=33": wide[33]}.items():
        same = torch.equal(kernels.sddmm(c_, v_, a, b), kernels.sddmm(c_, v_, a, b))
        log(f"  sddmm {label}: two launches on the same inputs {'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"sddmm {label}: two launches on the same inputs differ")
    # the checks' power: a kernel that dropped one slot of one row must fail
    # them, and so must one that stopped after its first chunk of live slots
    r = BUCKET // 2
    s = int(torch.nonzero(vals[r])[0])
    dropped = vals.clone()
    dropped[r, s] = 0
    refused(f"sddmm without slot {s} of row {r}", kernels.sddmm(cols, dropped, a, b),
            kernels.sddmm_plain(cols, vals, a, b), kernels.sddmm_plain(cols, vals, a.abs(), b.abs()), KERNEL_RTOL)
    c33, v33 = wide[33]
    r = int((v33 != 0).sum(1).argmax())
    s = int(torch.nonzero(v33[r])[-1])
    dropped = v33.clone()
    dropped[r, s] = 0
    refused(f"sddmm permuted K=33 without the last live slot ({s}) of row {r}, which has "
            f"{int((v33[r] != 0).sum())}", kernels.sddmm(c33, dropped, a, b),
            kernels.sddmm_plain(c33, v33, a, b), kernels.sddmm_plain(c33, v33, a.abs(), b.abs()), KERNEL_RTOL)

    # timing at the serving shape (C=128)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen)
    csr = sample["L"].tocsr().astype(np.float32)
    csr.resize((BUCKET, BUCKET))
    lib_csr = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int64)), torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.data), size=csr.shape).to(device)
    csr_ms = time_ms(lambda: torch.sparse.mm(lib_csr, x))
    report = {}

    nnz = int((vals != 0).sum())
    out = torch.empty(BUCKET, WIDTH, device=device)
    log(f"  ell_matmul: {nnz} live slots, {nnz / BUCKET:.2f} per row: the gathers read "
        f"{nnz * WIDTH * 4 / 1e6:.1f} MB of x rows through the L2 cache at C={WIDTH}, x itself is "
        f"{BUCKET * WIDTH * 4 / 1e6:.1f} MB")
    b_ms, b_by = bound_ms(nbytes(cols, vals, x, out), 2 * nnz * WIDTH)
    report["ell_matmul"] = {
        "ms": time_ms(lambda: kernels.ell_matmul(cols, vals, x)),
        "cold_ms": cold_ms(lambda: kernels.ell_matmul(cols, vals, x), flush),
        "plain_ms": time_ms(lambda: kernels.ell_matmul_plain(cols, vals, x)),
        "library_ms": csr_ms,
        "library_call": "torch.sparse.mm(csr, x)",
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(cols, vals, x, out), "flops": 2 * nnz * WIDTH,
    }
    nnzb = int((bvals != 0).flatten(2).any(dim=2).sum())
    flops = 2 * nnzb * 128 * 128 * WIDTH
    # the kernel's products run on the tensor cores in three TF32 passes;
    # the fp32-FMA bound (67 TFLOP/s, outside the tensor cores) is kept beside it
    b_ms, b_by = bound_ms(nbytes(bcols, bvals, x, out), TF32_PASSES * flops, TF32_FLOP_PER_S)
    fma_ms, fma_by = bound_ms(nbytes(bcols, bvals, x, out), flops)
    lib_ms, lib_call = csr_ms, "torch.sparse.mm(csr, x)"
    try:  # the same operator in PyTorch's own BSR layout, where CUDA supports it
        lib_bsr = lib_csr.to_dense().to_sparse_bsr((128, 128))
        lib_ms, lib_call = time_ms(lambda: torch.sparse.mm(lib_bsr, x)), "torch.sparse.mm(bsr128, x)"
    except (RuntimeError, NotImplementedError) as e:
        log(f"  library BSR call unavailable ({type(e).__name__}: {str(e)[:120]}); using CSR")
    report["bsr_matmul"] = {
        "ms": time_ms(lambda: kernels.bsr_matmul(bcols, bvals, x)),
        "cold_ms": cold_ms(lambda: kernels.bsr_matmul(bcols, bvals, x), flush),
        "plain_ms": time_ms(lambda: kernels.bsr_matmul_plain(bcols, bvals, x)),
        "library_ms": lib_ms, "library_call": lib_call,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(bcols, bvals, x, out), "flops": flops,
        "fp32_fma_bound_ms": fma_ms, "fp32_fma_bound_by": fma_by,
        "nonzero_blocks": nnzb, "slots": bcols.numel(),
    }
    # how much of the stored blocks is zero in each CTA's 64-row x 32-deep chunk
    sub = (bvals != 0).reshape(bvals.shape[0], bvals.shape[1], 2, 64, 4, 32).any(dim=5).any(dim=3)
    log(f"  bsr_matmul: {float(sub.float().mean()):.3f} of the stored blocks' 64x32 chunks hold a nonzero "
        f"(the rest multiply zeros); {nnzb} of {bcols.numel()} stored blocks do")
    log(f"  bsr_matmul bound: {b_ms:.5f} ms by {b_by} (3 TF32 passes at 495 TFLOP/s: "
        f"{TF32_PASSES * flops / TF32_FLOP_PER_S * 1e3:.5f} ms; bytes at 3.35 TB/s: "
        f"{nbytes(bcols, bvals, x, out) / HBM_BYTES_PER_S * 1e3:.5f} ms); the fp32-FMA bound "
        f"(67 TFLOP/s) reads {fma_ms:.5f} ms by {fma_by}")
    # SDDMM timing at the smoothness term's shape (C=120)
    live = vals != 0
    nnz = int(live.sum())
    sd_out = torch.empty(BUCKET, cols.shape[1], device=device)
    b_ms, b_by = bound_ms(nbytes(cols, vals, a, b, sd_out), 2 * nnz * FEATURES)
    crow = torch.zeros(BUCKET + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(live.sum(1), 0)
    pattern = torch.sparse_csr_tensor(crow, cols[live].long(), torch.ones(nnz, device=device),
                                      size=(BUCKET, BUCKET))
    bt = b.T.contiguous()
    lib_ms, lib_call = None, "torch.sparse.sampled_addmm(csr, a, b.T, beta=0)"
    try:
        lib_ms = time_ms(lambda: torch.sparse.sampled_addmm(pattern, a, bt, beta=0.0))
    except (RuntimeError, NotImplementedError) as e:
        log(f"  library SDDMM unavailable ({type(e).__name__}: {str(e)[:120]})")
    log(f"  sddmm bound: {b_ms:.5f} ms by {b_by} ({nbytes(cols, vals, a, b, sd_out) / 1e6:.1f} MB, a and b read "
        f"once each); where a and b are one tensor, as in the smoothness term, it reads "
        f"{nbytes(cols, vals, a, sd_out) / 1e6:.1f} MB: {nbytes(cols, vals, a, sd_out) / HBM_BYTES_PER_S * 1e3:.5f} ms "
        f"(information only)")
    report["sddmm"] = {
        "ms": time_ms(lambda: kernels.sddmm(cols, vals, a, b)),
        "cold_ms": cold_ms(lambda: kernels.sddmm(cols, vals, a, b), flush),
        "plain_ms": time_ms(lambda: kernels.sddmm_plain(cols, vals, a, b)),
        "library_ms": lib_ms, "library_call": lib_call,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(cols, vals, a, b, sd_out),
        "flops": 2 * nnz * FEATURES,
    }
    l2_bytes = nnz * FEATURES * 4 + nbytes(cols, vals, a, sd_out)
    log(f"  sddmm: the gathers read {nnz * FEATURES * 4 / 1e6:.1f} MB of b rows through the L2 cache; with a, the "
        f"pattern and the output the kernel moves {l2_bytes / 1e6:.1f} MB, {l2_bytes / report['sddmm']['ms'] / 1e9:.2f} "
        f"TB/s at its warm time")
    # ell_matmul at the widths of the backward's sums: C=120 over the transpose map
    x120 = torch.randn(BUCKET, FEATURES, device=device, generator=gen)
    report["ell_matmul"]["ms_c120"] = time_ms(lambda: kernels.ell_matmul(cols, vals, x120))
    report["sddmm"]["host_us"] = host_us(lambda: kernels.sddmm(cols, vals, a, b))
    report["ell_matmul"]["host_us"] = host_us(lambda: kernels.ell_matmul(cols, vals, x))
    report["bsr_matmul"]["host_us"] = host_us(lambda: kernels.bsr_matmul(bcols, bvals, x))
    del flush
    for name, r in report.items():
        r["max_abs_err"] = errs[name]
        lib = "not measured" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name}: {r['ms']:.5f} ms warm, {r['cold_ms']:.5f} ms cold L2 (plain {r['plain_ms']:.4f}, "
            f"{r['library_call']} {lib}, bound {r['bound_ms']:.5f} by {r['bound_by']}); "
            f"host {r['host_us']:.1f} us per call")
    log(f"  ell_matmul at C={FEATURES}: {report['ell_matmul']['ms_c120']:.5f} ms warm")
    return report


def bf16_operands(device) -> tuple:
    """The bf16 kernel phase's mesh and operators on ``device``: the sample
    (a ~7,000-vertex blob mesh and its Laplacian ``L`` in RCM order), and
    ``L`` padded to ``BUCKET`` as an ELL operator (fp32 values) and as a BSR
    operator of bf16 128x128 blocks with its live-chunk masks."""
    import torch

    from surfacenetworks_tpu_torch.data import Buckets, fit_bsr_k, laplacian_batch, rcm_reorder_sample
    from surfacenetworks_tpu_torch.data.datasets import random_blob_mesh
    from surfacenetworks_tpu_torch.geometry import igl_style_laplacian

    rng = np.random.default_rng(SEED + 100)
    V, F = random_blob_mesh(rng, 7000)
    sample = rcm_reorder_sample({"V": V, "F": F, "input": V.astype(np.float32),
                                 "L": igl_style_laplacian(V, F, hack=1.0)})
    buckets = Buckets(n_vertices=BUCKET)
    fit_bsr_k([sample], buckets)
    ell_op = laplacian_batch([sample], buckets, target_key="input", fmt="ell").operator.to(device)
    bsr_op = laplacian_batch([sample], buckets, target_key="input", fmt="bsr",
                             op_dtype=torch.bfloat16).operator.to(device)
    return sample, ell_op, bsr_op


def bf16_kernel_phase(device) -> dict:
    """Hold the three kernels' bf16 variants against their plain versions
    on the card, forward and backward, at the paths' shapes (N=7,040, ELL
    K=16 and BSR KB=5 at C=128; the SDDMM at K=16, C=120) and at ragged,
    narrow, wide and batched ones (ELL at every rows-per-warp case; BSR
    with and without the live-chunk mask, bit-identical); two launches bit
    for bit; a BSR mutant that truncates x to bf16 instead of rounding it to
    nearest even, a live mask with one live chunk cleared, and a dropped
    slot, refused; then each variant's warm and cold-L2 time, its plain
    version's and the bound at bf16 bytes (or bf16 tensor-core operations
    where that is larger).  fp32 results are held to KERNEL_RTOL
    of |A||x| over the bf16-rounded inputs; a bf16 result (the SDDMM's, its
    gradients) to one bf16 ulp of the plain result more."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels, operator_from_scipy, ops

    bf = torch.bfloat16
    sample, ell_op, bsr_op = bf16_operands(device)
    cols, vals = ell_op.fwd.cols[0], ell_op.fwd.vals[0]
    bcols, bvals = bsr_op.fwd.block_cols[0], bsr_op.fwd.block_vals[0]
    assert bvals.dtype == bf
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    errs = {"bsr_matmul_bf16": 0.0, "ell_matmul_bf16": 0.0, "sddmm_bf16": 0.0}
    eplain, bplain, splain = kernels.ell_matmul_plain, kernels.bsr_matmul_plain, kernels.sddmm_plain

    def held(kname, name, got, ref, scale, ulps=0):
        errs[kname] = max(errs[kname], check(name, got, ref, scale, KERNEL_RTOL, ulps))

    def bits_equal(name, a, b):
        same = torch.equal(a, b)
        log(f"  {name}: {'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{name}: differ")

    def same_twice(name, fn):
        bits_equal(f"{name}: two launches on the same inputs", fn(), fn())

    # BSR: bf16 blocks on fp32 x (the backward's cotangents) and on bf16 x (the forward's activations),
    # reading every chunk and skipping the dead ones (the operator's live-chunk mask): the same bits
    blive = bsr_op.fwd_live[0]
    n_live = sum(bin(v).count("1") for v in blive.flatten().tolist())
    log(f"  bsr_matmul bf16: the live-chunk mask keeps {n_live} of {8 * blive.numel()} stored 64x32 chunks")
    for c in (WIDTH, FEATURES, 3, 136):
        for xd in (torch.float32, bf):
            x = torch.randn(BUCKET, c, device=device, generator=gen).to(xd)
            scale = bplain(bcols, bvals.double().abs(), x.to(bf).double().abs())
            ref = bplain(bcols, bvals, x)
            name = f"bsr_matmul bf16 blocks, {str(xd)[6:]} x, C={c}"
            every = kernels.bsr_matmul(bcols, bvals, x)
            skipping = kernels.bsr_matmul(bcols, bvals, x, blive)
            held("bsr_matmul_bf16", name, every, ref, scale)
            held("bsr_matmul_bf16", f"{name}, live mask", skipping, ref, scale)
            bits_equal(f"{name}: with and without the live mask", every, skipping)
    xb = torch.randn(2, BUCKET, WIDTH, device=device, generator=gen)
    bc2, bv2, bl2 = torch.stack([bcols, bcols]), torch.stack([bvals, bvals * 0.5]), torch.stack([blive, blive])
    held("bsr_matmul_bf16", "bsr_matmul bf16 batched B=2", kernels.bsr_matmul(bc2, bv2, xb), bplain(bc2, bv2, xb),
         bplain(bc2, bv2.double().abs(), xb.to(bf).double().abs()))
    held("bsr_matmul_bf16", "bsr_matmul bf16 batched B=2, live mask", kernels.bsr_matmul(bc2, bv2, xb, bl2),
         bplain(bc2, bv2, xb), bplain(bc2, bv2.double().abs(), xb.to(bf).double().abs()))
    # the checks' power over the mask: one live chunk's bit cleared must be refused
    i = bcols.shape[0] // 2
    s_ = int(torch.nonzero(blive[i])[0])
    mutant = blive.clone()
    bit = int(mutant[i, s_]) & -int(mutant[i, s_])
    mutant[i, s_] = int(mutant[i, s_]) & ~bit
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen).to(bf)
    refused(f"bsr_matmul bf16 with live-mask bit {bit.bit_length() - 1} of slot {s_} of block-row {i} cleared",
            kernels.bsr_matmul(bcols, bvals, x, mutant), bplain(bcols, bvals, x),
            bplain(bcols, bvals.double().abs(), x.double().abs()), KERNEL_RTOL)
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen)
    scale = bplain(bcols, bvals.double().abs(), x.to(bf).double().abs())
    truncated = (x.view(torch.int32) & -65536).view(torch.float32)
    refused("bsr_matmul bf16 with x truncated to bf16 (not rounded to nearest even)",
            bplain(bcols, bvals, truncated), bplain(bcols, bvals, x), scale, KERNEL_RTOL)
    same_twice("bsr_matmul bf16", lambda: kernels.bsr_matmul(bcols, bvals, x))
    # the autograd Function: bf16 x, an fp32 cotangent through the stored transpose's bf16 blocks, cast to bf16
    xr = torch.randn(1, BUCKET, WIDTH, device=device, generator=gen).to(bf).requires_grad_()
    g = torch.randn(1, BUCKET, WIDTH, device=device, generator=gen)
    out = ops.bsr_spmm(bsr_op, xr)
    out.backward(g)
    bwd = bsr_op.bwd
    held("bsr_matmul_bf16", "bsr_spmm bf16 forward (fp32 out)", out, bplain(bsr_op.fwd.block_cols, bsr_op.fwd.block_vals,
                                                                             xr.detach()),
         bplain(bsr_op.fwd.block_cols, bsr_op.fwd.block_vals.double().abs(), xr.detach().double().abs()))
    held("bsr_matmul_bf16", "bsr_spmm bf16 backward x_bar (bf16)", xr.grad,
         bplain(bwd.block_cols, bwd.block_vals, g).to(bf), bplain(bwd.block_cols, bwd.block_vals.double().abs(),
                                                                  g.to(bf).double().abs()), ulps=1)

    # ELL: fp32 values on bf16 x, at every rows-per-warp case of the kernel (C=128 and 120: 2 rows a
    # warp; 64: 4; 32: 8; 8: 32; 264: one row in two channel passes; 3 and 130: the scalar path, 8 and 1)
    def ell16(name, c_, v_, x):
        held("ell_matmul_bf16", name, kernels.ell_matmul(c_, v_, x), eplain(c_, v_, x),
             eplain(c_, v_.double().abs(), x.double().abs()))

    for c in (WIDTH, FEATURES, MNIST_WIDTH, 32, 8, 3, 130, 264):
        x = torch.randn(BUCKET, c, device=device, generator=gen).to(bf)
        ell16(f"ell_matmul bf16 x, C={c}", cols, vals, x)
    rag = operator_from_scipy(sample["L"]).fwd.to(device)
    for c in (WIDTH, MNIST_WIDTH, 8):  # R = n_rows is no multiple of the rows a warp holds: the last group idles
        x = torch.randn(rag.n_cols, c, device=device, generator=gen).to(bf)
        ell16(f"ell_matmul bf16 x ragged R={rag.n_rows} K={rag.k} C={c}", rag.cols, rag.vals, x)
    for c in (WIDTH, MNIST_WIDTH):
        x = torch.randn(2, BUCKET, c, device=device, generator=gen).to(bf)
        ell16(f"ell_matmul bf16 x batched B=2 C={c}", torch.stack([cols, cols]), torch.stack([vals, vals.flip(0)]), x)
    for c in (MNIST_WIDTH, 8, 3):
        x = torch.randn(BUCKET, c, device=device, generator=gen).to(bf)
        same_twice(f"ell_matmul bf16 x C={c}", lambda: kernels.ell_matmul(cols, vals, x))
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen).to(bf)
    r = BUCKET // 2
    s_ = int(torch.nonzero(vals[r])[0])
    dropped = vals.clone()
    dropped[r, s_] = 0
    refused(f"ell_matmul bf16 x without slot {s_} of row {r}", kernels.ell_matmul(cols, dropped, x), eplain(cols, vals, x),
            eplain(cols, vals.double().abs(), x.double().abs()), KERNEL_RTOL)
    same_twice("ell_matmul bf16 x", lambda: kernels.ell_matmul(cols, vals, x))
    xr = torch.randn(1, BUCKET, WIDTH, device=device, generator=gen).to(bf).requires_grad_()
    g = torch.randn(1, BUCKET, WIDTH, device=device, generator=gen)
    ops.spmm(ell_op, xr).backward(g)
    held("ell_matmul_bf16", "spmm bf16 backward x_bar (bf16)", xr.grad, eplain(ell_op.bwd.cols, ell_op.bwd.vals, g).to(bf),
         eplain(ell_op.bwd.cols, ell_op.bwd.vals.double().abs(), g.double().abs()), ulps=1)

    # SDDMM: bf16 a and b, bf16 out (one ulp)
    def sdd(name, c_, v_, a, b):
        held("sddmm_bf16", name, kernels.sddmm(c_, v_, a, b), splain(c_, v_, a, b),
             splain(c_, v_, a.double().abs(), b.double().abs()), ulps=1)

    fn = torch.nn.functional.normalize(torch.randn(BUCKET, FEATURES, device=device, generator=gen), dim=-1).to(bf)
    sdd(f"sddmm bf16 a=b (unit rows) K={cols.shape[1]} C={FEATURES}", cols, vals, fn, fn)
    perm = torch.argsort(torch.rand(cols.shape, device=device, generator=gen), dim=1)
    pc, pv = cols.gather(1, perm), vals.gather(1, perm)
    c33 = torch.cat([pc, pc.roll(1, 0), pc[:, :1].roll(2, 0)], 1).contiguous()
    v33 = torch.cat([pv, pv.roll(1, 0) * 0.5, pv[:, :1].roll(2, 0)], 1).contiguous()
    for kk, (c_, v_) in {5: (pc[:, :5].contiguous(), pv[:, :5].contiguous()), cols.shape[1]: (pc, pv),
                         33: (c33, v33)}.items():
        a = torch.randn(BUCKET, FEATURES, device=device, generator=gen).to(bf)
        b = torch.randn(BUCKET, FEATURES, device=device, generator=gen).to(bf)
        sdd(f"sddmm bf16 permuted slots K={kk} C={FEATURES}", c_, v_, a, b)
    # every lane-group size: 4 lanes a row (C=3, 8, 16), 8 (64), 16 (120), 32 (130, 264: channel passes)
    for c in (3, 8, 16, 64, 130, 264):
        a = torch.randn(BUCKET, c, device=device, generator=gen).to(bf)
        b = torch.randn(BUCKET, c, device=device, generator=gen).to(bf)
        sdd(f"sddmm bf16 permuted slots K={cols.shape[1]} C={c}", pc, pv, a, b)
    for c in (FEATURES, MNIST_WIDTH, 8):  # R = n_rows is no multiple of the rows a warp holds
        a = torch.randn(rag.n_rows, c, device=device, generator=gen).to(bf)
        b = torch.randn(rag.n_cols, c, device=device, generator=gen).to(bf)
        sdd(f"sddmm bf16 ragged R={rag.n_rows} K={rag.k} C={c}", rag.cols, rag.vals, a, b)
    for c in (FEATURES, MNIST_WIDTH):
        a = torch.randn(2, BUCKET, c, device=device, generator=gen).to(bf)
        b = torch.randn(2, BUCKET, c, device=device, generator=gen).to(bf)
        sdd(f"sddmm bf16 batched B=2 K={cols.shape[1]} C={c}", torch.stack([cols, cols]),
            torch.stack([vals, vals.flip(0)]), a, b)
    a = torch.randn(BUCKET, FEATURES, device=device, generator=gen).to(bf)
    b = torch.randn(BUCKET, FEATURES, device=device, generator=gen).to(bf)
    same_twice("sddmm bf16 K=16", lambda: kernels.sddmm(cols, vals, a, b))
    same_twice("sddmm bf16 permuted K=33", lambda: kernels.sddmm(c33, v33, a, b))
    r = BUCKET // 2
    s_ = int(torch.nonzero(vals[r])[0])
    dropped = vals.clone()
    dropped[r, s_] = 0
    refused(f"sddmm bf16 without slot {s_} of row {r}", kernels.sddmm(cols, dropped, a, b), splain(cols, vals, a, b),
            splain(cols, vals, a.double().abs(), b.double().abs()), KERNEL_RTOL, ulps=1)
    # the autograd Function: bf16 da and db (the cotangent widened to fp32, exactly, into the ELL sums)
    ar, br = (t[None].clone().requires_grad_() for t in (a, b))
    gs = torch.randn(1, BUCKET, cols.shape[1], device=device, generator=gen).to(bf)
    ops.sddmm(ell_op, ar, br).backward(gs)
    a64, b64 = (t[None].double().requires_grad_() for t in (a, b))
    (splain(ell_op.fwd.cols, ell_op.fwd.vals, a64, b64) * gs.double()).sum().backward()
    a_abs, b_abs = (t[None].double().abs().requires_grad_() for t in (a, b))
    (splain(ell_op.fwd.cols, ell_op.fwd.vals, a_abs, b_abs) * gs.double().abs()).sum().backward()
    held("sddmm_bf16", "sddmm bf16 backward da (bf16)", ar.grad, a64.grad.to(bf), a_abs.grad, ulps=1)
    held("sddmm_bf16", "sddmm bf16 backward db (bf16)", br.grad, b64.grad.to(bf), b_abs.grad, ulps=1)

    # timing at the paths' shapes: BSR and ELL at C=128 on bf16 x, the SDDMM at C=120 on a = b
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)
    report = {}
    x = torch.randn(BUCKET, WIDTH, device=device, generator=gen).to(bf)
    xf = x.float()
    out = torch.empty(BUCKET, WIDTH, device=device)
    # the path's call is handed the operator's mask and skips the dead chunks: its bound counts the live
    # chunks and the x slices they read; every stored byte bounds the call without the mask
    nnzb = int((bvals != 0).flatten(2).any(dim=2).sum())
    flops_all = 2 * nnzb * 128 * 128 * WIDTH
    all_ms, all_by = bound_ms(nbytes(bcols, bvals, x, out), flops_all, BF16_TENSOR_FLOP_PER_S)
    live_bytes, flops = bsr_live_work(bcols, bvals, blive, x, out)
    b_ms, b_by = bound_ms(live_bytes, flops, BF16_TENSOR_FLOP_PER_S)
    report["bsr_matmul_bf16"] = {
        "ms": time_ms(lambda: kernels.bsr_matmul(bcols, bvals, x, blive)),
        "cold_ms": cold_ms(lambda: kernels.bsr_matmul(bcols, bvals, x, blive), flush),
        "ms_x_fp32": time_ms(lambda: kernels.bsr_matmul(bcols, bvals, xf, blive)),
        "ms_no_live": time_ms(lambda: kernels.bsr_matmul(bcols, bvals, x)),
        "ms_x_fp32_no_live": time_ms(lambda: kernels.bsr_matmul(bcols, bvals, xf)),
        "cold_ms_no_live": cold_ms(lambda: kernels.bsr_matmul(bcols, bvals, x), flush),
        "plain_ms": time_ms(lambda: bplain(bcols, bvals, x)),
        "library_ms": None, "library_call": "none: no PyTorch call rounds x to bf16 and returns the fp32 sums",
        "bound_ms": b_ms, "bound_by": b_by, "bytes": live_bytes, "flops": flops,
        "bound_ms_no_live": all_ms, "bound_by_no_live": all_by, "bytes_no_live": nbytes(bcols, bvals, x, out),
        "flops_no_live": flops_all, "live_chunks": n_live, "chunks": 8 * blive.numel()}
    log(f"  bsr_matmul bf16 bound: {b_ms:.5f} ms by {b_by} (the live chunks, the x slices they read, cols, mask and "
        f"out: {live_bytes / 1e6:.2f} MB); without the mask every stored byte: {all_ms:.5f} ms by {all_by} "
        f"({nbytes(bcols, bvals, x, out) / 1e6:.2f} MB)")
    nnz = int((vals != 0).sum())
    b_ms, b_by = bound_ms(nbytes(cols, vals, x, out), 2 * nnz * WIDTH)
    report["ell_matmul_bf16"] = {
        "ms": time_ms(lambda: kernels.ell_matmul(cols, vals, x)),
        "cold_ms": cold_ms(lambda: kernels.ell_matmul(cols, vals, x), flush),
        "fp32_kernel_ms": time_ms(lambda: kernels.ell_matmul(cols, vals, xf)),
        "plain_ms": time_ms(lambda: eplain(cols, vals, x)),
        "library_ms": None, "library_call": "none: torch.sparse.mm takes no fp32 operator on bf16 x",
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(cols, vals, x, out), "flops": 2 * nnz * WIDTH}
    live = vals != 0
    sd_out = torch.empty(BUCKET, cols.shape[1], device=device, dtype=bf)
    # a and b apart, as the fp32 row is timed (the smoothness term's a is b: fewer bytes)
    b_ms, b_by = bound_ms(nbytes(cols, vals, a, b, sd_out), 2 * nnz * FEATURES)
    log(f"  sddmm bf16 bound: {b_ms:.5f} ms by {b_by} ({nbytes(cols, vals, a, b, sd_out) / 1e6:.2f} MB); where a is "
        f"b, {nbytes(cols, vals, a, sd_out) / 1e6:.2f} MB, {nbytes(cols, vals, a, sd_out) / HBM_BYTES_PER_S * 1e3:.5f} ms "
        f"(information only)")
    crow = torch.zeros(BUCKET + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(live.sum(1), 0)
    pattern = torch.sparse_csr_tensor(crow, cols[live].long(), torch.ones(nnz, device=device, dtype=bf),
                                      size=(BUCKET, BUCKET))
    bt = b.T.contiguous()
    lib_ms, lib_call = None, "torch.sparse.sampled_addmm(bf16 csr, a, b.T, beta=0)"
    try:
        lib_ms = time_ms(lambda: torch.sparse.sampled_addmm(pattern, a, bt, beta=0.0))
    except (RuntimeError, NotImplementedError) as e:
        lib_call = f"none: {lib_call} unavailable ({type(e).__name__})"
        log(f"  library bf16 SDDMM unavailable ({type(e).__name__}: {str(e)[:120]})")
    report["sddmm_bf16"] = {
        "ms": time_ms(lambda: kernels.sddmm(cols, vals, a, b)),
        "cold_ms": cold_ms(lambda: kernels.sddmm(cols, vals, a, b), flush),
        "ms_a_is_b": time_ms(lambda: kernels.sddmm(cols, vals, fn, fn)),
        "plain_ms": time_ms(lambda: splain(cols, vals, a, b)),
        "library_ms": lib_ms, "library_call": lib_call,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(cols, vals, a, b, sd_out), "flops": 2 * nnz * FEATURES}
    del flush
    for name, r in report.items():
        r["max_abs_err"] = errs[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name}: {r['ms']:.5f} ms warm, {r['cold_ms']:.5f} ms cold L2 (plain {r['plain_ms']:.4f}, library {lib}, "
            f"bound {r['bound_ms']:.5f} by {r['bound_by']}: {r['bytes'] / 1e6:.2f} MB, {r['bound_ms'] / r['ms']:.1%} of it)")
    r = report["bsr_matmul_bf16"]
    log(f"  bsr_matmul bf16 on fp32 x (the backward's cotangents): {r['ms_x_fp32']:.5f} ms warm; every chunk read "
        f"(no live mask): {r['ms_no_live']:.5f} ms on bf16 x, {r['ms_x_fp32_no_live']:.5f} ms on fp32 x, "
        f"{r['cold_ms_no_live']:.5f} ms cold ({r['bound_ms_no_live'] / r['ms_no_live']:.1%} of its bound "
        f"{r['bound_ms_no_live']:.5f}); ell_matmul's fp32 kernel on the same values at fp32 x: "
        f"{report['ell_matmul_bf16']['fp32_kernel_ms']:.5f} ms warm; "
        f"sddmm bf16 where a is b (unit rows, the smoothness term): {report['sddmm_bf16']['ms_a_is_b']:.5f} ms warm")
    return report


def serve_phase(device) -> tuple[dict, dict, dict, list]:
    """Serve LapDeepModel-15 on four ~7,000-vertex requests in both formats;
    returns the kernels' launch counts from that run, the latencies,
    (server, first prepared request) per format, and the prepared ELL
    requests."""
    import torch

    from surfacenetworks_tpu_torch.data import Buckets, laplacian_batch
    from surfacenetworks_tpu_torch.data.datasets import random_blob_mesh
    from surfacenetworks_tpu_torch.geometry import igl_style_laplacian
    from surfacenetworks_tpu_torch.models import LapDeepModel, init_weights
    from surfacenetworks_tpu_torch.serve import NormalServer
    from surfacenetworks_tpu_torch.sparse import kernels

    rng = np.random.default_rng(SEED)
    meshes = [random_blob_mesh(rng, int(rng.integers(6500, 7001))) for _ in range(N_REQUESTS)]
    model = init_weights(LapDeepModel(3, 3, layers=LAYERS), torch.Generator().manual_seed(SEED))
    servers = {fmt: NormalServer(model, device=device, fmt=fmt, bucket=BUCKET) for fmt in ("ell", "bsr")}
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the served model must run in full fp32, not TF32")
    log(f"  tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    prepared = {fmt: [s.prepare(V, F) for V, F in meshes] for fmt, s in servers.items()}
    log(f"  host build of {2 * N_REQUESTS} operators: {time.perf_counter() - t0:.3f} s; "
        f"vertices {[V.shape[0] for V, _ in meshes]}")
    for fmt, s in servers.items():  # warm-up: first-call library set-up
        s.answer(prepared[fmt][0])
        s.device_ms = []

    # the main path: every count is 0 just before it and read just after
    kernels.reset_launch_counts()
    answers, latency = {}, {}
    for fmt, s in servers.items():
        other = "bsr_matmul" if fmt == "ell" else "ell_matmul"
        mine = f"{fmt}_matmul"
        answers[fmt] = []
        for req in prepared[fmt]:
            before = dict(kernels.launches)
            answers[fmt].append(s.answer(req))
            d_mine = kernels.launches[mine] - before[mine]
            d_other = kernels.launches[other] - before[other]
            if d_mine != APPLIES_PER_FORWARD or d_other != 0:
                raise AssertionError(f"{fmt} forward launched {mine} {d_mine}x and {other} {d_other}x")
        latency[fmt] = {"median_ms": float(np.median(s.device_ms)), "ms": s.device_ms}
    counts = dict(kernels.launches)
    log(f"  launches on the main path: {counts}")
    for fmt in servers:
        log(f"  {fmt}: per-request device ms {['%.3f' % t for t in latency[fmt]['ms']]}, "
            f"median {latency[fmt]['median_ms']:.3f}")

    # fp64 forward on a dense operator, no kernel: the arbiter of both formats
    from surfacenetworks_tpu_torch.nn import apply_operator

    model64 = copy.deepcopy(servers["ell"].model).double()
    for i, (V, F) in enumerate(meshes):
        n = V.shape[0]
        L = igl_style_laplacian(V, F, hack=1.0).astype(np.float32).astype(np.float64)
        x = V.astype(np.float32).astype(np.float64)
        lx, scale = L @ x, abs(L) @ abs(x)
        for fmt in servers:
            req = prepared[fmt][i]
            with torch.inference_mode():
                rows = apply_operator(req.operator, req.inputs)[0, :n].double().cpu().numpy()
            got = rows.copy()
            if req.perm is not None:
                got[req.perm] = rows
            check(f"request {i} {fmt} operator pipeline", got, lx, scale, PIPELINE_RTOL)
            if i == 0 and req.perm is not None:  # the check's power: rows left in RCM order
                refused(f"request {i} {fmt} operator rows left in RCM order", rows, lx, scale, PIPELINE_RTOL)
        sample = {"V": V, "F": F, "input": V, "L": L}
        batch = laplacian_batch([sample], Buckets(n_vertices=BUCKET), target_key="input", fmt="dense")
        with torch.inference_mode():
            ref = model64(batch.operator.to(device).double(), batch.mask.to(device).double(),
                          batch.inputs.to(device).double())[0, :n].cpu().numpy()
        fro = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(ref))
        e, b = answers["ell"][i], answers["bsr"][i]
        ok = (e.shape == b.shape == (n, 3) and np.isfinite(e).all() and np.isfinite(b).all()
              and max(fro(e, ref), fro(b, ref), fro(e, b)) <= SERVE_FRO_RTOL)
        log(f"  request {i} (n={n}): rel_fro ell-fp64={fro(e, ref):.3e} bsr-fp64={fro(b, ref):.3e} "
            f"ell-bsr={fro(e, b):.3e} max|ell-bsr|={np.abs(e - b).max():.3e} max|ref|={np.abs(ref).max():.3e} "
            f"(tol {SERVE_FRO_RTOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"request {i}: served answers disagree")
        if i == 0:  # the check's power: the BSR answer left in RCM order
            wrong = fro(b[prepared["bsr"][i].perm], ref)
            log(f"  mutant request {i} bsr answer left in RCM order: rel_fro {wrong:.3e} "
                f"{'refused' if wrong > SERVE_FRO_RTOL else 'NOT refused'}")
            if not wrong > SERVE_FRO_RTOL:
                raise AssertionError("a served answer in the wrong vertex order passes the check")
    return counts, latency, {fmt: (s, prepared[fmt][0]) for fmt, s in servers.items()}, prepared["ell"]


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(self device us, count, name) of the device's own work, largest
    first: kernels and copies, not the user-annotated ranges that the
    profiler also puts on the device's timeline (the optimizer's
    ``Optimizer.step#Adam.step``), which would count their kernels twice."""
    import torch

    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        if getattr(e, "is_user_annotation", False):
            log(f"    (not device work: annotated range {e.key[:60]})")
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return sorted(rows, reverse=True)


# Every profiled region's port kernels in the trace against the launch
# counters' rise in it (``counted_profile``, ``profile_gap``): the profiler
# can lose device records (PERF.md, section 7), which would make the busy
# times read short.  Reported for every region; held where a phase says so.
PROFILE_GAPS: list = []


@contextlib.contextmanager
def counted_profile():
    """``torch.profiler`` (CPU and CUDA activities) over the region; the
    launch counters' rise inside it is kept as ``prof.launched``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        before = dict(port_kernels.launches)
        yield prof
    prof.launched = {k: port_kernels.launches[k] - before[k] for k in before}


def traced_launches(names) -> dict:
    """The port's kernels among device event names, by launch counter."""
    import re

    pats = {k: re.compile(rf"\b{sym}\b") for k, sym in KERNEL_SYMBOLS.items()}
    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for name, n in names:
        for k, pat in pats.items():
            if pat.search(name):
                counts[k] += n
    return counts


def profile_gap(where: str, prof, rows: list) -> dict:
    """The port's kernels among ``rows`` (``device_rows`` of ``prof``, a
    ``counted_profile``) against the launch counters' rise in the region:
    kept in PROFILE_GAPS, logged where they differ.  Returns {counter:
    launched - traced} where they differ."""
    traced = traced_launches((key, count) for _, count, key in rows)
    gap = {k: prof.launched[k] - traced[k] for k in traced if prof.launched[k] != traced[k]}
    PROFILE_GAPS.append({"where": where, "launched": sum(prof.launched.values()), "traced": sum(traced.values()),
                         "gap": gap})
    if gap:
        log(f"    profiler vs launch counters ({where}): {sum(prof.launched.values())} launched, "
            f"{sum(traced.values())} in the trace; launched minus traced {gap}")
    return gap


def profile_phase(served: dict) -> dict:
    """Where one forward's time goes: host wall time of a synchronised
    forward, and the device time of its kernels from ``torch.profiler``
    (events on the device only: the host operators that launch them carry
    the same time again)."""
    import torch

    out = {}
    for fmt, (server, req) in served.items():
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.answer(req)
            walls.append((time.perf_counter() - t0) * 1e3)
        with counted_profile() as prof:
            server.answer(req)
        rows = device_rows(prof)
        profile_gap(f"serve {fmt}", prof, rows)
        busy_ms = sum(r[0] for r in rows) / 1e3
        wall = sorted(walls)[len(walls) // 2]
        log(f"  {fmt}: host wall per forward {wall:.3f} ms (median of 5); device busy {busy_ms:.3f} ms "
            f"in {sum(r[1] for r in rows)} device ops; device idle share {1 - busy_ms / wall:.3f}")
        shown = rows[:8] + [r for r in rows[8:] if "spmm_kernel" in r[2]]
        for dev_us, count, key in shown:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        out[fmt] = {"wall_ms": wall, "device_busy_ms": busy_ms}
    return out


def backward_phase(device) -> None:
    """Each autograd Function's backward on the card (the kernels on
    ``op.bwd``; for the SDDMM two ``ell_matmul``, ``da`` on the pattern and
    ``db`` on its transpose slot map) against autograd through the plain
    forward versions, which derives the transpose itself.  The cotangent is a slice of a wider tensor, not
    contiguous, as the ``[x || L x]`` concat's backward hands it on."""
    import torch

    from surfacenetworks_tpu_torch.data import Buckets, fit_bsr_k, laplacian_batch, rcm_reorder_sample
    from surfacenetworks_tpu_torch.data.datasets import random_blob_mesh
    from surfacenetworks_tpu_torch.geometry import igl_style_laplacian
    from surfacenetworks_tpu_torch.sparse import kernels, ops

    rng = np.random.default_rng(SEED + 200)
    V, F = random_blob_mesh(rng, 7000)
    sample = rcm_reorder_sample({"V": V, "F": F, "input": V.astype(np.float32),
                                 "L": igl_style_laplacian(V, F, hack=1.0)})
    buckets = Buckets(n_vertices=BUCKET)
    fit_bsr_k([sample], buckets)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    def plain_grads(fn, inputs, g):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        fn(*leaves).backward(g)
        return [t.grad for t in leaves]

    for fmt in ("ell", "bsr"):
        op = laplacian_batch([sample], buckets, target_key="input", fmt=fmt).operator.to(device)
        x = torch.randn(1, BUCKET, WIDTH, device=device, generator=gen).requires_grad_()
        g = torch.randn(1, BUCKET, 2 * WIDTH, device=device, generator=gen)[..., WIDTH:]
        assert not g.is_contiguous()
        apply, plain = (ops.spmm, kernels.ell_matmul_plain) if fmt == "ell" else (ops.bsr_spmm, kernels.bsr_matmul_plain)
        m = op.fwd
        parts = (m.cols, m.vals) if fmt == "ell" else (m.block_cols, m.block_vals)
        apply(op, x).backward(g)
        (ref,) = plain_grads(lambda t: plain(*parts, t), [x], g)
        (scale,) = plain_grads(lambda t: plain(parts[0], parts[1].abs(), t), [x.abs()], g.abs())
        check(f"{'spmm' if fmt == 'ell' else 'bsr_spmm'} backward x_bar (|A^T||g|)", x.grad, ref, scale, KERNEL_RTOL)

    op = laplacian_batch([sample], buckets, target_key="input", fmt="ell").operator.to(device)
    m = op.fwd
    a = torch.randn(1, BUCKET, FEATURES, device=device, generator=gen).requires_grad_()
    b = torch.randn(1, BUCKET, FEATURES, device=device, generator=gen).requires_grad_()
    g = torch.randn(1, BUCKET, 2 * m.k, device=device, generator=gen)[..., m.k:]
    ops.sddmm(op, a, b).backward(g)
    ref_a, ref_b = plain_grads(lambda p, q: kernels.sddmm_plain(m.cols, m.vals, p, q), [a, b], g)
    gm = torch.where(m.vals != 0, g, 0.0).abs()
    check("sddmm backward da (|g||b|)", a.grad, ref_a, kernels.ell_matmul_plain(m.cols, gm, b.abs()), KERNEL_RTOL)
    # |g||a| summed into each row of b, in fp64: a tolerance's scale, in any order
    contrib = (gm[0, :, :, None].double() * a.detach()[0, :, None, :].double().abs()).reshape(-1, FEATURES)
    scale_b = torch.zeros(BUCKET, FEATURES, dtype=torch.float64, device=device).index_add_(
        0, m.cols[0].reshape(-1).long(), contrib)[None]
    check("sddmm backward db over the transpose slot map (|g||a|)", b.grad, ref_b, scale_b, KERNEL_RTOL)


def _plain_smoothness(op, f):
    """``losses.corr_feature_smoothness`` through the plain SDDMM (autograd
    through its gather): no kernel."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    fn = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp_min(1e-9)
    cols, vals = op.fwd.cols, op.fwd.vals
    scores = kernels.sddmm_plain(cols, vals, fn, fn)
    w = vals.abs() * (cols != torch.arange(cols.shape[-2], device=cols.device)[:, None])
    return -(w * scores).sum() / (w.sum() + 1e-9)


def _dense_fp64(L, N: int, device):
    """A scipy operator as a dense fp64 ``[1, N, N]`` on the card (the fp32
    values the kernels see, widened)."""
    import torch

    L = L.tocoo()
    dense = torch.zeros(N, N, dtype=torch.float64, device=device)
    dense.index_put_((torch.from_numpy(L.row).long().to(device), torch.from_numpy(L.col).long().to(device)),
                     torch.from_numpy(L.data.astype(np.float32).astype(np.float64)).to(device), accumulate=True)
    return dense[None]


def _plain_head(trainer, fa, fb, ia, ib):
    """The step's loss from features ``fa, fb [1, N, 120]`` with no kernel:
    dcel over the full logits plus the smoothness terms through the plain
    SDDMM."""
    import torch

    from surfacenetworks_tpu_torch.train import losses

    loss = losses.corr_delta_cross_entropy_from_target(torch.einsum("bnc,bmc->bnm", fa, fb)[0],
                                                       trainer.pair_target(ia, ib))
    return loss + trainer.smooth_w * (_plain_smoothness(trainer.dev_sample(ia)["reg_op"], fa)
                                      + _plain_smoothness(trainer.dev_sample(ib)["reg_op"], fb))


def _model(state0, device, dtype, model: str = "lap", layers: int = LAYERS):
    from surfacenetworks_tpu_torch.models import SiameseModel

    model = SiameseModel(model, layers)
    model.load_state_dict(state0)
    return model.to(device, dtype)


def _trunk_op64(trainer, i):
    """Sample ``i``'s trunk operator in fp64 on the card, no kernel: the
    dense Laplacian (lap key), the dense level of each pyramid level (amp),
    or the dense fp64 Dirac pair of its vertices (dirac)."""
    import torch

    from surfacenetworks_tpu_torch.data.batching import dense_dirac_pair

    s, N = trainer.data[i], trainer.N
    if trainer.model_key == "amp":
        return [_dense_fp64(Lk, N, trainer.device) for Lk in s["L_pyr"]]
    if trainer.model_key == "dirac":
        return dense_dirac_pair([{"V": np.asarray(s["V"], np.float64), "F": s["F"]}], N, trainer.buckets.n_faces,
                                torch.float64, trainer.device)
    return _dense_fp64(s["L"], N, trainer.device)


def _block_op(op64, name: str):
    """What block ``name`` of a trunk reads of the fp64 operator ``op64``:
    the pyramid level ``min(i // 2, levels - 1)`` of block ``rn{i}`` (amp),
    else ``op64`` itself."""
    if isinstance(op64, list):
        return op64[min(int(name[2:]) // 2, len(op64) - 1)] if name.startswith("rn") else op64[0]
    return op64


def _dense_step0(trainer, state0, ia, ib, rots, dense, dtype):
    """The whole step 0 with dense operators, the full-logits dcel and the
    plain SDDMM (no kernel), in ``dtype``.  Returns (loss, gradients)."""
    from surfacenetworks_tpu_torch.cli.train_correspondence import rot_matrix

    model = _model(state0, trainer.device, dtype, trainer.args.model, trainer.args.layer)
    args = []
    for k, i in enumerate((ia, ib)):
        d = trainer.dev_sample(i)
        x = d["inputs"].to(dtype) @ rot_matrix(float(rots[2 * k]), float(rots[2 * k + 1]), trainer.device, dtype)
        args.append(((_cast_op(dense[k], dtype), d["mask"].to(dtype)), x))
    fa, fb = model.features(args[0][0], args[1][0], args[0][1], args[1][1])
    loss = _plain_head(trainer, fa, fb, ia, ib)
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach() for k, p in model.named_parameters()}


class ModuleCapture:
    """Hooks on a model's submodules ``paths`` (label -> path, ``""`` the
    model itself) that keep, for each call (FAUST: shape A, then shape B),
    the module's arguments (detached) and outputs and, once backward has
    run, the cotangent of each output and of each argument that needs a
    gradient (None where nothing reached it).  Outputs are handed on as
    views and the cotangent taken there, so it is what the readers outside
    the module pass back (a Dirac block also reads its face output itself);
    arguments are handed in as views that only the module reads, so their
    cotangent is this module's share alone.  The values are the same; a
    tensor's gradient gains at most one more term per view, and a sum of
    two terms does not depend on their order.  Reading only: the step runs
    as without them.  ``names`` lists the labels."""

    def __init__(self, model, paths: dict):
        self.names = list(paths)
        self.calls = {label: [] for label in self.names}
        self.handles = []
        for label, path in paths.items():
            mod = model.get_submodule(path)
            self.handles += [mod.register_forward_pre_hook(self._pre(label)),
                             mod.register_forward_hook(self._post(label))]

    def _pre(self, label):
        import torch

        def hook(module, args):
            rec = {"needs": [], "gin": [None] * len(args)}
            new = []
            for i, a in enumerate(args):
                need = isinstance(a, torch.Tensor) and a.requires_grad
                if need:
                    a = a.view_as(a)
                    a.register_hook(lambda g, i=i: rec["gin"].__setitem__(i, g.detach()))
                rec["needs"].append(need)
                new.append(a)
            rec["args"] = [a.detach() if isinstance(a, torch.Tensor) else a for a in new]
            self.calls[label].append(rec)
            return tuple(new)
        return hook

    def _post(self, label):
        def hook(module, args, out):
            rec = self.calls[label][-1]
            outs = tuple(o.view_as(o) for o in (out if isinstance(out, tuple) else (out,)))
            rec["out"], rec["g"] = [o.detach() for o in outs], [None] * len(outs)
            for k, o in enumerate(outs):
                if o.requires_grad:
                    o.register_hook(lambda g, k=k: rec["g"].__setitem__(k, g.detach()))
            return outs if isinstance(out, tuple) else outs[0]
        return hook

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class StepCapture(ModuleCapture):
    """``ModuleCapture`` of a model's ``conv1``, blocks ``rn{i}``, final
    batch norm ``bn`` where it has one, and ``conv2``, in ``names``, and of
    the model itself as ``trunk``."""

    def __init__(self, model):
        bn = ["bn"] if "bn" in dict(model.named_children()) else []  # MlpModel's final batch norm
        names = ["conv1"] + [f"rn{i}" for i in range(model.layers)] + bn + ["conv2"]
        super().__init__(model, {**{n: n for n in names}, "trunk": ""})
        self.names = names


def _rel_fro(got, ref) -> float:
    return float((got.double() - ref).norm() / ref.norm().clamp_min(1e-300))


def output_head(cap: ModuleCapture, loss: float, head64, label: str = "trunk") -> dict:
    """The head of a step against fp64 at the card's own outputs: the loss
    by ``head64`` (in fp64, no kernel) on the outputs of each call of the
    captured module ``label`` (the model, or the FAUST trunk: shape A, then
    B), and each output's cotangent, against the card's; relative errors by
    key."""
    outs = [rec["out"][0].double().requires_grad_() for rec in cap.calls[label]]
    loss64 = head64(*outs)
    loss64.backward()
    errs = {"loss on the card's outputs": abs(loss - float(loss64.detach())) / abs(float(loss64.detach()))}
    for k, (o, rec) in enumerate(zip(outs, cap.calls[label])):
        errs[f"head cotangent of output call {k}"] = _rel_fro(rec["g"][0], o.grad)
    return errs


def replay_modules(cap: ModuleCapture, grads: dict, ref_model, apply, dtype=None, prefix: str = "",
                   null=frozenset(), outputs: bool = False, norms: dict | None = None) -> dict:
    """The one step-0 comparator: a captured step replayed module by module.
    Each call of each module of ``cap`` is rerun by the same module of
    ``ref_model`` (the model at the step's weights: in fp64, or in the
    card's dtype) on its captured inputs (floating ones cast to ``dtype``,
    kept where None), every operator argument replaced by ``apply(name, k,
    op)`` (a dense fp64 operator or pair, the kernels' plain versions, the
    pattern itself), and the captured output cotangents are passed back.
    One row per call for each output (with ``outputs``) and each input that
    needed a gradient (its cotangent against the card's share of it; zero
    where none reached it), and one per parameter leaf: its gradient, summed
    over the calls, against the card's ``grads[prefix + path]``, or for a
    leaf in ``null`` (zero in exact arithmetic) the card gradient's norm
    over the largest reference gradient's.  Returns each row's relative
    (Frobenius) error by key; parameter rows end in ``gradient`` (``null
    gradient``), the chain's (outputs and cotangents) do not.  ``norms``,
    where given, receives each other leaf's reference gradient norm over
    the largest one's."""
    import torch

    errs, pgrads = {}, {}
    for name in cap.names:
        mod = ref_model.get_submodule(name)
        mod.zero_grad(set_to_none=True)
        for k, rec in enumerate(cap.calls[name]):
            args = []
            for a, need in zip(rec["args"], rec["needs"]):
                if _is_operator(a):
                    a = apply(name, k, a)
                elif isinstance(a, torch.Tensor) and a.is_floating_point():
                    a = a if dtype is None else a.to(dtype)
                    a = a.clone().requires_grad_() if need else a
                args.append(a)
            outs = mod(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            if outputs:
                for i, (o, card) in enumerate(zip(outs, rec["out"])):
                    errs[f"{name} output {i} call {k}"] = _rel_fro(card, o.detach().double())
            pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, rec["g"]) if g is not None and o.requires_grad]
            if pairs:
                torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
            for i, (a, need, gin) in enumerate(zip(args, rec["needs"], rec["gin"])):
                if need:
                    ref = torch.zeros_like(a) if a.grad is None else a.grad
                    errs[f"{name} input {i} cotangent call {k}"] = _rel_fro(
                        torch.zeros_like(ref) if gin is None else gin, ref.double())
        pgrads.update({f"{name}.{pname}": p.grad for pname, p in mod.named_parameters() if p.grad is not None})
    top = max((float(g.double().norm()) for key, g in pgrads.items() if key not in null), default=1.0)
    for key, g in pgrads.items():
        if key in null:
            errs[f"{key} null gradient"] = float(grads[prefix + key].double().norm()) / top
        else:
            errs[f"{key} gradient"] = _rel_fro(grads[prefix + key], g.double())
            if norms is not None:
                norms[key] = float(g.double().norm()) / top
    return errs
def judge_step0(what: str, runs: dict, bounds: dict, res: dict, against: str = "fp64") -> list[str]:
    """The module-wise verdict on step 0.  ``runs`` maps "real" and each
    mutant's label to their errors against fp64; each run's errors fall in
    the chain (the loss and the cotangents), the parameter gradients and,
    where there are any, the null gradients (``... null gradient``), and
    each group's worst is held to its bound in ``bounds``.  Logs each run
    (its reference named by ``against``),
    keeps the worst in ``res["step0"]``; the real step must pass and no
    mutant may.  Returns the failures."""
    failures = []
    for label, errs in runs.items():
        groups = {"chain": {k: v for k, v in errs.items() if not k.endswith("gradient")},
                  "parameter": {k: v for k, v in errs.items() if k.endswith("gradient") and not k.endswith("null gradient")},
                  "null": {k: v for k, v in errs.items() if k.endswith("null gradient")}}
        worst_ = {g: max(e.items(), key=lambda kv: kv[1]) for g, e in groups.items() if e}
        ok = all(worst_[g][1] <= bounds[g] for g in worst_)
        verdict = ("ok" if ok else "FAIL") if label == "real" else ("NOT refused" if ok else "refused")
        loss_key = next(k for k in errs if k.startswith("loss on"))
        null = (f"; null gradients {sorted(groups['null'])} worst {worst_['null'][1]:.3e} of the largest "
                f"(tol {bounds['null']:g})" if "null" in worst_ else "")
        log(f"  {what} {label}: module-wise vs {against}: {loss_key} rel {errs[loss_key]:.3e}; chain ({len(groups['chain'])}) "
            f"worst {worst_['chain'][0]} {worst_['chain'][1]:.3e} (tol {bounds['chain']:g}), median "
            f"{np.median(list(groups['chain'].values())):.3e}; parameter gradients ({len(groups['parameter'])}) worst "
            f"{worst_['parameter'][0]} {worst_['parameter'][1]:.3e} (tol {bounds['parameter']:g}), median "
            f"{np.median(list(groups['parameter'].values())):.3e}{null}; {verdict}")
        if label == "real":
            top = sorted(errs.items(), key=lambda kv: -kv[1])[:6]
            log(f"  {what} real: largest: " + ", ".join(f"{k} {v:.3e}" for k, v in top))
            res["step0"]["worst"] = worst_
            if not ok:
                failures.append(f"{what}: step 0 disagrees with fp64 at {worst_}")
        else:
            res["step0"].setdefault("mutant_worst", {})[label] = worst_
            if ok:
                failures.append(f"{what}: the {label} passes the step-0 check")
    return failures


@contextlib.contextmanager
def detached_applies():
    """The mutant's operator applies: the kernel's output detached, so no
    gradient flows through L."""
    from surfacenetworks_tpu_torch.nn import blocks
    from surfacenetworks_tpu_torch.sparse import kernels

    saved = blocks.spmm, blocks.bsr_spmm
    blocks.spmm = lambda op, x: kernels.ell_matmul(op.fwd.cols, op.fwd.vals, x.contiguous()).detach()
    blocks.bsr_spmm = lambda op, x: kernels.bsr_matmul(op.fwd.block_cols, op.fwd.block_vals, x.contiguous()).detach()
    try:
        yield
    finally:
        blocks.spmm, blocks.bsr_spmm = saved


def _detached_step0(trainer, state0, ia, ib, rots, mutant=None):
    """The mutant: step 0 with detached operator applies (``mutant``, a
    context manager; default the ELL and BSR applies), captured like the
    real step.  Returns (loss, gradients, capture)."""
    import torch

    from surfacenetworks_tpu_torch.cli.train_correspondence import objective

    model = _model(state0, trainer.device, torch.float32, trainer.args.model, trainer.args.layer)
    cap = StepCapture(model.trunk)
    try:
        with (mutant or detached_applies)():
            loss = objective(model, trainer.dev_sample(ia), trainer.dev_sample(ib), [float(r) for r in rots],
                             trainer.pair_target(ia, ib), trainer.smooth_w, trainer.use_stream)
            loss.backward()
    finally:
        cap.remove()
    # detached Dirac applies leave some parameters without a gradient
    return float(loss.detach()), {k: torch.zeros_like(p) if p.grad is None else p.grad.detach()
                                  for k, p in model.named_parameters()}, cap


def step0_check(fmt, trainer, state0, res, ia, ib, rots, mutant=None, plain32: bool = True) -> list[str]:
    """Step 0 against fp64 with dense operators (``_trunk_op64``) and no
    kernel, and the detached-apply mutant (``mutant``) against the same;
    with ``plain32`` the same step in fp32 on the dense operators is
    reported beside it.  Returns the failures."""
    failures = []
    import torch

    dense = [_trunk_op64(trainer, i) for i in (ia, ib)]
    ref_loss, ref_grads = _dense_step0(trainer, state0, ia, ib, rots, dense, torch.float64)
    whole = {k: _rel_fro(g, ref_grads[k]) for k, g in res["grads0"].items()}
    loss_rel = abs(res["loss"][0] - ref_loss) / abs(ref_loss)
    log(f"  {fmt}: step 0 vs the whole fp64 step: loss {res['loss'][0]:.6f} vs {ref_loss:.6f} (rel {loss_rel:.3e}, "
        f"tol {STEP0_LOSS_RTOL:g}); gradient rel_fro median {np.median(list(whole.values())):.3e}, "
        f"max {max(whole.values()):.3e} (reported, not bounded: the near-one-hot softmax of the dcel head "
        f"turns fp32 rounding of the features into other argmax rows)")
    if plain32:  # the same fp32 rounding without any kernel: dense operators in fp32
        p_loss, p_grads = _dense_step0(trainer, state0, ia, ib, rots, dense, torch.float32)
        plain = [_rel_fro(g, ref_grads[k]) for k, g in p_grads.items()]
        log(f"  {fmt}: the same step in fp32 with dense operators and no kernel vs fp64: loss rel "
            f"{abs(p_loss - ref_loss) / abs(ref_loss):.3e}; gradient rel_fro median {np.median(plain):.3e}, "
            f"max {max(plain):.3e}")
        del p_grads
    if not loss_rel <= STEP0_LOSS_RTOL:
        failures.append(f"{fmt}: step-0 loss {res['loss'][0]} vs fp64 {ref_loss}")
    res["step0"] = {"loss_rel": loss_rel, "whole_grad_fro_median": float(np.median(list(whole.values())))}
    runs = {label: {**output_head(cap, loss, lambda fa, fb: _plain_head(trainer, fa, fb, ia, ib)),
                    **replay_modules(cap, grads, _model(state0, trainer.device, torch.float64, trainer.args.model,
                                                         trainer.args.layer).trunk,
                                     lambda name, k, op: _block_op(dense[k], name), torch.float64, "trunk.")}
            for label, (loss, grads, cap) in {"real": (res["loss"][0], res["grads0"], res["capture"]),
                                              "mutant detached applies": _detached_step0(trainer, state0, ia, ib,
                                                                                         rots, mutant)}.items()}
    del dense
    torch.cuda.empty_cache()
    return failures + judge_step0(fmt, runs, {"chain": STEP0_CHAIN_RTOL, "parameter": STEP0_PARAM_RTOL}, res)


def train_phase(device, smi: str, data: list) -> tuple[dict, dict]:
    """The FAUST siamese trainer in both formats on ``data`` (the synthetic
    scans TRAIN_ARGS name, made once): build each trainer and its device
    caches, then (counts at 0) TRAIN_STEPS updates and the test pass each
    (step 0 captured module by module, the last step profiled), then each
    run again from its start, bit for bit; returns the train path's launch
    counts and per-format results."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    runs = {}
    for fmt in ("ell", "bsr"):
        t0 = time.perf_counter()
        runs[fmt] = frun, state0, restore = faust_run(fmt, data, TRAIN_STEPS)
        trainer = frun.t
        log(f"  {fmt}: bucket {trainer.N}, n_train {trainer.n_train}, streaming head {trainer.use_stream}, "
            f"{'bsr_k ' + str(trainer.buckets.bsr_k) if fmt == 'bsr' else 'ell_k 16'}; "
            f"set-up {time.perf_counter() - t0:.2f} s; plan pairs {[p[:2] for p in frun.plan]}")
        mult = {f"{a},{b}": int(inv[0].shape[1]) for (a, b), inv in trainer._inverses.items()}
        log(f"  {fmt}: largest multiplicity of each pair's dcel target (the mirror's ELL width) {mult}; "
            f"transpose slot map of the smoothness pattern K_t "
            f"{[int(trainer.dev_sample(i)['reg_op'].transpose_map()[0].shape[-1]) for i in range(len(trainer.data))]}")

    # the main path: every count is 0 just before it and read just after
    kernels.reset_launch_counts()
    results = {fmt: _train_run(frun, TRAIN_STEPS, _draw_plan, capture=lambda m: StepCapture(m.trunk),
                               profile_last=True) for fmt, (frun, _, _) in runs.items()}
    counts = dict(kernels.launches)
    log(f"  launches on the train path ({TRAIN_STEPS} updates + test pass per format): {counts}")

    failures = []
    for fmt, res in results.items():
        frun, state0, restore = runs[fmt]
        repeat_run(fmt, frun, restore, res, _draw_plan)
        log(f"  {fmt}: losses {['%.4f' % v for v in res['loss']]} ({smi})")
        log(f"  {fmt}: device ms per step (CUDA events) {['%.2f' % v for v in res['device_ms']]}, median of the "
            f"steady steps {res['device_ms_median']:.3f}; host wall per step {['%.2f' % v for v in res['wall_ms']]}, "
            f"median {res['wall_ms_median']:.3f}; profiled step device busy {res['busy_ms']:.3f} ms in "
            f"{res['device_ops']} device ops, idle share {res['idle_share']:.3f}; peak device memory "
            f"{res['peak_mib']:.1f} MiB ({smi})")
        for dev_us, count, key in res["top"]:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        log(f"  {fmt}: launches per step {res['per_step'][0]} (expected {EXPECTED_PER_STEP[fmt]}); "
            f"test pass {res['test_launches']} ({smi})")
        log(f"  {fmt}: test metrics {res['test']} ({smi})")
        # the checks: each failure below fails the run
        if not all(np.isfinite(res["loss"])):
            failures.append(f"{fmt}: a loss is not finite")
        if any(step != EXPECTED_PER_STEP[fmt] for step in res["per_step"]):
            failures.append(f"{fmt}: launches per step {res['per_step']} != {EXPECTED_PER_STEP[fmt]}")
        if not res["reproduced"]:
            failures.append(f"{fmt}: a second run from the same state gave other losses, metrics or weights")
        for k, g in res["grads0"].items():
            if not (bool(torch.isfinite(g).all()) and bool((g != 0).any())):
                failures.append(f"{fmt}: step-0 gradient of {k} is not finite and non-zero")
        ia, ib, rots = frun.plan[0]
        failures += step0_check(fmt, frun.t, state0, res, ia, ib, np.asarray(rots))
        for key in ("capture", "grads0", "batch0", "drawn0", "params"):
            res.pop(key, None)
    if failures:
        raise AssertionError("; ".join(failures))
    return counts, results


def faust_run(fmt: str, data: list, steps: int, extra: tuple = ()) -> tuple:
    """A FAUST trainer in ``fmt`` (``extra`` flags after TRAIN_ARGS) on
    ``data`` behind ``FaustRun`` (``steps`` updates of its epoch plan), its
    device caches made first (operators, geodesics, pair targets and their
    inverses, the test scans); with its weights at the start and a restore
    of the start (weights, optimizer, random state, plan position)."""
    import torch

    from surfacenetworks_tpu_torch.cli import train_correspondence as tc

    tag = " ".join((fmt,) + tuple(a.strip("-") for a in extra))
    trainer = tc.CorrespondenceTrainer(tc.parser.parse_args(TRAIN_ARGS + ["--operator-format", fmt, *extra]),
                                       log=lambda m: log(f"  [{tag}] {m}"), data=data)
    frun = FaustRun(trainer, steps)
    for ia, ib, _ in frun.plan:
        trainer.pair_target(ia, ib)
        if trainer.use_stream:
            trainer.pair_inverse(ia, ib)
    for i in range(trainer.n_train, len(trainer.data)):
        trainer.dev_sample(i)
    torch.cuda.synchronize()
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    opt, rng = copy.deepcopy(trainer.opt.state_dict()), copy.deepcopy(trainer.rng.bit_generator.state)

    def restore():
        trainer.model.load_state_dict(params)
        trainer.opt.load_state_dict(opt)
        trainer.rng.bit_generator.state = copy.deepcopy(rng)
        frun.pos, trainer.step = 0, 0

    return frun, params, restore


def amp_kernel_checks(trainer, device) -> dict:
    """``ell_matmul`` at the amp trunk's shape: the three pyramid levels of
    scan 0 (fixed K, the pyramid's widest row) stacked as one batch through
    ``batched_ell_checks`` (forward and backward against the plain version
    in fp32 and fp64, level 0's operator in every item refused, the bf16
    variant); then each level alone, as the trunk launches it, timed warm
    and cold against its plain version, ``torch.sparse.mm`` on a CSR copy
    and two bounds: every stored slot's column and value read (what the
    kernel reads), and the live slots' only (what the product needs); and
    ``sddmm`` at the smoothness pattern of the same K against its plain
    version, timed.  Returns the report."""
    import torch

    from surfacenetworks_tpu_torch.data.batching import _fixed_k_operator
    from surfacenetworks_tpu_torch.sparse import kernels, stack_operators

    levels = trainer.data[0]["L_pyr"]
    N, b = trainer.N, trainer.buckets
    stacked = stack_operators([_fixed_k_operator(Lk, b, N) for Lk in levels]).to(device)
    rep = {"levels_batched": batched_ell_checks(stacked, levels, device, "the amp pyramid's 3 levels", WIDTH, SEED + 500)}
    gen = torch.Generator(device=device).manual_seed(SEED + 501)
    x = torch.randn(N, WIDTH, device=device, generator=gen)
    out = torch.empty(N, WIDTH, device=device)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)
    rep["levels"] = []
    for lvl, Lk in enumerate(levels):
        cols, vals = stacked.fwd.cols[lvl], stacked.fwd.vals[lvl]
        live = vals != 0
        nnz = int(live.sum())
        csr = Lk.tocsr().astype(np.float32)
        csr.resize((N, N))
        lib = torch.sparse_csr_tensor(torch.from_numpy(csr.indptr.astype(np.int64)),
                                      torch.from_numpy(csr.indices.astype(np.int64)), torch.from_numpy(csr.data),
                                      size=csr.shape).to(device)
        b_ms, b_by = bound_ms(nbytes(cols, vals, x, out), 2 * nnz * WIDTH)
        live_bytes = nnz * (cols.element_size() + vals.element_size()) + nbytes(x, out)
        lb_ms, lb_by = bound_ms(live_bytes, 2 * nnz * WIDTH)
        r = {"level": lvl, "shape": [N, cols.shape[1], WIDTH], "live_slots": nnz,
             "max_live_per_row": int(live.sum(1).max()),
             "ms": time_ms(lambda: kernels.ell_matmul(cols, vals, x)),
             "cold_ms": cold_ms(lambda: kernels.ell_matmul(cols, vals, x), flush),
             "plain_ms": time_ms(lambda: kernels.ell_matmul_plain(cols, vals, x)),
             "library_ms": time_ms(lambda: torch.sparse.mm(lib, x)), "library_call": "torch.sparse.mm(csr, x)",
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(cols, vals, x, out), "flops": 2 * nnz * WIDTH,
             "live_bound_ms": lb_ms, "live_bound_by": lb_by, "live_bytes": live_bytes}
        rep["levels"].append(r)
        log(f"  ell_matmul amp level {lvl} (R={N}, K={cols.shape[1]}, C={WIDTH}; {nnz} live slots, at most "
            f"{r['max_live_per_row']} a row): {r['ms']:.5f} ms warm, {r['cold_ms']:.5f} ms cold L2 (plain "
            f"{r['plain_ms']:.4f}, {r['library_call']} {r['library_ms']:.4f}); bound {b_ms:.5f} ms by {b_by} "
            f"({r['bytes'] / 1e6:.1f} MB, every slot; {b_ms / r['ms']:.1%} of it), the live slots' bound "
            f"{lb_ms:.5f} ms ({live_bytes / 1e6:.1f} MB; {lb_ms / r['ms']:.1%})")
    reg = trainer.dev_sample(0)["reg_op"].fwd
    cols, vals = reg.cols[0], reg.vals[0]
    a = torch.nn.functional.normalize(torch.randn(N, FEATURES, device=device, generator=gen), dim=-1)
    nnz = int((vals != 0).sum())
    rep["sddmm"] = {"shape": [N, cols.shape[1], FEATURES], "live_slots": nnz,
                    "max_abs_err": check(f"sddmm at the amp smoothness pattern K={cols.shape[1]} C={FEATURES} (a = b)",
                                         kernels.sddmm(cols, vals, a, a), kernels.sddmm_plain(cols, vals, a, a),
                                         kernels.sddmm_plain(cols, vals, a.abs(), a.abs()), KERNEL_RTOL),
                    "ms": time_ms(lambda: kernels.sddmm(cols, vals, a, a)),
                    "plain_ms": time_ms(lambda: kernels.sddmm_plain(cols, vals, a, a))}
    sd_out = torch.empty(N, cols.shape[1], device=device)
    rep["sddmm"]["bound_ms"], rep["sddmm"]["bound_by"] = bound_ms(nbytes(cols, vals, a, sd_out), 2 * nnz * FEATURES)
    r = rep["sddmm"]
    log(f"  sddmm at the amp smoothness pattern ({nnz} live slots of {cols.numel()}): {r['ms']:.5f} ms warm (plain "
        f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} ms by {r['bound_by']})")
    del flush
    return rep


def faust_zoo_phase(device, smi: str, data: list) -> tuple[dict, dict]:
    """FAUST_ZOO_RUNS through the FAUST trainer on ``data``: per run, its
    trainer and caches, then (counts at 0) FAUST_ZOO_STEPS updates and the
    test pass (step 0 captured for amp and dir, the last step profiled),
    then the run again from its start, bit for bit; amp's kernel shapes
    checked and timed before its run, and ``--eval-only`` on a checkpoint
    of its weights against the device's metrics of the same predictions;
    step 0 of amp and dir against fp64 module by module; --remat and the
    light path against their plain runs bit for bit.  Each trainer is freed
    before the next is built, so each run's peak memory is its own.
    Returns the launch counts of all runs' paths and the results."""
    import torch

    from surfacenetworks_tpu_torch.cli import train_correspondence as tc
    from surfacenetworks_tpu_torch.sparse import kernels

    results, counts, failures = {}, launches_of(), []
    tmp = tempfile.mkdtemp(prefix="faust_zoo_")
    try:
        for label, (fmt, extra) in FAUST_ZOO_RUNS.items():
            t0 = time.perf_counter()
            tc._FORCE_LIGHT = label == "light"
            try:
                frun, state0, restore = faust_run(fmt, data, FAUST_ZOO_STEPS, extra + FAUST_ZOO_DEPTH)
            finally:
                tc._FORCE_LIGHT = False
            trainer = frun.t
            log(f"  faust {label}: trunk {type(trainer.model.trunk).__name__}-{trainer.args.layer}, operator "
                f"{trainer.model_key}, format {trainer.fmt}, bucket {trainer.N}, ell_k {trainer.buckets.ell_k}, loss {trainer.args.loss}, "
                f"streaming head {trainer.use_stream}, light {trainer.light}; set-up {time.perf_counter() - t0:.2f} s")
            res = {}
            if label == "amp":
                res["kernel"] = amp_kernel_checks(trainer, device)
            step0 = label in ("amp", "dir")
            torch.cuda.empty_cache()
            # the main path: every count is 0 just before it and read just after
            kernels.reset_launch_counts()
            res.update(_train_run(frun, FAUST_ZOO_STEPS, _draw_plan, profile_last=True,
                                  capture=(lambda m: StepCapture(m.trunk)) if step0 else None))
            res["counts"] = dict(kernels.launches)
            counts = {k: counts[k] + v for k, v in res["counts"].items()}
            repeat_run(f"faust {label}", frun, restore, res, _draw_plan)
            test_expected = {k: v * (len(trainer.data) - trainer.n_train) ** 2 for k, v in
                             FAUST_ZOO_PER_TEST[label].items()}
            log(f"  faust {label}: losses {[repr(v) for v in res['loss']]}; test {res['test']!r} ({smi})")
            log(f"  faust {label}: host wall per step {['%.2f' % v for v in res['wall_ms']]}, median "
                f"{res['wall_ms_median']:.3f} ms; device ms per step (CUDA events) median {res['device_ms_median']:.3f}; "
                f"profiled step device busy {res['busy_ms']:.3f} ms in {res['device_ops']} device ops, idle share "
                f"{res['idle_share']:.3f}; peak device memory {res['peak_mib']:.1f} MiB ({smi})")
            for dev_us, count, key in res["top"]:
                log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
            log(f"  faust {label}: launches per step {res['per_step'][0]} (expected {FAUST_ZOO_PER_STEP[label]}); "
                f"test pass {res['test_launches']} (expected {test_expected})")
            if not np.isfinite(res["loss"]).all():
                failures.append(f"faust {label}: a loss is not finite")
            if any(step != FAUST_ZOO_PER_STEP[label] for step in res["per_step"]) or res["test_launches"] != test_expected:
                failures.append(f"faust {label}: launches per step {res['per_step']}, test pass {res['test_launches']}")
            if not res["reproduced"]:
                failures.append(f"faust {label}: a second run from the same state differs")
            if (res["test"] is None) != (label == "light"):
                failures.append(f"faust {label}: test pass {res['test']!r}")
            if step0:
                for k, g in res["grads0"].items():
                    if not (bool(torch.isfinite(g).all()) and bool((g != 0).any())):
                        failures.append(f"faust {label}: step-0 gradient of {k} is not finite and non-zero")
                ia, ib, rots = frun.plan[0]
                fp64 = step0_check(f"faust {label}", trainer, state0, res, ia, ib, np.asarray(rots),
                                   detached_dirac_applies if label == "dir" else detached_applies,
                                   plain32=label != "dir")
                if label == "amp":
                    log(f"  faust amp: against fp64 {'; '.join(fp64) or 'within the bounds'} (reported, not held: "
                        f"{amp_overflow_report(res['capture'])})")
                    failures += plain_step0_check("faust amp", res, _model(state0, device, torch.float32, "amp",
                                                                           FAUST_ZOO_LAYERS).trunk,
                                                  "trunk.", FAUST_AMP_PLAIN_CHAIN_RTOL, FAUST_AMP_PLAIN_PARAM_RTOL,
                                                  "step0_plain")
                else:
                    failures += fp64
            if label == "amp":
                failures += eval_only_check(trainer, tmp, smi)
            for key in ("capture", "grads0", "batch0", "drawn0"):
                res.pop(key, None)
            res["phase_s"] = time.perf_counter() - t0
            log(f"  faust {label}: {res['phase_s']:.2f} s with its set-up, checks and repeat")
            results[label] = res
            del frun, trainer, restore, state0
            torch.cuda.empty_cache()
        for label, plain in FAUST_ZOO_SAME.items():
            a, b = results[label], results[plain]
            same = a["loss"] == b["loss"] and all(torch.equal(v, b["params"][k]) for k, v in a["params"].items())
            same = same and (label == "light" or a["test"] == b["test"])
            log(f"  faust {label} vs {plain}: losses, weights{'' if label == 'light' else ' and test metrics'} "
                f"{'bit-identical' if same else 'DIFFER'}; peak device memory {a['peak_mib']:.1f} against "
                f"{b['peak_mib']:.1f} MiB ({smi})")
            if not same:
                failures.append(f"faust {label}: not bit-identical to {plain}")
        for res in results.values():
            res.pop("params")
        if failures:
            raise AssertionError("; ".join(failures))
        return counts, results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def amp_overflow_report(cap) -> str:
    """For each Lap block of the amp trunk's captured step 0 (shape A), the
    channels of ``L elu(x)`` whose batch-norm variance, computed in fp32 as
    ``GraphBatchNorm`` computes it, is not finite, and the largest
    ``|L elu(x)|``: where fp32 overflows and fp64 does not."""
    import torch
    import torch.nn.functional as F

    from surfacenetworks_tpu_torch.nn.blocks import apply_operator

    parts = []
    with torch.no_grad():
        for name in cap.names:
            op, _, x = (cap.calls[name][0]["args"] + [None, None, None])[:3]
            if not (name.startswith("rn") and int(name[2:]) % 2 == 0):
                continue
            y = apply_operator(op, F.elu(x))
            var = ((y - y.mean(dim=(0, 1))) ** 2).mean(dim=(0, 1))
            parts.append(f"{name} {int((~torch.isfinite(var)).sum())} of {y.shape[-1]} channels, max|L x| "
                         f"{float(y.abs().max()):.2e}")
    return "fp32 batch-norm variances that overflow: " + "; ".join(parts)


def eval_only_check(trainer, tmp: str, smi: str) -> list[str]:
    """``--eval-only`` through ``train_correspondence.main`` on a checkpoint
    of ``trainer``'s weights (the amp run after its updates; the same
    flags and synthetic scans): its host metrics against
    ``losses.corr_metrics_from_pred`` on the device for ``trainer``'s
    predictions of the same pairs: ``exact`` and ``geo_mean`` within 1e-5
    (fp32 sums on the device, numpy's on the host), the quartiles (linear
    on the host, ``np.quantile``) against ``torch.quantile`` of the device's
    distances.  Returns the failures."""
    import itertools

    import torch

    from surfacenetworks_tpu_torch.cli import train_correspondence as tc
    from surfacenetworks_tpu_torch.train import losses

    ckpt = os.path.join(tmp, "amp_state.pt")
    trainer.save(ckpt, 0)
    t0 = time.perf_counter()
    host = tc.main(TRAIN_ARGS + ["--operator-format", "ell", *FAUST_ZOO_RUNS["amp"][1], *FAUST_ZOO_DEPTH,
                                 "--eval-only", "--deser-option", "auto", "--deser-path", ckpt,
                                 "--result-dir", tmp])["eval"]
    wall = time.perf_counter() - t0
    ids = list(range(trainer.n_train, len(trainer.data))) or list(range(len(trainer.data)))
    pairs = list(itertools.product(ids, repeat=2))
    dev = {}
    for i, j in pairs:
        da, db = trainer.dev_sample(i), trainer.dev_sample(j)
        pred = trainer.predict(i, j)
        m = losses.corr_metrics_from_pred(pred, da["l"], db["l"], db["li"], db["G"], da["mask"][0, :, 0])
        n = da["n"]
        geo = db["G"][db["li"][da["l"][:n]], pred[:n].long()].double()
        m.update({f"geo_q{q}": torch.quantile(geo, q / 100) for q in (25, 50, 75)})
        for k, v in m.items():
            dev[k] = dev.get(k, 0.0) + float(v) / len(pairs)
    errs = {k: abs(host[k] - dev[k]) / max(abs(dev[k]), 1e-30) for k in host}
    ok = sorted(host) == sorted(dev) and max(errs.values()) <= 1e-5
    log(f"  faust amp --eval-only over {len(pairs)} pairs ({wall:.2f} s with the trainer's set-up): host {host}; the "
        f"device's metrics of the same predictions {dev}; worst relative difference {max(errs.values()):.3e} "
        f"{'ok' if ok else 'FAIL'} ({smi})")
    return [] if ok else [f"faust amp --eval-only: host metrics {host} differ from the device's {dev}"]


def _model_at(build, state0, device):
    """``dtype ->`` the model ``build()`` at the weights ``state0`` on
    ``device`` in ``dtype``."""
    def make(dtype):
        model = build()
        model.load_state_dict(state0)
        return model.to(device, dtype)
    return make


def _normal_model_at(trainer, state0):
    """``_model_at`` of a normal run's model (``train_normal.build_model``
    of its arguments, fp32 structure)."""
    from surfacenetworks_tpu_torch.cli import train_normal as tn

    return _model_at(lambda: tn.build_model(trainer.args), state0, trainer.device)


def _cosine_head(out, batch):
    """The normal trainers' loss on a model's output."""
    from surfacenetworks_tpu_torch.train import losses

    return losses.normal_cosine_loss(out, batch.mask, batch.targets)


def _normal_trainer(argv, label: str, logged: list | None = None):
    from surfacenetworks_tpu_torch.cli import train_normal as tn

    def tlog(m):
        if logged is not None:
            logged.append(str(m))
        log(f"  [normal {label}] {m}")

    return tn.NormalTrainer(tn.parser.parse_args(argv), log=tlog)


def _sample_key(s: dict):
    """A sample's name, or, for a sample without one (a mesh-MNIST pickle's),
    the object itself: the key of a run's own samples."""
    return s["name"] if "name" in s else id(s)


def _sampler_like(saved, samples):
    """A copy of the sampler ``saved`` (order, position, random state) over
    ``samples``, a trainer's own sample dicts, matched by name (``_sample_key``):
    the device dataset finds a sample by the object.  A ``TieredSampler`` is copied
    tier by tier, with its own draw's state."""
    if hasattr(saved, "samplers"):
        out = copy.copy(saved)
        out.samplers = {k: _sampler_like(v, samples) for k, v in saved.samplers.items()}
        out.rng = copy.deepcopy(saved.rng)
        return out
    by_name = {_sample_key(s): s for s in samples}
    out = copy.copy(saved)
    out.items = [by_name[_sample_key(s)] for s in saved.items]
    out.rng = copy.deepcopy(saved.rng)
    return out


def _normal_snapshot(trainer) -> dict:
    """What a repeat of the run starts from: weights, optimizer state, both
    samplers' state and the update count."""
    return {"params": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            "opt": copy.deepcopy(trainer.opt.state_dict()),
            "train_sampler": _sampler_like(trainer.train_sampler, trainer.train_samples),
            "test_sampler": _sampler_like(trainer.test_sampler, trainer.test_samples), "step": trainer.step}


def _normal_restore(trainer, snap: dict) -> None:
    trainer.model.load_state_dict(snap["params"])
    trainer.opt.load_state_dict(snap["opt"])
    trainer.train_sampler = _sampler_like(snap["train_sampler"], trainer.train_samples)
    trainer.test_sampler = _sampler_like(snap["test_sampler"], trainer.test_samples)
    trainer.step = snap["step"]


def _draw_samples(trainer) -> tuple[list, list]:
    """The next train batch's samples, recorded by name."""
    samples = trainer.train_sampler.next_batch()
    return samples, [_sample_key(s) for s in samples]


def _draw_picks(trainer) -> tuple[list, list]:
    """The next train batch's (sequence, offset) picks."""
    picks = trainer.sample_train_picks()
    return picks, picks


def _train_run(trainer, steps: int, draw=_draw_samples, capture=None, profile_last: bool = False,
               save_after: int = 0, ckpt: str = "", annotate=None, update=None) -> dict:
    """``steps`` updates, each on the batch of ``draw(trainer)`` (what
    ``trainer.batch`` takes, and what the run records of it) and timed (host
    wall of a synchronised update, batch gather included, and CUDA events),
    then the test pass; the launch counts of each step and of the test pass;
    the peak device memory of the updates; step 0 under the module-wise
    capture ``capture(model)``, the last step under the profiler, a
    checkpoint after ``save_after`` updates.  ``annotate``, a pair
    (context manager, range name), is entered around the profiled step, and
    the device time of that range's kernels is kept as ``range_ms``.
    ``update(trainer, batch, u)`` takes update ``u`` where
    ``trainer.update(batch)`` does not fit.  With a third element in
    ``annotate``, the kernels of autograd's backward of the ranges'
    operations (``backward_device_ms``) are kept as ``range_bwd_ms``."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    res = {"loss": [], "mad": [], "wall_ms": [], "device_ms": [], "per_step": [], "drawn": []}
    step = (lambda t, b, u: t.update(b)) if update is None else update
    torch.cuda.reset_peak_memory_stats()
    for u in range(steps):
        drawn, key = draw(trainer)
        res["drawn"].append(key)
        before = dict(kernels.launches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        batch = trainer.batch(drawn)
        if capture is not None and u == 0:
            cap = capture(trainer.model)
            out = step(trainer, batch, u)
            cap.remove()
            res.update(capture=cap, batch0=batch, drawn0=drawn)
        elif profile_last and u == steps - 1:
            ranges = annotate[0]() if annotate else contextlib.nullcontext()
            with ranges, counted_profile() as prof:
                out = step(trainer, batch, u)
                torch.cuda.synchronize()
        else:
            out = step(trainer, batch, u)
        end.record()
        end.synchronize()
        res["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        res["device_ms"].append(start.elapsed_time(end))
        loss, *mad = out if isinstance(out, tuple) else (out,)  # (loss, mad) from the normal trainer
        res["loss"].append(float(loss))
        res["mad"] += [float(m) for m in mad]
        res["per_step"].append({k: kernels.launches[k] - before[k] for k in before})
        if capture is not None and u == 0:
            res["grads0"] = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}
        if save_after and u + 1 == save_after:
            trainer.save(ckpt, 0)
            res["sampler_after_save"] = _sampler_like(trainer.train_sampler, trainer.train_samples)
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    res["params"] = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    before = dict(kernels.launches)
    res["test"] = trainer.test_pass(0)
    res["test_launches"] = {k: kernels.launches[k] - before[k] for k in before}
    if profile_last:
        rows = device_rows(prof)
        profile_gap(f"{sys._getframe(1).f_code.co_name}, step {steps - 1}", prof, rows)
        res["busy_ms"] = sum(r[0] for r in rows) / 1e3
        res["device_ops"] = sum(r[1] for r in rows)
        res["top"] = rows[:8] + [r for r in rows[8:] if "spmm_" in r[2] or "sddmm_" in r[2]]
        if annotate:
            res["range_ms"], res["range_ops"] = range_device_ms(prof, annotate[1])
            if len(annotate) > 2:  # autograd's backward of the ranges' operations, which runs outside them
                res["range_bwd_ms"], res["range_bwd_ops"] = backward_device_ms(prof, annotate[1])
    steady = slice(1, steps - 1)  # not the first step, not the profiled one
    res["device_ms_median"] = float(np.median(res["device_ms"][steady]))
    res["wall_ms_median"] = float(np.median(res["wall_ms"][steady]))
    if profile_last:
        res["idle_share"] = 1 - res["busy_ms"] / res["wall_ms_median"]
    return res


def repeat_run(label: str, trainer, restore, res: dict, draw=_draw_samples, update=None, capture=None) -> None:
    """The run's updates and test pass again once ``restore()`` has put
    back the state of its start, step 0 under ``capture`` where the run
    captured it so (a captured output handed on as a view groups the sums
    of its cotangents otherwise where three or more modules read it, as the
    cascade's skips do); sets ``res["reproduced"]``: bit-identical to the
    run."""
    import torch

    restore()
    again = _train_run(trainer, len(res["loss"]), draw, update=update, capture=capture)
    res["reproduced"] = all(again[k] == res[k] for k in ("drawn", "loss", "mad", "test")) and all(
        torch.equal(v, res["params"][k]) for k, v in again["params"].items())
    log(f"  {label}: two runs of {len(res['loss'])} steps from the same state: losses run 1 "
        f"{[repr(v) for v in res['loss']]}, run 2 {[repr(v) for v in again['loss']]}; test run 1 "
        f"{res['test']!r}, run 2 {again['test']!r}; {'bit-identical' if res['reproduced'] else 'DIFFERENT'}")


def repeat_and_resume(label: str, trainer, snap: dict, res: dict, resume_argv: list, capture=None) -> None:
    """``repeat_run`` from step 0's weights, optimizer and sampler state
    (``snap``), then a fresh trainer resumed from the checkpoint saved after
    NORMAL_RESUME_AFTER updates (``resume_argv``) taking the rest; sets
    ``res["resumed"]``: bit-identical to the run."""
    import torch

    steps = len(res["loss"])
    repeat_run(label, trainer, lambda: _normal_restore(trainer, snap), res, capture=capture)
    logged = []
    fresh = _normal_trainer(resume_argv, f"{label} resumed", logged)
    # the sampler is not in a checkpoint, as in the JAX package
    fresh.train_sampler = _sampler_like(res["sampler_after_save"], fresh.train_samples)
    resumed = _train_run(fresh, steps - NORMAL_RESUME_AFTER)
    res["resumed"] = (fresh.start_epoch == 0 and not any("not loaded" in m for m in logged)
                      and all(resumed[k] == res[k][NORMAL_RESUME_AFTER:] for k in ("drawn", "loss", "mad"))
                      and resumed["test"] == res["test"] and fresh.step == steps
                      and all(torch.equal(v, res["params"][k]) for k, v in resumed["params"].items()))
    log(f"  {label}: resumed after step {NORMAL_RESUME_AFTER} in a fresh trainer: steps "
        f"{NORMAL_RESUME_AFTER + 1}-{steps} losses {[repr(v) for v in resumed['loss']]} vs "
        f"{[repr(v) for v in res['loss'][NORMAL_RESUME_AFTER:]]}; test {resumed['test']}; update count "
        f"{fresh.step}; {'bit-identical' if res['resumed'] else 'DIFFERENT'}")


def fp64_step0_check(label: str, res: dict, model_at, head, op64, bounds: dict, loss_rtol: float,
                     mutants: dict | None = None, null=frozenset(), plain32: bool = True, capture_cls=None,
                     block_op=None, glue=None) -> list[str]:
    """Step 0 of a run (``res``: its loss, gradients, capture and batch)
    against the same step in fp64: the model ``model_at(dtype)`` at step
    0's weights on the batch with the operator ``op64`` (dense fp64
    Laplacians or Dirac pair, no kernel; GAT's ELL pattern, which its
    attention reads as a mask; the Avg, Mlp and Id models read none; or a
    function of the dtype giving the operator, the cascade's dense levels)
    and the loss ``head(out, batch)``.  The modules are captured by
    ``capture_cls`` (default ``StepCapture``); ``block_op(operator, op)``
    picks the part of the fp64 operator a module's captured ``op`` stands
    for (default: all of it); ``glue(capture)`` adds rows of the chain
    computed between the modules.  The whole step's loss within
    ``loss_rtol``, its gradients reported (with ``plain32`` beside the same
    step in fp32 on ``op64``: fp32 rounding without any kernel); then module
    by module (``output_head``, ``replay_modules``; the parameters in
    ``null`` by size) within ``bounds``; the step under each of ``mutants``
    (label -> context manager; default the detached operator applies) must
    fail the module-wise check.  Returns the failures."""
    import dataclasses

    import torch

    b = res["batch0"]
    mutants = {"mutant detached applies": detached_applies} if mutants is None else mutants

    def batch_in(dtype):
        op = op64(dtype) if callable(op64) else op64.to(dtype) if isinstance(op64, torch.Tensor) else op64
        return dataclasses.replace(b, operator=op, inputs=b.inputs.to(dtype), mask=b.mask.to(dtype),
                                   targets=b.targets.to(dtype))

    def step(dtype, batch, ctx=contextlib.nullcontext, capture=False):
        model = model_at(dtype)
        cap = (capture_cls or StepCapture)(model) if capture else None
        try:
            with ctx():
                loss = head(model(batch.operator, batch.mask, batch.inputs), batch)
                loss.backward()
        finally:
            if cap is not None:
                cap.remove()
        # a mutant's detached applies leave some parameters without a gradient
        return float(loss.detach()), {k: torch.zeros_like(p) if p.grad is None else p.grad.detach()
                                      for k, p in model.named_parameters()}, cap

    ref_loss, ref_grads, _ = step(torch.float64, batch_in(torch.float64))
    loss_rel = abs(res["loss"][0] - ref_loss) / abs(ref_loss)
    whole = [_rel_fro(g, ref_grads[k]) for k, g in res["grads0"].items() if k not in null]
    note = ""
    if plain32:
        p_loss, p_grads, _ = step(torch.float32, batch_in(torch.float32))
        plain = [_rel_fro(g, ref_grads[k]) for k, g in p_grads.items() if k not in null]
        note = (f"; the same step in fp32 on the same operator and no kernel: loss rel "
                f"{abs(p_loss - ref_loss) / abs(ref_loss):.3e}, gradient rel_fro median {np.median(plain):.3e}, "
                f"max {max(plain):.3e}")
        del p_grads
    log(f"  {label}: step 0 vs the whole fp64 step: loss {res['loss'][0]:.8f} vs {ref_loss:.8f} (rel {loss_rel:.3e}, "
        f"tol {loss_rtol:g}); gradient rel_fro median {np.median(whole):.3e}, max {max(whole):.3e}{note}")
    del ref_grads
    failures = [] if loss_rel <= loss_rtol else [f"{label}: step-0 loss {res['loss'][0]} vs fp64 {ref_loss}"]
    res["step0"] = {"loss_rel": loss_rel, "whole_grad_fro_median": float(np.median(whole)),
                    "whole_grad_fro_max": max(whole)}
    steps = {"real": (res["loss"][0], res["grads0"], res["capture"]),
             **{lab: step(torch.float32, b, ctx, capture=True) for lab, ctx in mutants.items()}}
    b64 = batch_in(torch.float64)
    runs = {lab: {**output_head(cap, loss, lambda out: head(out, b64)),
                  **replay_modules(cap, grads, model_at(torch.float64),
                                   lambda name, k, op: b64.operator if block_op is None else block_op(b64.operator, op),
                                   torch.float64, null=null),
                  **(glue(cap) if glue else {})}
            for lab, (loss, grads, cap) in steps.items()}
    del b64
    torch.cuda.empty_cache()
    return failures + judge_step0(label, runs, bounds, res)


def normal_phase(device, smi: str) -> tuple[dict, dict]:
    """The normal trainer (``cli/train_normal.py``) in ELL and BSR at ~7,000
    vertices: per format, counts at 0, 8 updates and the test pass; step 0
    against fp64; the run repeated from step 0's state, and resumed from a
    checkpoint saved after step 4 in a fresh trainer, both bit for bit.
    Then the dense run at 2,000 vertices, measured.  Returns the launch
    counts of the ELL and BSR paths together, and per-format results."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    tmp = tempfile.mkdtemp(prefix="normal_smoke_")
    try:
        trainers, snaps, results, path_counts = {}, {}, {}, {}
        for fmt in ("ell", "bsr"):
            t0 = time.perf_counter()
            trainer = _normal_trainer(NORMAL_ARGS + ["--operator-format", fmt], fmt)
            snaps[fmt] = _normal_snapshot(trainer)
            trainers[fmt] = trainer
            log(f"  normal {fmt}: bucket {trainer.buckets.n_vertices}, "
                f"{'bsr_k ' + str(trainer.buckets.bsr_k) if fmt == 'bsr' else 'ell_k 16'}, train meshes "
                f"{[s['V'].shape[0] for s in trainer.train_samples]}, test meshes "
                f"{[s['V'].shape[0] for s in trainer.test_samples]}; {trainer.data_stats()}; "
                f"set-up {time.perf_counter() - t0:.2f} s")
        for fmt, trainer in trainers.items():
            # the main path of this format: every count is 0 just before it and read just after
            kernels.reset_launch_counts()
            results[fmt] = _train_run(trainer, 8, capture=StepCapture, profile_last=True,
                                       save_after=NORMAL_RESUME_AFTER, ckpt=os.path.join(tmp, f"{fmt}.pt"))
            path_counts[fmt] = dict(kernels.launches)
            log(f"  normal {fmt}: launches on the path (8 updates + test pass) {path_counts[fmt]}")

        for fmt, trainer in trainers.items():
            repeat_and_resume(f"normal {fmt}", trainer, snaps[fmt], results[fmt],
                              NORMAL_ARGS + ["--operator-format", fmt, "--deser", os.path.join(tmp, f"{fmt}.pt")])

        t0 = time.perf_counter()
        dense_trainer = _normal_trainer(NORMAL_DENSE_ARGS, "dense")
        log(f"  normal dense: format {dense_trainer.fmt}, bucket {dense_trainer.buckets.n_vertices}; "
            f"set-up {time.perf_counter() - t0:.2f} s")
        kernels.reset_launch_counts()
        results["dense"] = _train_run(dense_trainer, 8, profile_last=True)
        path_counts["dense"] = dict(kernels.launches)
        results["dense"]["fmt"] = dense_trainer.fmt

        failures = []
        for fmt, res in results.items():
            log(f"  normal {fmt}: losses {['%.6f' % v for v in res['loss']]}, mad {['%.4f' % v for v in res['mad']]}; "
                f"test (loss, mad) {res['test']} ({smi})")
            log(f"  normal {fmt}: device ms per step (CUDA events) {['%.2f' % v for v in res['device_ms']]}, median "
                f"of steps 1-6 {res['device_ms_median']:.3f}; host wall per step {['%.2f' % v for v in res['wall_ms']]}, "
                f"median {res['wall_ms_median']:.3f}; profiled step device busy {res['busy_ms']:.3f} ms in "
                f"{res['device_ops']} device ops, idle share {res['idle_share']:.3f} ({smi})")
            for dev_us, count, key in res["top"]:
                log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
            log(f"  normal {fmt}: launches per step {res['per_step'][0]} (expected {NORMAL_PER_STEP[fmt]}); "
                f"test pass {res['test_launches']}")
            if not (np.isfinite(res["loss"]).all() and np.isfinite(res["mad"]).all() and np.isfinite(res["test"]).all()):
                failures.append(f"normal {fmt}: a loss or metric is not finite")
            if any(step != NORMAL_PER_STEP[fmt] for step in res["per_step"]):
                failures.append(f"normal {fmt}: launches per step {res['per_step']} != {NORMAL_PER_STEP[fmt]}")
            test_expected = {k: v // 2 for k, v in NORMAL_PER_STEP[fmt].items()}  # one test mesh, forward only
            if res["test_launches"] != test_expected:
                failures.append(f"normal {fmt}: test-pass launches {res['test_launches']} != {test_expected}")
        if results["dense"]["fmt"] != "dense":
            failures.append(f"normal: auto picked {results['dense']['fmt']} at 2,000 vertices, not dense")
        for fmt in ("ell", "bsr"):
            res = results[fmt]
            if not res["reproduced"]:
                failures.append(f"normal {fmt}: a second run of the 8 steps from the same state differs")
            if not res["resumed"]:
                failures.append(f"normal {fmt}: steps 5-8 resumed from the checkpoint differ from the run")
            for k, g in res["grads0"].items():
                if not (bool(torch.isfinite(g).all()) and bool((g != 0).any())):
                    failures.append(f"normal {fmt}: step-0 gradient of {k} is not finite and non-zero")
            dense = torch.cat([_dense_fp64(s["L"], trainers[fmt].buckets.n_vertices, device) for s in res["drawn0"]])
            failures += fp64_step0_check(f"normal {fmt}", res, _normal_model_at(trainers[fmt], snaps[fmt]["params"]),
                                         _cosine_head, dense, NORMAL_STEP0_BOUNDS, NORMAL_STEP0_LOSS_RTOL)
            del dense
            for key in ("capture", "grads0", "batch0", "drawn0", "params", "sampler_after_save"):
                del res[key]
        if failures:
            raise AssertionError("; ".join(failures))
        counts = {k: path_counts["ell"][k] + path_counts["bsr"][k] for k in path_counts["ell"]}
        return counts, results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _dirac_meshes64(trainer) -> dict:
    """The synthetic set's float64 vertices by sample name, drawn again from
    the seed as ``synthetic_normal_dataset`` draws them; each must be the
    trainer's sample before its float32 cast."""
    from surfacenetworks_tpu_torch.data import datasets

    rng = np.random.default_rng(SEED)
    samples = {s["name"]: s for s in trainer.train_samples + trainer.test_samples}
    out = {}
    for i in range(len(samples)):
        V, F = datasets.random_blob_mesh(rng, DIRAC_POINTS)
        s = samples[f"synthetic_{i}"]
        if not (np.array_equal(s["F"], F) and np.array_equal(s["V"], V.astype(np.float32))):
            raise AssertionError(f"the regenerated mesh {i} differs from the trainer's synthetic_{i}")
        out[s["name"]] = V
    return out


def _quaternion_apply(M, x: np.ndarray) -> np.ndarray:
    """A scipy Dirac matrix ``[4R, 4S]`` on ``x [S, C]`` in quaternion layout."""
    return np.asarray(M @ x.reshape(-1, x.shape[-1] // 4)).reshape(-1, x.shape[-1])


PROFILED_CALLS = 50


def profiled_device_ms(fn) -> tuple[float, list]:
    """Device time of one ``fn()`` that launches several kernels: the device
    work of PROFILED_CALLS calls under ``torch.profiler``, divided by their
    number (CUDA events around the calls would also count the gaps while
    the host launches the next kernel); and the profiler's rows.  The
    window may lose an event or so at its start, so it holds many calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    with counted_profile() as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    profile_gap(f"{sys._getframe(1).f_code.co_name}, {PROFILED_CALLS} calls", prof, rows)
    return sum(r[0] for r in rows) / 1e3 / PROFILED_CALLS, rows


def _dirac_apply_work(op, C: int, side: str, m: int) -> tuple[int, int]:
    """(bytes, flops) of one apply at width ``C`` over the operator's whole
    batch: the features read once, the tables read once, the result written
    once; 8 C flops per live (row, slot) pair (a 4 x 4 Hamilton block on C/4
    channels), and there are 3 m live pairs on either side (one per face
    corner; ``m`` the faces of every item)."""
    face_tables = nbytes(op.faces, op.q_fv)
    vertex_tables = nbytes(*(t for t in (op.vf_face, op.q_vf, op.ov_face, op.q_ov_vf, op.ov_map) if t is not None))
    n_in, n_out = (op.n_vertices, op.n_faces) if side.startswith("vf") else (op.n_faces, op.n_vertices)
    if side in ("vf forward", "fv backward"):
        tables = face_tables
    else:
        tables = vertex_tables
    if side.endswith("backward"):
        n_in, n_out = n_out, n_in
    return op.faces.shape[0] * (n_in + n_out) * C * 4 + tables, 8 * C * 3 * m


def dirac_apply_checks(op, device, meshes: list) -> dict:
    """The Dirac applies on the card on ``op``, packed tables with a leading
    batch axis, at width 128: item b's ``vf`` and ``fv`` and each backward,
    every element within DIRAC_APPLY_RTOL of its own sum |q| |x| against
    the fp64 scipy pair (``geometry.dirac``) of ``meshes[b]``, its float64
    vertices and faces, on the host; mutants without one slot (each side)
    or without the overflow rows must fail.  Then each apply's device time
    over the whole batch, bytes and bound.  Returns the timings."""
    import dataclasses

    import torch

    from surfacenetworks_tpu_torch import geometry as geo
    from surfacenetworks_tpu_torch.sparse import dirac_apply_fv, dirac_apply_vf
    from surfacenetworks_tpu_torch.sparse import ops as sparse_ops

    pairs = [geo.dirac(V, F) for V, F in meshes]
    ns, ms = [V.shape[0] for V, _ in meshes], [F.shape[0] for _, F in meshes]
    B, N, M, C = len(meshes), op.n_vertices, op.n_faces, WIDTH
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(B, N, C, generator=gen, device=device)
    f = torch.randn(B, M, C, generator=gen, device=device)
    gy = torch.randn(B, M, C, generator=gen, device=device)
    gz = torch.randn(B, N, C, generator=gen, device=device)

    def host(t, rows):
        """Every item's first ``rows[b]`` rows, on the host in fp64, one after another."""
        return np.concatenate([t[b, :r].double().cpu().numpy() for b, r in enumerate(rows)])

    def each(fn, t, rows):
        """``fn(item b's pair, |pair|, item b's rows of t)`` for every item, concatenated."""
        return np.concatenate([fn(D, DA, t[b, :r].double().cpu().numpy()) for b, ((D, DA), r) in
                               enumerate(zip(pairs, rows))])

    def run(o, side):
        inp = (x if side == "vf" else f).clone().requires_grad_()
        out = (dirac_apply_vf if side == "vf" else dirac_apply_fv)(o, inp)
        out.backward(gy if side == "vf" else gz)
        return out.detach(), inp.grad

    refs = {
        "vf": (each(lambda D, DA, t: _quaternion_apply(D, t), x, ns),
               each(lambda D, DA, t: _quaternion_apply(abs(D), np.abs(t)), x, ns),
               each(lambda D, DA, t: _quaternion_apply(D.T.tocsr(), t), gy, ms),
               each(lambda D, DA, t: _quaternion_apply(abs(D).T.tocsr(), np.abs(t)), gy, ms)),
        "fv": (each(lambda D, DA, t: _quaternion_apply(DA, t), f, ms),
               each(lambda D, DA, t: _quaternion_apply(abs(DA), np.abs(t)), f, ms),
               each(lambda D, DA, t: _quaternion_apply(DA.T.tocsr(), t), gz, ns),
               each(lambda D, DA, t: _quaternion_apply(abs(DA).T.tocsr(), np.abs(t)), gz, ns)),
    }
    rows = {"vf": (ms, ns), "fv": (ns, ms)}  # (output rows, input rows) of each item
    for side in ("vf", "fv"):
        out, grad = run(op, side)
        ref, scale, gref, gscale = refs[side]
        check(f"dirac_apply_{side} (card) vs the fp64 scipy pair", host(out, rows[side][0]), ref, scale, DIRAC_APPLY_RTOL)
        check(f"dirac_apply_{side} backward (card) vs the pair's transpose", host(grad, rows[side][1]), gref, gscale,
              DIRAC_APPLY_RTOL)
        if any(out[b, r:].any() for b, r in enumerate(rows[side][0])) or any(
                grad[b, r:].any() for b, r in enumerate(rows[side][1])):
            raise AssertionError(f"dirac_apply_{side}: padded rows are not zero")
    slot_vf = op.q_fv.clone()
    slot_vf[..., 2, :] = 0
    slot_fv = op.q_vf.clone()
    slot_fv[..., 0, :] = 0
    no_ov = dataclasses.replace(op, ov_rows=None, ov_face=None, q_ov_vf=None, q_ov_bwd_v=None, ov_map=None)
    refused("dirac_apply_vf without its third slot", host(run(dataclasses.replace(op, q_fv=slot_vf), "vf")[0], ms),
            refs["vf"][0], refs["vf"][1], DIRAC_APPLY_RTOL)
    refused("dirac_apply_fv without its first slot", host(run(dataclasses.replace(op, q_vf=slot_fv), "fv")[0], ns),
            refs["fv"][0], refs["fv"][1], DIRAC_APPLY_RTOL)
    refused("dirac_apply_fv without the overflow rows", host(run(no_ov, "fv")[0], ns), refs["fv"][0], refs["fv"][1],
            DIRAC_APPLY_RTOL)
    refused("dirac_apply_vf backward without the overflow rows", host(run(no_ov, "vf")[1], ns), refs["vf"][2],
            refs["vf"][3], DIRAC_APPLY_RTOL)

    calls = {
        "vf forward": lambda: sparse_ops._gather_apply(op.faces, op.q_fv, x),
        "vf backward": lambda: sparse_ops._vertex_side(op, op.q_bwd_v, op.q_ov_bwd_v, gy),
        "fv forward": lambda: sparse_ops._vertex_side(op, op.q_vf, op.q_ov_vf, f),
        "fv backward": lambda: sparse_ops._gather_apply(op.faces, op.q_bwd_f, gz),
    }
    out = {"applies": {}, "batch": B, "n": ns[0], "m": ms[0], "N": N, "M": M, "base_valence": op.vf_face.shape[-1],
           "overflow_rows": op.ov_face.shape[-2], "max_q_fv": float(op.q_fv.abs().max()),
           "max_q_vf": float(op.q_vf.abs().max())}
    with torch.no_grad():
        for name, fn in calls.items():
            ms_, rows_ = profiled_device_ms(fn)
            b, fl = _dirac_apply_work(op, C, name, sum(ms))
            bms, by = bound_ms(b, fl)
            out["applies"][name] = {"ms": ms_, "bytes": b, "flops": fl, "bound_ms": bms, "bound_by": by,
                                    "device_ops": sum(r[1] for r in rows_) / PROFILED_CALLS}
            log(f"  dirac {name} (batch {B}): device {ms_:.5f} ms in {out['applies'][name]['device_ops']:.2f} device "
                f"ops, {b / 1e6:.2f} MB ({b / ms_ / 1e6:.0f} GB/s of the bytes it must move), bound {bms:.5f} ms "
                f"({by}), {bms / ms_:.1%} of it")
            for dev_us, count, key in rows_[:4]:
                log(f"    {dev_us / 1e3 / PROFILED_CALLS:9.5f} ms  x{count / PROFILED_CALLS:<5.2f} {key[:90]}")
    out["per_step_ms"] = DIRAC_BLOCKS * sum(a["ms"] for a in out["applies"].values())
    out["per_step_bytes"] = DIRAC_BLOCKS * sum(a["bytes"] for a in out["applies"].values())
    return out


@contextlib.contextmanager
def detached_dirac_applies():
    """The mutant's Dirac applies: their outputs detached, so no gradient
    flows through Di or DiA."""
    from surfacenetworks_tpu_torch.nn import blocks

    saved = blocks.apply_dirac_vf, blocks.apply_dirac_fv
    blocks.apply_dirac_vf = lambda op, v: saved[0](op, v).detach()
    blocks.apply_dirac_fv = lambda op, f: saved[1](op, f).detach()
    try:
        yield
    finally:
        blocks.apply_dirac_vf, blocks.apply_dirac_fv = saved


@contextlib.contextmanager
def annotated_dirac_applies():
    """Each Dirac apply (forward or backward, its overflow included) inside
    a profiler range named DIRAC_RANGE, so that the kernels of a profiled
    step can be told apart.  Reading only."""
    import torch

    from surfacenetworks_tpu_torch.sparse import ops

    saved = ops._gather_apply, ops._vertex_side
    depth = [0]  # the overflow's gather runs inside _vertex_side's range

    def ranged(fn):
        def call(*args):
            if depth[0]:
                return fn(*args)
            depth[0] += 1
            try:
                with torch.profiler.record_function(DIRAC_RANGE):
                    return fn(*args)
            finally:
                depth[0] -= 1
        return call

    ops._gather_apply, ops._vertex_side = (ranged(fn) for fn in saved)
    try:
        yield
    finally:
        ops._gather_apply, ops._vertex_side = saved


def range_device_ms(prof, name: str) -> tuple[float, int]:
    """Device time (ms) and count of the kernels that the host operators
    inside the profiler ranges called ``name`` launched."""
    def kernels(e):
        return list(e.kernels) + [k for c in e.cpu_children for k in kernels(c)]

    found = [k for e in prof.events() if e.name == name for k in kernels(e)]
    return sum(k.duration for k in found) / 1e3, len(found)


def backward_device_ms(prof, name: str) -> tuple[float, int]:
    """Device time (ms) and count of the kernels that autograd's backward
    of the operations inside the profiler ranges called ``name`` launched:
    the autograd engine's ``evaluate_function`` events whose sequence
    number is one of those operations' (the profiler numbers a backward
    node as its forward operation)."""
    def walk(e):
        yield e
        for c in e.cpu_children:
            yield from walk(c)

    def kernels(e):
        return list(e.kernels) + [k for c in e.cpu_children for k in kernels(c)]

    seqs = {c.sequence_nr for e in prof.events() if e.name == name for c in walk(e) if c.sequence_nr >= 0}
    found = []
    for e in prof.events():
        if e.name.startswith("autograd::engine::evaluate_function") and e.cpu_parent is None:
            seq = e.sequence_nr if e.sequence_nr >= 0 else next(
                (c.sequence_nr for c in e.cpu_children if c.sequence_nr >= 0), -1)
            if seq in seqs:
                found += kernels(e)
    return sum(k.duration for k in found) / 1e3, len(found)


@contextlib.contextmanager
def annotated_attends():
    """Each attend's forward (``blocks.gat_attend``) inside a profiler range
    named GAT_RANGE.  Reading only."""
    import torch

    from surfacenetworks_tpu_torch.nn import blocks

    saved = blocks.gat_attend

    def ranged(*args, **kwargs):
        with torch.profiler.record_function(GAT_RANGE):
            return saved(*args, **kwargs)

    blocks.gat_attend = ranged
    try:
        yield
    finally:
        blocks.gat_attend = saved


@contextlib.contextmanager
def detached_attends():
    """The mutant's attends: their outputs detached, so no gradient flows
    through the attention."""
    from surfacenetworks_tpu_torch.nn import blocks

    saved = blocks.gat_attend
    blocks.gat_attend = lambda *args, **kwargs: saved(*args, **kwargs).detach()
    try:
        yield
    finally:
        blocks.gat_attend = saved


def attend_device_ms(op, dtype) -> dict:
    """One attend forward and backward alone at a GAT run's shapes (the
    batch's ELL pattern, WIDTH channels in GAT_HEADS heads, fp32 scores on
    ``dtype`` features), its kernels' device time under the profiler
    (``profiled_device_ms``), forward and forward + backward."""
    import torch

    from surfacenetworks_tpu_torch.nn import blocks

    B, N = op.fwd.cols.shape[:2]
    gen = torch.Generator(device=op.fwd.cols.device).manual_seed(SEED + 23)
    xh = torch.randn(B, N, blocks.GAT_HEADS, WIDTH // blocks.GAT_HEADS, device=op.fwd.cols.device,
                     generator=gen).to(dtype).requires_grad_()
    ss, sd = (torch.randn(B, N, blocks.GAT_HEADS, device=op.fwd.cols.device, generator=gen).requires_grad_()
              for _ in range(2))
    cot = torch.randn(B, N, blocks.GAT_HEADS, WIDTH // blocks.GAT_HEADS, device=op.fwd.cols.device, generator=gen)

    def both():
        blocks.gat_attend(op, xh, ss, sd).backward(cot)

    with torch.no_grad():
        fwd_ms, _ = profiled_device_ms(lambda: blocks.gat_attend(op, xh, ss, sd))
    ms, rows = profiled_device_ms(both)
    return {"fwd_ms": fwd_ms, "ms": ms, "top": rows[:6]}


@contextlib.contextmanager
def scaled_dirac_backward(scale: float = DIRAC_MUTANT_SCALE):
    """The mutant's Dirac applies: the values as they are, the cotangent
    through each apply multiplied by ``scale``."""
    from surfacenetworks_tpu_torch.nn import blocks

    saved = blocks.apply_dirac_vf, blocks.apply_dirac_fv

    def scaled(fn):
        def call(op, x):
            y = fn(op, x)
            return y + (scale - 1) * (y - y.detach())
        return call

    blocks.apply_dirac_vf, blocks.apply_dirac_fv = (scaled(fn) for fn in saved)
    try:
        yield
    finally:
        blocks.apply_dirac_vf, blocks.apply_dirac_fv = saved


def dirac_step0_check(trainer, state0, res, meshes64: dict) -> list[str]:
    """Step 0 against the same step in fp64 on the dense fp64 Dirac pair
    of the float64 vertices (``dense_dirac_pair``; no structured apply)
    (``fp64_step0_check``); two mutants must fail the module-wise check:
    the applies detached, and their cotangents DIRAC_MUTANT_SCALE times too
    large.  Returns the failures."""
    import torch

    from surfacenetworks_tpu_torch.data.batching import dense_dirac_pair

    pair64 = dense_dirac_pair([{"V": meshes64[s["name"]], "F": s["F"]} for s in res["drawn0"]],
                              trainer.buckets.n_vertices, trainer.buckets.n_faces, torch.float64, trainer.device)
    failures = fp64_step0_check(
        "dirac", res, _normal_model_at(trainer, state0), _cosine_head, pair64,
        {"chain": DIRAC_STEP0_CHAIN_RTOL, "parameter": STEP0_PARAM_RTOL, "null": NULL_GRAD_RTOL}, NORMAL_STEP0_LOSS_RTOL,
        {"mutant detached applies": detached_dirac_applies,
         f"mutant cotangents x{DIRAC_MUTANT_SCALE:g}": scaled_dirac_backward}, DIRAC_NULL_GRADS, plain32=False)
    del pair64
    torch.cuda.empty_cache()
    return failures


def dirac_phase(device, smi: str) -> dict:
    """The normal trainer with ``--model dirac`` at ~7,000 vertices: the
    applies checked and timed, then (counts at 0) 8 updates and the test
    pass, which must launch none of the three kernels; step 0 against fp64;
    the run repeated from step 0's state, and resumed from a checkpoint
    saved after step 4 in a fresh trainer, both bit for bit.  Returns the
    results."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    tmp = tempfile.mkdtemp(prefix="dirac_smoke_")
    try:
        t0 = time.perf_counter()
        logged = []
        trainer = _normal_trainer(DIRAC_ARGS, "dirac", logged)
        b = trainer.buckets
        log(f"  dirac: format {trainer.fmt}, buckets {b.n_vertices} x {b.n_faces}, max valence {b.max_valence} "
            f"packed to {b.dirac_base_valence} with {b.dirac_overflow} overflow rows; train meshes "
            f"{[(s['V'].shape[0], s['F'].shape[0]) for s in trainer.train_samples]}, test meshes "
            f"{[(s['V'].shape[0], s['F'].shape[0]) for s in trainer.test_samples]}; {trainer.data_stats()}; "
            f"set-up {time.perf_counter() - t0:.2f} s")
        snap = _normal_snapshot(trainer)
        meshes64 = _dirac_meshes64(trainer)
        sample = next(s for s in trainer.train_samples + trainer.test_samples if s["name"] == "synthetic_0")
        applies = dirac_apply_checks(trainer.packed.one(sample).operator.to(device), device,
                                     [(meshes64["synthetic_0"], sample["F"])])

        # the main path: every count is 0 just before it and read just after
        kernels.reset_launch_counts()
        res = _train_run(trainer, DIRAC_STEPS, capture=StepCapture, profile_last=True,
                          save_after=NORMAL_RESUME_AFTER, ckpt=os.path.join(tmp, "dirac.pt"),
                          annotate=(annotated_dirac_applies, DIRAC_RANGE))
        path_counts = dict(kernels.launches)
        res["applies"] = applies
        res["apply_share"] = res["range_ms"] / res["busy_ms"]
        log(f"  dirac: launches on the path ({DIRAC_STEPS} updates + test pass) {path_counts} (expected none)")

        repeat_and_resume("dirac", trainer, snap, res, DIRAC_ARGS + ["--deser", os.path.join(tmp, "dirac.pt")])

        log(f"  dirac: losses {['%.6f' % v for v in res['loss']]}, mad {['%.4f' % v for v in res['mad']]}; "
            f"test (loss, mad) {res['test']} ({smi})")
        log(f"  dirac: device ms per step (CUDA events) {['%.2f' % v for v in res['device_ms']]}, median of steps "
            f"1-6 {res['device_ms_median']:.3f}; host wall per step {['%.2f' % v for v in res['wall_ms']]}, median "
            f"{res['wall_ms_median']:.3f}; profiled step device busy {res['busy_ms']:.3f} ms in {res['device_ops']} "
            f"device ops, idle share {res['idle_share']:.3f}; peak device memory {res['peak_mib']:.1f} MiB ({smi})")
        for dev_us, count, key in res["top"]:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        log(f"  dirac: the applies in the profiled step ({DIRAC_BLOCKS} blocks x vf and fv, forward and backward): "
            f"{res['range_ms']:.4f} ms in {res['range_ops']} device ops, {res['apply_share']:.1%} of its busy time; "
            f"each apply alone under the profiler, times {DIRAC_BLOCKS} blocks: {applies['per_step_ms']:.4f} ms; "
            f"{applies['per_step_bytes'] / 1e6:.1f} MB they must move, "
            f"{applies['per_step_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s ({smi})")

        failures = []
        if any(path_counts.values()) or any(any(step.values()) for step in res["per_step"]) or any(
                res["test_launches"].values()):
            failures.append(f"dirac: the path launched a kernel: {path_counts}")
        if not (np.isfinite(res["loss"]).all() and np.isfinite(res["mad"]).all() and np.isfinite(res["test"]).all()):
            failures.append("dirac: a loss or metric is not finite")
        if not any("structured Dirac tables" in m for m in logged):
            failures.append("dirac: the trainer did not log its operator format")
        if not res["reproduced"]:
            failures.append("dirac: a second run of the 8 steps from the same state differs")
        if not res["resumed"]:
            failures.append("dirac: steps 5-8 resumed from the checkpoint differ from the run")
        for k, g in res["grads0"].items():
            if not (bool(torch.isfinite(g).all()) and (k in DIRAC_NULL_GRADS or bool((g != 0).any()))):
                failures.append(f"dirac: step-0 gradient of {k} is not finite and non-zero")
        if not 0 < res["range_ms"] <= res["busy_ms"]:
            failures.append(f"dirac: the applies' device time in the profiled step reads {res['range_ms']} ms of "
                            f"{res['busy_ms']} ms busy")
        failures += dirac_step0_check(trainer, snap["params"], res, meshes64)
        for key in ("capture", "grads0", "batch0", "drawn0", "params", "sampler_after_save"):
            del res[key]
        if failures:
            raise AssertionError("; ".join(failures))
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def zoo_phase(device, smi: str) -> dict:
    """The rest of the normal zoo (ZOO_RUNS) through the normal trainer at
    ~7,000 vertices: per run, counts at 0, ZOO_STEPS updates (step 0
    captured, the last profiled: the attends inside profiler ranges) and
    the test pass, none launching a kernel; the run again from its start,
    bit for bit; step 0 against fp64 module by module (a GAT with detached
    attends refused); one attend alone timed at the run's shapes.  Returns
    the results by run."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    results, failures = {}, []
    for label, extra in ZOO_RUNS.items():
        t0 = time.perf_counter()
        logged = []
        trainer = _normal_trainer(ZOO_ARGS + extra, label, logged)
        snap = _normal_snapshot(trainer)
        gat = trainer.args.model == "gat"
        log(f"  zoo {label}: {type(trainer.model).__name__}-{ZOO_LAYERS}, format {trainer.fmt}, bucket "
            f"{trainer.buckets.n_vertices}, {len(trainer.train_samples)} train meshes, "
            f"{len(trainer.test_samples)} test; {trainer.data_stats()}; set-up {time.perf_counter() - t0:.2f} s")
        # the main path of this run: every count is 0 just before it and read just after
        kernels.reset_launch_counts()
        res = _train_run(trainer, ZOO_STEPS, capture=StepCapture, profile_last=True,
                         annotate=(annotated_attends, GAT_RANGE, "backward") if gat else None)
        counts = dict(kernels.launches)
        repeat_run(f"zoo {label}", trainer, lambda: _normal_restore(trainer, snap), res)
        log(f"  zoo {label}: losses {[repr(v) for v in res['loss']]}, mad {['%.4f' % v for v in res['mad']]}; test "
            f"(loss, mad) {res['test']!r} ({smi})")
        log(f"  zoo {label}: host wall per step {['%.2f' % v for v in res['wall_ms']]}, median "
            f"{res['wall_ms_median']:.3f} ms; device ms per step (CUDA events) median {res['device_ms_median']:.3f}; "
            f"profiled step device busy {res['busy_ms']:.3f} ms in {res['device_ops']} device ops, idle share "
            f"{res['idle_share']:.3f}; peak device memory {res['peak_mib']:.1f} MiB ({smi})")
        for dev_us, count, key in res["top"]:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        if gat:
            op = res["batch0"].operator
            res["attend"] = attend_device_ms(op, torch.bfloat16 if trainer.args.bf16 else torch.float32)
            res["attend_ms"] = res["range_ms"] + res["range_bwd_ms"]
            res["attend_share"] = res["attend_ms"] / res["busy_ms"]
            a = res["attend"]
            log(f"  zoo {label}: the attends in the profiled step ({GAT_ATTENDS} a forward): forward "
                f"{res['range_ms']:.4f} ms in {res['range_ops']} device ops, their backward {res['range_bwd_ms']:.4f} ms "
                f"in {res['range_bwd_ops']}, together {res['attend_share']:.1%} of busy; one attend alone at "
                f"R={op.fwd.cols.shape[1]} K={op.fwd.cols.shape[2]} C={WIDTH}: forward {a['fwd_ms']:.4f} ms, forward "
                f"+ backward {a['ms']:.4f} ms, times {GAT_ATTENDS}: {GAT_ATTENDS * a['ms']:.4f} ms ({smi})")
            for dev_us, count, key in a["top"]:
                log(f"    {dev_us / 1e3 / PROFILED_CALLS:9.5f} ms  x{count / PROFILED_CALLS:<5.2f} {key[:90]}")
            if not 0 < res["attend_ms"] <= res["busy_ms"]:
                failures.append(f"zoo {label}: the attends' device time reads {res['attend_ms']} of {res['busy_ms']} ms")
            if not (trainer.fmt == "ell" and any("operator format -> ell" in m for m in logged)
                    and "rcm_perm" in trainer.train_samples[0]):
                failures.append(f"zoo {label}: not ELL over RCM order")
        if "--flip-variants" in extra and not any("flip augmentation: +4 variants" in m for m in logged):
            failures.append(f"zoo {label}: the flip variants are missing")
        if any(counts.values()) or any(any(step.values()) for step in res["per_step"]) or any(
                res["test_launches"].values()):
            failures.append(f"zoo {label}: the path launched a kernel: {counts}")
        if not (np.isfinite(res["loss"]).all() and np.isfinite(res["mad"]).all() and np.isfinite(res["test"]).all()):
            failures.append(f"zoo {label}: a loss or metric is not finite")
        if not res["reproduced"]:
            failures.append(f"zoo {label}: a second run from the same state differs")
        null = ZOO_NULL_GRADS.get(trainer.args.model, set())
        for k, g in res["grads0"].items():
            if not (g.dtype == torch.float32 and bool(torch.isfinite(g).all()) and (k in null or bool((g != 0).any()))):
                failures.append(f"zoo {label}: step-0 gradient of {k} is not fp32, finite and non-zero")
        failures += fp64_step0_check(f"zoo {label}", res, _normal_model_at(trainer, snap["params"]), _cosine_head,
                                     res["batch0"].operator, NORMAL_STEP0_BOUNDS, NORMAL_STEP0_LOSS_RTOL,
                                     {"mutant detached attends": detached_attends} if gat else {}, null)
        for key in ("capture", "grads0", "batch0", "drawn0", "params", "drawn"):
            res.pop(key, None)
        res["counts"] = counts
        results[label] = res
        del trainer, snap
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return results


class CascadeCapture(ModuleCapture):
    """``ModuleCapture`` of an EfficientCascade's modules in call order
    (``conv1``, the down blocks, ``lap0``, the up blocks, ``conv2``) in
    ``names``, and of the model itself as ``trunk``."""

    def __init__(self, model):
        k = model.cascade_levels
        names = (["conv1"] + [f"down_rn{i}" for i in range(k - 1, 0, -1)] + ["lap0"]
                 + [f"up_rn{i}" for i in range(1, k)] + ["conv2"])
        super().__init__(model, {**{n: n for n in names}, "trunk": ""})
        self.names = names


def cascade_glue(cap: CascadeCapture) -> dict:
    """The trainer's cascade's glue (naive pooling, no Avg blocks) between
    its captured modules, replayed in fp64
    from the card's own module outputs and input cotangents, against what
    the card handed on: each block's input and mask (max-pooling down,
    2x upsampling and the skip add up, the ELU into ``conv2``, the input
    residual at the output), and each module's output cotangent (the
    pooling's, the upsampling's and the skips' backward).  Chain rows
    (relative Frobenius) by key."""
    import torch
    import torch.nn.functional as F

    from surfacenetworks_tpu_torch.models.cascade import max_pool2, upsample2
    from surfacenetworks_tpu_torch.nn.layers import repeating_expand

    c = {n: cap.calls[n][0] for n in cap.names + ["trunk"]}
    k = sum(n.startswith("up_rn") for n in cap.names) + 1
    out = {n: c[n]["out"][0].double() for n in cap.names}
    gout = {n: c[n]["g"][0].double() for n in cap.names}
    x_in = {n: c[n]["args"][-1] for n in cap.names}  # a block's (op, mask, x), conv2's (x,)
    gin = {n: c[n]["gin"][-1].double() for n in cap.names if n != "conv1"}
    errs = {}

    def row(key, card, ref):
        errs[f"glue {key}"] = _rel_fro(card, ref)

    def pool_vjp(y, g):
        y = y.clone().requires_grad_()
        max_pool2(y).backward(g)
        return y.grad

    def pairs(g):  # upsample2's backward: each coarse row gets its two fine rows' sum
        b, n, ch = g.shape
        return g.reshape(b, n // 2, 2, ch).sum(dim=2)

    x, ma = out["conv1"], c["trunk"]["args"][1].double()
    for i in range(k - 1, 0, -1):
        n = f"down_rn{i}"
        row(f"{n} input", x_in[n], x)
        row(f"{n} mask", c[n]["args"][1], ma)
        x, ma = max_pool2(out[n]), max_pool2(ma)
    row("lap0 input", x_in["lap0"], x)
    x = out["lap0"]
    for i in range(1, k):
        n = f"up_rn{i}"
        x = upsample2(x)
        x = x + x_in[f"down_rn{i}"].double()[..., : x.shape[-1]]
        row(f"{n} input", x_in[n], x)
        row(f"{n} mask", c[n]["args"][1], c[f"down_rn{i}"]["args"][1].double())
        x = out[n]
    row("conv2 input", x_in["conv2"], F.elu(x))
    row("output", c["trunk"]["out"][0], out["conv2"] + repeating_expand(c["trunk"]["args"][2].double(), 3))
    # backward: a pooled tensor feeds the next block and, but at the coarsest, an up block's skip
    row("conv1 output cotangent", gout["conv1"], gin[f"down_rn{k - 1}"] + gin[f"up_rn{k - 1}"])
    for i in range(k - 1, 0, -1):
        nxt = gin[f"down_rn{i - 1}" if i > 1 else "lap0"] + (gin[f"up_rn{i - 1}"] if i > 1 else 0)
        row(f"down_rn{i} output cotangent", gout[f"down_rn{i}"], pool_vjp(out[f"down_rn{i}"], nxt))
    row("lap0 output cotangent", gout["lap0"], pairs(gin["up_rn1"]))
    for i in range(1, k - 1):
        row(f"up_rn{i} output cotangent", gout[f"up_rn{i}"], pairs(gin[f"up_rn{i + 1}"]))
    y = out[f"up_rn{k - 1}"]
    row(f"up_rn{k - 1} output cotangent", gout[f"up_rn{k - 1}"],
        gin["conv2"] * torch.where(y > 0, torch.ones_like(y), torch.exp(y)))
    return errs


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def detached_level_applies(rows: int):
    """The mutant's ELL applies at the pyramid level of ``rows`` rows
    return detached outputs (no gradient through that level's L)."""
    from surfacenetworks_tpu_torch.nn import blocks

    real = blocks.spmm
    return swapped(blocks, "spmm", lambda op, x: real(op, x).detach() if op.fwd.n_rows == rows else real(op, x))


def tiled_upsampling():
    """The mutant's upsampling tiles the rows (``repeat``) where each row
    should be repeated in place (``repeat_interleave``)."""
    from surfacenetworks_tpu_torch.models import cascade

    return swapped(cascade, "upsample2", lambda x: x.repeat(1, 2, 1))


def first_slot_pooling():
    """Max-pooling by ``max(dim)``, which gives a tie's gradient to its
    first row (``jnp.max`` and ``amax`` split it evenly)."""
    from surfacenetworks_tpu_torch.models import cascade

    def pool(x):
        b, n, c = x.shape
        return x.reshape(b, n // 2, 2, c).max(dim=2).values

    return swapped(cascade, "max_pool2", pool)


def _ell_csr(cols, vals):
    """An ELL matrix's live slots as a scipy CSR on the host."""
    import scipy.sparse as sp

    cols, vals = cols.cpu().numpy(), vals.cpu().numpy()
    R, K = cols.shape
    live = vals != 0
    rows = np.repeat(np.arange(R), K).reshape(R, K)
    return sp.csr_matrix((vals[live], (rows[live], cols[live])), shape=(R, R))


def _dense_levels64(levels) -> list:
    """A batch's pyramid levels (ELL, one mesh each) as dense fp64 ``[1, R,
    R]`` on the card: the fp32 values the kernels read, widened."""
    import torch

    out = []
    for op in levels:
        cols, vals = op.fwd.cols[0], op.fwd.vals[0]
        R, K = cols.shape
        d = torch.zeros(R, R, dtype=torch.float64, device=cols.device)
        rows = torch.arange(R, device=cols.device)[:, None].expand(R, K)
        d.index_put_((rows.reshape(-1), cols.reshape(-1).long()), vals.reshape(-1).double(), accumulate=True)
        out.append(d[None])
    return out


def cascade_kernel_checks(trainer, device) -> dict:
    """``ell_matmul`` at each pyramid level's shape (K=32, C=128): the
    level's operators of every mesh stacked as one batch through
    ``batched_ell_checks`` (forward and backward against the plain version
    in fp32 and fp64, item 0's operator in every item refused, the bf16
    variant); then one mesh's level, as a step launches it, two launches
    bit for bit (fp32 and bf16 x), timed warm and cold against its plain
    version, ``torch.sparse.mm`` on a CSR copy and two bounds: every stored
    slot's column and value read, and the live slots' only.  Returns the
    report."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    rep = {"levels": [], "levels_batched": []}
    gen = torch.Generator(device=device).manual_seed(SEED + 601)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)
    for lvl, op in enumerate(trainer.store[0].tree.operator):
        S = op.fwd.cols.shape[0]
        csrs = [_ell_csr(op.fwd.cols[i], op.fwd.vals[i]) for i in range(S)]
        rep["levels_batched"].append(batched_ell_checks(op, csrs, device, f"the cascade's level {lvl} ({S} meshes)",
                                                        WIDTH, SEED + 610 + lvl))
        cols, vals = op.fwd.cols[0], op.fwd.vals[0]
        R, K = cols.shape
        x = torch.randn(R, WIDTH, device=device, generator=gen)
        xh = x.to(torch.bfloat16)
        for t in (x, xh):
            if not torch.equal(kernels.ell_matmul(cols, vals, t), kernels.ell_matmul(cols, vals, t)):
                raise AssertionError(f"ell_matmul at the cascade's level {lvl} ({t.dtype} x): two launches differ")
        out = torch.empty(R, WIDTH, device=device)
        live = vals != 0
        nnz = int(live.sum())
        csr = _ell_csr(cols, vals)
        lib = torch.sparse_csr_tensor(torch.from_numpy(csr.indptr.astype(np.int64)),
                                      torch.from_numpy(csr.indices.astype(np.int64)),
                                      torch.from_numpy(csr.data.astype(np.float32)), size=csr.shape).to(device)
        b_ms, b_by = bound_ms(nbytes(cols, vals, x, out), 2 * nnz * WIDTH)
        live_bytes = nnz * (cols.element_size() + vals.element_size()) + nbytes(x, out)
        lb_ms, lb_by = bound_ms(live_bytes, 2 * nnz * WIDTH)
        b16, b16_by = bound_ms(nbytes(cols, vals, xh, out), 2 * nnz * WIDTH)
        r = {"level": lvl, "shape": [R, K, WIDTH], "live_slots": nnz, "max_live_per_row": int(live.sum(1).max()),
             "ms": time_ms(lambda: kernels.ell_matmul(cols, vals, x)),
             "cold_ms": cold_ms(lambda: kernels.ell_matmul(cols, vals, x), flush),
             "plain_ms": time_ms(lambda: kernels.ell_matmul_plain(cols, vals, x)),
             "library_ms": time_ms(lambda: torch.sparse.mm(lib, x)), "library_call": "torch.sparse.mm(csr, x)",
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(cols, vals, x, out), "flops": 2 * nnz * WIDTH,
             "live_bound_ms": lb_ms, "live_bound_by": lb_by, "live_bytes": live_bytes,
             "bf16": {"ms": time_ms(lambda: kernels.ell_matmul(cols, vals, xh)),
                      "cold_ms": cold_ms(lambda: kernels.ell_matmul(cols, vals, xh), flush),
                      "plain_ms": time_ms(lambda: kernels.ell_matmul_plain(cols, vals, xh)), "library_ms": None,
                      "bound_ms": b16, "bound_by": b16_by, "bytes": nbytes(cols, vals, xh, out)}}
        rep["levels"].append(r)
        log(f"  ell_matmul cascade level {lvl} (R={R}, K={K}, C={WIDTH}; {nnz} live slots, at most "
            f"{r['max_live_per_row']} a row): {r['ms']:.5f} ms warm, {r['cold_ms']:.5f} ms cold L2 (plain "
            f"{r['plain_ms']:.4f}, {r['library_call']} {r['library_ms']:.4f}; {r['library_ms'] / r['ms']:.2f}x the "
            f"kernel); bound {b_ms:.5f} ms by {b_by} ({r['bytes'] / 1e6:.2f} MB, every slot; {b_ms / r['ms']:.1%} of "
            f"it), the live slots' bound {lb_ms:.5f} ms ({live_bytes / 1e6:.2f} MB; {lb_ms / r['ms']:.1%}); bf16 x "
            f"{r['bf16']['ms']:.5f} ms warm, {r['bf16']['cold_ms']:.5f} cold (bound {b16:.5f})")
    del flush
    return rep


def _report_run(label: str, res: dict, smi: str) -> None:
    log(f"  {label}: losses {[repr(v) for v in res['loss']]}, mad {['%.4f' % v for v in res['mad']]}; test "
        f"(loss, mad) {res['test']!r} ({smi})")
    log(f"  {label}: host wall per step {['%.2f' % v for v in res['wall_ms']]}, median {res['wall_ms_median']:.3f} ms; "
        f"device ms per step (CUDA events) median {res['device_ms_median']:.3f}; profiled step device busy "
        f"{res['busy_ms']:.3f} ms in {res['device_ops']} device ops, idle share {res['idle_share']:.3f}; peak device "
        f"memory {res['peak_mib']:.1f} MiB ({smi})")
    for dev_us, count, key in res["top"]:
        log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")


def _run_failures(label: str, res: dict, per_step: dict, per_test: dict) -> list[str]:
    """Finite losses and metrics, the launches of every step and of the test
    pass, the repeat (and, where run, the resume) bit for bit, step 0's
    gradients finite and non-zero."""
    import torch

    failures = []
    if not (np.isfinite(res["loss"]).all() and np.isfinite(res["mad"]).all() and np.isfinite(res["test"]).all()):
        failures.append(f"{label}: a loss or metric is not finite")
    if any(step != per_step for step in res["per_step"]) or res["test_launches"] != per_test:
        failures.append(f"{label}: launches per step {res['per_step']}, test pass {res['test_launches']}; expected "
                        f"{per_step}, {per_test}")
    if not res["reproduced"]:
        failures.append(f"{label}: a second run from the same state differs")
    if not res.get("resumed", True):
        failures.append(f"{label}: the steps resumed from the checkpoint differ from the run")
    for k, g in res.get("grads0", {}).items():
        if not (bool(torch.isfinite(g).all()) and bool((g != 0).any())):
            failures.append(f"{label}: step-0 gradient of {k} is not finite and non-zero")
    return failures


def cascade_phase(device, smi: str) -> tuple[dict, dict]:
    """The cascade (``--model cas``) through the normal trainer on the
    normal cell's data: ``ell_matmul`` at the four levels
    (``cascade_kernel_checks``); counts at 0, 8 updates and the test pass
    (step 0 captured, the last profiled, a checkpoint after update 4); the
    run repeated from step 0's state and resumed in a fresh trainer, bit
    for bit; step 0 against fp64 module by module with the glue, the two
    mutants refused; how far max(dim) pooling moves step 0's gradients
    (reported); then the same 8 updates with --bf16 (step 0 against the
    plain versions in bf16, repeat bit for bit).  Returns the launch counts
    of both paths and the results."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    tmp = tempfile.mkdtemp(prefix="cascade_smoke_")
    results, counts, failures = {}, {}, []
    try:
        t0 = time.perf_counter()
        logged = []
        trainer = _normal_trainer(CASCADE_ARGS, "cas", logged)
        snap = _normal_snapshot(trainer)
        tree = trainer.store[0].tree
        rows = [op.fwd.n_rows for op in tree.operator]
        samples = trainer.train_samples + trainer.test_samples
        kept = [int(v) for v in tree.mask.sum(dim=(1, 2)).tolist()]
        verts = [s["V"].shape[0] for s in samples]
        log(f"  cascade: EfficientCascade-{CASCADE_LEVELS} at width {WIDTH}, levels of {rows} rows (K=32), "
            f"{len(trainer.train_samples)} train meshes, {len(trainer.test_samples)} test; kept vertices per mesh "
            f"{kept} of {verts} (the JAX pyramid's drop: {[v - k for v, k in zip(verts, kept)]}); "
            f"{trainer.data_stats()}; set-up {time.perf_counter() - t0:.2f} s")
        results["kernel"] = cascade_kernel_checks(trainer, device)

        kernels.reset_launch_counts()  # the main path: every count 0 just before it, read just after
        res = _train_run(trainer, CASCADE_STEPS, capture=CascadeCapture, profile_last=True,
                         save_after=NORMAL_RESUME_AFTER, ckpt=os.path.join(tmp, "cas.pt"))
        counts["fp32"] = dict(kernels.launches)
        log(f"  cascade: launches on the path ({CASCADE_STEPS} updates + test pass) {counts['fp32']}")
        repeat_and_resume("cascade", trainer, snap, res, CASCADE_ARGS + ["--deser", os.path.join(tmp, "cas.pt")],
                          CascadeCapture)
        _report_run("cascade", res, smi)
        per_test = {k: v // 2 * len(trainer.test_samples) for k, v in CASCADE_PER_STEP.items()}
        failures += _run_failures("cascade", res, CASCADE_PER_STEP, per_test)
        cap = res["capture"]
        ties = {f"down_rn{i}": int((cap.calls[f"down_rn{i}"][0]["out"][0][:, 0::2]
                                    == cap.calls[f"down_rn{i}"][0]["out"][0][:, 1::2]).all(-1).sum())
                for i in range(CASCADE_LEVELS - 1, 0, -1)}
        dense = _dense_levels64(res["batch0"].operator)
        level_of = {r: i for i, r in enumerate(rows)}
        model_at = _normal_model_at(trainer, snap["params"])
        failures += fp64_step0_check(
            "cascade", res, model_at, _cosine_head, lambda dt: tuple(d.to(dt) for d in dense), NORMAL_STEP0_BOUNDS,
            NORMAL_STEP0_LOSS_RTOL, {"mutant detached finest-level applies": lambda: detached_level_applies(rows[-1]),
                                     "mutant upsampling by tiling": tiled_upsampling},
            capture_cls=CascadeCapture, block_op=lambda levels, op: levels[level_of[op.fwd.n_rows]], glue=cascade_glue)
        del dense
        model = model_at(torch.float32)  # step 0 with max(dim) pooling: reported, not held
        with first_slot_pooling():
            b = res["batch0"]
            _cosine_head(model(b.operator, b.mask, b.inputs), b).backward()
        moved = {k: _rel_fro(res["grads0"][k], p.grad.double()) for k, p in model.named_parameters()}
        res["max_dim_pooling"] = {"tied_pairs": ties, "grad_rel_fro_median": float(np.median(list(moved.values()))),
                                  "grad_rel_fro_max": max(moved.values())}
        log(f"  cascade: tied row pairs at the poolings of step 0 {ties}; step 0 with max(dim) pooling (a tie's "
            f"gradient to its first row) moves the parameter gradients by rel_fro median "
            f"{res['max_dim_pooling']['grad_rel_fro_median']:.3e}, max {max(moved.values()):.3e} "
            f"({max(moved, key=moved.get)}); reported, not held")
        del model
        for key in ("capture", "grads0", "batch0", "drawn0", "params", "drawn", "sampler_after_save"):
            res.pop(key, None)
        results["fp32"] = res
        del trainer, snap
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        trainer = _normal_trainer(CASCADE_ARGS + ["--bf16"], "cas bf16")
        snap = _normal_snapshot(trainer)
        ref = copy.deepcopy(trainer.model)
        log(f"  cascade bf16: set-up {time.perf_counter() - t0:.2f} s")
        kernels.reset_launch_counts()
        res = _train_run(trainer, CASCADE_STEPS, capture=CascadeCapture, profile_last=True)
        counts["bf16"] = dict(kernels.launches)
        log(f"  cascade bf16: launches on the path ({CASCADE_STEPS} updates + test pass) {counts['bf16']}")
        repeat_run("cascade bf16", trainer, lambda: _normal_restore(trainer, snap), res, capture=CascadeCapture)
        failures += bf16_run_checks("normal cas", res, trainer.model, len(trainer.test_samples), results["fp32"], smi)
        failures += plain_step0_check("bf16 cascade", res, ref)
        for key in ("capture", "grads0", "batch0", "drawn0", "params", "drawn"):
            res.pop(key, None)
        results["bf16"] = res
        del trainer, ref
        torch.cuda.empty_cache()
        if failures:
            raise AssertionError("; ".join(failures))
        return counts, results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rotate_phase(device, smi: str, unrotated_loss0: float) -> tuple[dict, dict]:
    """``--rotate-augment`` on the normal Lap-15 ELL run: the rotations of
    the run's steps on the card against the host's (fp64 from the same fp32
    angles), orthonormal with determinant 1; counts at 0, 4 updates (each
    update's rotations recorded and held to the host's draw of its step)
    and the test pass; the repeat bit for bit; the first loss differs from
    the unrotated run's (``unrotated_loss0``, the same weights and batch).
    Returns the launch counts and the results."""
    import torch

    from surfacenetworks_tpu_torch.cli import train_normal as tn
    from surfacenetworks_tpu_torch.sparse import kernels
    from surfacenetworks_tpu_torch.train import prng

    failures = []
    trainer = _normal_trainer(NORMAL_ARGS + ["--operator-format", "ell", "--rotate-augment",
                                             "--num-updates", str(ROTATE_STEPS)], "rotate")
    snap = _normal_snapshot(trainer)
    seed, worst = trainer.args.seed, {"host": 0.0, "orthonormal": 0.0, "det": 0.0}
    for step in range(ROTATE_STEPS):
        card = tn.step_rotations(seed, step, 1, device)
        angles = prng.uniform(prng.fold_in(prng.key(seed), step), (1, 3), maxval=2 * np.pi)
        host = tn.rotations(torch.from_numpy(angles).double())
        r = card.double().cpu()
        worst["host"] = max(worst["host"], float((r - host).abs().max()))
        worst["orthonormal"] = max(worst["orthonormal"], float((r @ r.transpose(1, 2) - torch.eye(3)).abs().max()))
        worst["det"] = max(worst["det"], float((torch.linalg.det(r) - 1).abs().max()))
    log(f"  rotate: the card's rotations of steps 0-{ROTATE_STEPS - 1} against the host's fp64 rotations of the same "
        f"angles: max |diff| {worst['host']:.3e}; |R R^T - I| {worst['orthonormal']:.3e}; |det R - 1| "
        f"{worst['det']:.3e} (tol {ROTATE_ATOL:g})")
    if max(worst.values()) > ROTATE_ATOL:
        failures.append(f"rotate: rotations off by {worst}")
    used = []
    real = trainer.rotation
    trainer.rotation = lambda B: used.append((trainer.step, real(B))) or used[-1][1]
    kernels.reset_launch_counts()
    res = _train_run(trainer, ROTATE_STEPS, profile_last=True)
    counts = dict(kernels.launches)
    if [s for s, _ in used] != list(range(ROTATE_STEPS)) or not all(
            torch.equal(R, tn.step_rotations(seed, s, 1, device)) for s, R in used):
        failures.append(f"rotate: the updates took rotations of steps {[s for s, _ in used]}")
    repeat_run("rotate", trainer, lambda: _normal_restore(trainer, snap), res)
    _report_run("rotate", res, smi)
    log(f"  rotate: launches on the path {counts}; first loss {res['loss'][0]!r}, unrotated {unrotated_loss0!r}")
    if res["loss"][0] == unrotated_loss0:
        failures.append("rotate: the first loss equals the unrotated run's")
    failures += _run_failures("rotate", res, NORMAL_PER_STEP["ell"],
                              {k: v // 2 * len(trainer.test_samples) for k, v in NORMAL_PER_STEP["ell"].items()})
    res["rotations"] = worst
    for key in ("grads0", "params", "drawn", "sampler_after_save"):
        res.pop(key, None)
    del trainer, snap
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return counts, res


def tiers_phase(device, smi: str) -> tuple[dict, dict]:
    """``--buckets 3`` on meshes of TIER_POINTS vertices (written as .obj
    files: two of each to train, one of each to test): the three tiers;
    counts at 0, 8 updates drawn tier by tier and the test pass, 32
    ``ell_matmul`` a step whatever the tier, launches by tier shape; the
    repeat bit for bit; then per tier 3 updates on its meshes alone, the
    last profiled: one row per tier.  Returns the launch counts and the
    results."""
    import torch

    from surfacenetworks_tpu_torch.data import datasets
    from surfacenetworks_tpu_torch.geometry import save_obj
    from surfacenetworks_tpu_torch.sparse import kernels

    tmp = tempfile.mkdtemp(prefix="tiers_smoke_")
    failures = []
    try:
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        for part, copies in (("train", 2), ("test", 1)):
            for n in TIER_POINTS:
                for c in range(copies):
                    os.makedirs(os.path.join(tmp, part, f"n{n}"), exist_ok=True)
                    save_obj(os.path.join(tmp, part, f"n{n}", f"mesh_{c}.obj"), *datasets.random_blob_mesh(rng, n))
        args = ["--data-path", os.path.join(tmp, "train"), "--test-path", os.path.join(tmp, "test"), "--buckets", "3",
                "--operator-format", "ell", "--seed", str(SEED), "--layer", str(LAYERS), "--batch-size", "1",
                "--num-updates", str(TIER_STEPS), "--num-epoch", "1", "--device", "cuda"]
        trainer = _normal_trainer(args, "tiers")
        snap = _normal_snapshot(trainer)
        tiers = [b.n_vertices for b in trainer.bucketset.tiers]
        log(f"  tiers: {[(b.n_vertices, b.n_faces) for b in trainer.bucketset.tiers]} over "
            f"{len(trainer.train_samples)} train and {len(trainer.test_samples)} test meshes; {trainer.data_stats()}; "
            f"set-up {time.perf_counter() - t0:.2f} s")
        if tiers != [(n + 7) // 8 * 8 for n in TIER_POINTS]:
            failures.append(f"tiers: tiers {tiers}, expected {TIER_POINTS}")
        kernels.reset_launch_counts()
        res = _train_run(trainer, TIER_STEPS, profile_last=True)
        counts = dict(kernels.launches)
        rows_of = {s["name"]: trainer.bucketset.select([s]).n_vertices for s in trainer.train_samples}
        step_tiers = [rows_of[names[0]] for names in res["drawn"]]
        by_tier = {t: sum(st["ell_matmul"] for st, r in zip(res["per_step"], step_tiers) if r == t) for t in tiers}
        repeat_run("tiers", trainer, lambda: _normal_restore(trainer, snap), res)
        _report_run("tiers", res, smi)
        log(f"  tiers: the steps' tiers {step_tiers}; ell_matmul launches by tier shape {by_tier}; launches on the "
            f"path {counts}")
        failures += _run_failures("tiers", res, NORMAL_PER_STEP["ell"],
                                  {k: v // 2 * len(trainer.test_samples) for k, v in NORMAL_PER_STEP["ell"].items()})
        if len(set(step_tiers)) < 2:
            failures.append(f"tiers: the {TIER_STEPS} steps drew from one tier only")
        res["launches_by_tier"] = by_tier
        res["per_tier"] = {}
        for t in tiers:
            own = [s for s in trainer.train_samples if rows_of[s["name"]] == t]
            cycle = iter(own * 3)
            row = _train_run(trainer, 3, draw=lambda tr, cycle=cycle: (lambda s: ([s], [s["name"]]))(next(cycle)),
                             profile_last=True)
            res["per_tier"][t] = {k: row[k] for k in ("wall_ms_median", "device_ms_median", "busy_ms", "device_ops",
                                                     "idle_share", "peak_mib")}
            r = res["per_tier"][t]
            log(f"  tiers: tier {t} rows: host wall {r['wall_ms_median']:.3f} ms, device (CUDA events) "
                f"{r['device_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms in {r['device_ops']} device ops, idle "
                f"share {r['idle_share']:.3f}, peak {r['peak_mib']:.1f} MiB ({smi})")
        for key in ("grads0", "params", "drawn", "sampler_after_save"):
            res.pop(key, None)
        del trainer, snap
        torch.cuda.empty_cache()
        if failures:
            raise AssertionError("; ".join(failures))
        return counts, res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _arap_trainer(sequences, extra: list, label: str):
    from surfacenetworks_tpu_torch.cli import train_arap

    return train_arap.ArapTrainer(train_arap.parser.parse_args(ARAP_ARGS + extra), sequences,
                                  log=lambda m: log(f"  [arap {label}] {m}"))


def _first_picks(trainer) -> list:
    """The picks of the trainer's next train batch, its random state left
    as it was."""
    saved = copy.deepcopy(trainer.rng)
    picks = trainer.sample_train_picks()
    trainer.rng = saved
    return picks


def _arap_snapshot(trainer) -> dict:
    return {"params": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            "opt": copy.deepcopy(trainer.opt.state_dict()), "rng": copy.deepcopy(trainer.rng),
            "test_counter": trainer.test_counter, "step": trainer.step}


def _arap_restore(trainer, snap: dict) -> None:
    trainer.model.load_state_dict(snap["params"])
    trainer.opt.load_state_dict(snap["opt"])
    trainer.rng = copy.deepcopy(snap["rng"])
    trainer.test_counter, trainer.step = snap["test_counter"], snap["step"]


def arap_kernel_checks(trainer, device) -> dict:
    """``batched_ell_checks`` on the first ARAP batch's stacked operator (32
    items, K=16, C=128) and its Laplacians."""
    from surfacenetworks_tpu_torch.data.batching import IN_FRAMES

    picks = _first_picks(trainer)
    csrs = [trainer.sequences[si][off + IN_FRAMES - 1]["L"] for si, off in picks]
    return batched_ell_checks(trainer.batch(picks).operator, csrs, device, "the ARAP batch", WIDTH, SEED + 300)


def batched_ell_checks(op, csrs: list, device, label: str, width: int, seed: int) -> dict:
    """``ell_matmul`` on a batch's stacked operator ``op`` (B items) at
    ``width`` channels, forward and stored-transpose backward, each element
    within KERNEL_RTOL of its |A||x| against the plain version in fp32 and
    fp64; the autograd Function's backward against autograd through the
    fp64 plain forward; a mutant whose every item applies item 0's operator
    must fail.  Then its warm and cold-L2 time, the plain version's, one
    ``torch.sparse.mm`` over the block-diagonal CSR of the items' scipy
    operators ``csrs``, and the bound.  Then the same for the bf16 variant
    (bf16 x): held, the item-0 mutant refused, timed (``"bf16"``).  Returns
    the timings."""
    import scipy.sparse as sp
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels, ops

    fwd, bwd = op.fwd, op.bwd
    B, R, K = fwd.cols.shape
    plain = kernels.ell_matmul_plain
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, R, width, device=device, generator=gen)
    g = torch.randn(B, R, width, device=device, generator=gen)
    err = 0.0
    for name, m, t in (("forward", fwd, x), ("stored-transpose backward", bwd, g)):
        got = kernels.ell_matmul(m.cols, m.vals, t)
        scale = plain(m.cols, m.vals.double().abs(), t.double().abs())
        err = max(err, check(f"ell_matmul B={B} R={R} K={K} C={width} {name} vs fp32 plain", got,
                             plain(m.cols, m.vals, t), scale, KERNEL_RTOL))
        check(f"ell_matmul B={B} {name} vs fp64 plain", got, plain(m.cols, m.vals.double(), t.double()), scale,
              KERNEL_RTOL)
    xr = x.clone().requires_grad_()
    ops.spmm(op, xr).backward(g)
    xp = x.double().requires_grad_()
    plain(fwd.cols, fwd.vals.double(), xp).backward(g.double())
    check(f"spmm B={B} backward x_bar vs autograd through the fp64 plain forward (|A^T||g|)", xr.grad, xp.grad,
          plain(bwd.cols, bwd.vals.double().abs(), g.double().abs()), KERNEL_RTOL)
    item0 = [t[:1].expand_as(t).contiguous() for t in (fwd.cols, fwd.vals)]
    refused("ell_matmul with item 0's operator in every batch item", kernels.ell_matmul(*item0, x),
            plain(fwd.cols, fwd.vals, x), plain(fwd.cols, fwd.vals.double().abs(), x.double().abs()), KERNEL_RTOL)

    flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)
    out = torch.empty(B, R, width, device=device)
    nnz = int((fwd.vals != 0).sum())
    padded = []
    for L in csrs:
        L = L.tocsr().astype(np.float32)
        L.resize((R, R))
        padded.append(L)
    bd = sp.block_diag(padded, format="csr")
    lib = torch.sparse_csr_tensor(torch.from_numpy(bd.indptr.astype(np.int64)),
                                  torch.from_numpy(bd.indices.astype(np.int64)), torch.from_numpy(bd.data),
                                  size=bd.shape).to(device)
    x2 = x.reshape(B * R, width)
    b_ms, b_by = bound_ms(nbytes(fwd.cols, fwd.vals, x, out), 2 * nnz * width)
    rep = {"ms": time_ms(lambda: kernels.ell_matmul(fwd.cols, fwd.vals, x)),
           "cold_ms": cold_ms(lambda: kernels.ell_matmul(fwd.cols, fwd.vals, x), flush),
           "bwd_ms": time_ms(lambda: kernels.ell_matmul(bwd.cols, bwd.vals, g)),
           "plain_ms": time_ms(lambda: plain(fwd.cols, fwd.vals, x)),
           "library_ms": time_ms(lambda: torch.sparse.mm(lib, x2)),
           "library_call": "torch.sparse.mm(block-diagonal csr, x)",
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes(fwd.cols, fwd.vals, x, out), "flops": 2 * nnz * width,
           "max_abs_err": err, "shape": [B, R, K, width], "live_slots": nnz}
    log(f"  ell_matmul at {label} (B={B}, R={R}, K={K}, C={width}, {nnz} live slots, "
        f"{nnz / (B * R):.2f} per row): {rep['ms']:.5f} ms warm, {rep['cold_ms']:.5f} ms cold L2, backward's "
        f"{rep['bwd_ms']:.5f} ms warm (plain {rep['plain_ms']:.4f}, {rep['library_call']} {rep['library_ms']:.4f}, "
        f"bound {b_ms:.5f} ms by {b_by}: {rep['bytes'] / 1e6:.1f} MB, {b_ms / rep['ms']:.1%} of it)")

    # the bf16 variant at the same batch (--bf16: bf16 x, fp32 values and sums)
    xh = x.to(torch.bfloat16)
    scale = plain(fwd.cols, fwd.vals.double().abs(), xh.double().abs())
    err16 = check(f"ell_matmul bf16 x B={B} R={R} K={K} C={width} vs plain", kernels.ell_matmul(fwd.cols, fwd.vals, xh),
                  plain(fwd.cols, fwd.vals, xh), scale, KERNEL_RTOL)
    refused("ell_matmul bf16 x with item 0's operator in every batch item", kernels.ell_matmul(*item0, xh),
            plain(fwd.cols, fwd.vals, xh), scale, KERNEL_RTOL)
    b16, b16_by = bound_ms(nbytes(fwd.cols, fwd.vals, xh, out), 2 * nnz * width)
    rep["bf16"] = {"ms": time_ms(lambda: kernels.ell_matmul(fwd.cols, fwd.vals, xh)),
                   "cold_ms": cold_ms(lambda: kernels.ell_matmul(fwd.cols, fwd.vals, xh), flush),
                   "plain_ms": time_ms(lambda: plain(fwd.cols, fwd.vals, xh)), "library_ms": None,
                   "bound_ms": b16, "bound_by": b16_by, "bytes": nbytes(fwd.cols, fwd.vals, xh, out),
                   "max_abs_err": err16}
    del flush
    r16 = rep["bf16"]
    log(f"  ell_matmul bf16 x at {label}: {r16['ms']:.5f} ms warm, {r16['cold_ms']:.5f} ms cold L2 (plain "
        f"{r16['plain_ms']:.4f}, bound {b16:.5f} ms by {b16_by}: {r16['bytes'] / 1e6:.1f} MB, {b16 / r16['ms']:.1%} of it)")
    return rep


def arap_step0_check(trainer, state0, res) -> list[str]:
    """Step 0 against the same step in fp64 on dense fp64 operators (no
    kernel), ``fp64_step0_check`` with the ARAP bounds.  Returns the
    failures."""
    import torch

    from surfacenetworks_tpu_torch.data.batching import IN_FRAMES
    from surfacenetworks_tpu_torch.models.arap_models import Model
    from surfacenetworks_tpu_torch.train import losses

    N = res["batch0"].inputs.shape[1]
    dense = torch.cat([_dense_fp64(trainer.sequences[si][off + IN_FRAMES - 1]["L"], N, trainer.device)
                       for si, off in res["drawn0"]])

    def head(out, batch):
        return losses.smooth_l1_sum(out * batch.mask, batch.targets, batch.inputs.shape[0])

    failures = fp64_step0_check("arap ell", res, _model_at(lambda: Model(LAYERS), state0, trainer.device), head, dense,
                                {"chain": ARAP_STEP0_CHAIN_RTOL, "parameter": ARAP_STEP0_PARAM_RTOL},
                                ARAP_STEP0_LOSS_RTOL)
    del dense
    torch.cuda.empty_cache()
    return failures


def _arap_frames64(sequences) -> dict:
    """The float64 vertices of every sequence's first 10 frames (those an
    operator is taken from), from ``arap_wave_frames`` at the sequences'
    arguments; each must be the sequence's frame before its float32 cast."""
    from surfacenetworks_tpu_torch.data import datasets

    out = {}
    for si, ((frames, F), seq) in enumerate(zip(datasets.arap_wave_frames(**ARAP_SEQUENCES), sequences)):
        for t in range(10):
            if not (np.array_equal(frames[t].astype(np.float32), seq[t]["V"]) and np.array_equal(F, seq[t]["F"])):
                raise AssertionError(f"the float64 frame {t} of sequence {si} differs from the sequence's")
            out[(si, t)] = frames[t]
    return out


def rollout_check(trainer, smi: str) -> dict:
    """``--dump-rollout``'s ``.npy`` part (``train_arap.dump_rollout``) on
    the trained ELL trainer: one forward of the first test batch (counts at
    0 just before it: its ``ell_matmul`` launches, ARAP_PER_STEP's forward
    half); the targets written must equal the test pick's bit for bit, the
    prediction lie within SERVE_FRO_RTOL (relative Frobenius) of the same
    forward with the kernels' plain versions.  With matplotlib the GIF is
    drawn; without it (as here, usually) the CLI must refuse the flag at its
    start, naming matplotlib."""
    import importlib.util

    import torch

    from surfacenetworks_tpu_torch.cli import train_arap

    with tempfile.TemporaryDirectory() as tmp:
        port_kernels.reset_launch_counts()
        pred, gt, faces = train_arap.dump_rollout(trainer, tmp)
        launched = dict(port_kernels.launches)
        files = sorted(os.listdir(tmp))
        trainer.test_counter = 0
        batch = trainer.batch(trainer.sample_test_picks())
        n = gt.shape[1]
        with swapped(port_kernels, "ell_matmul", lambda cols, vals, x, window=0: port_kernels.ell_matmul_plain(
                cols, vals, x)), torch.no_grad():
            plain = (trainer.model(batch.operator, batch.mask, batch.inputs) * batch.mask)[0, :n].cpu()
        frames = range(gt.shape[0])
        plain = torch.stack([plain[:, 3 * i:3 * (i + 1)] for i in frames])
        targets = batch.targets[0, :n].cpu()
        gt_ref = torch.stack([targets[:, 3 * i:3 * (i + 1)] for i in frames]).numpy()
        err = _rel_fro(torch.from_numpy(pred), plain.double())
        have = importlib.util.find_spec("matplotlib") is not None
        if have:
            from surfacenetworks_tpu_torch import viz

            gif = viz.animate_sequence(list(gt), faces, os.path.join(tmp, "rollout.gif"), pred_frames=list(pred))
            drawn = f"GIF drawn ({os.path.getsize(gif)} bytes)"
        else:
            try:
                train_arap.main(["--dump-rollout", tmp, "--data-path", os.path.join(tmp, "absent")])
                drawn = "NOT REFUSED"
            except SystemExit as e:
                drawn = f"the CLI refuses --dump-rollout at its start: {e}"
    want = {k: v // 2 for k, v in ARAP_PER_STEP["ell"].items()}  # one forward
    log(f"  arap rollout: {files}, pred {pred.shape}; launches {dict((k, v) for k, v in launched.items() if v)}; "
        f"against the plain forward {err:.3e} (relative Frobenius); targets bit-identical: "
        f"{np.array_equal(gt, gt_ref)}; matplotlib {'present' if have else 'absent'}: {drawn} ({smi})")
    if (launched != want or files != ["rollout_gt.npy", "rollout_pred.npy"] or not np.array_equal(gt, gt_ref)
            or not err <= SERVE_FRO_RTOL or drawn == "NOT REFUSED" or not np.isfinite(pred).all()):
        raise AssertionError(f"arap rollout: launches {launched} (expected {want}), files {files}, prediction "
                             f"{err:.3e} from the plain forward, {drawn}")
    return {"launches": launched, "plain_rel_fro": err, "matplotlib": have, "gif": drawn}


def arap_phase(device, smi: str) -> tuple[dict, dict]:
    """The ARAP trainer (``cli/train_arap.py``) at batch 32 on 2,000-vertex
    sequences: ``ell_matmul`` held and timed at the first batch's stacked
    operator; then per configuration (ELL, dense, Dir), counts at 0, its
    updates and the test pass; the ELL step 0 against fp64; every run
    repeated from its start, bit for bit; the Dir model's applies held on
    its first batch's operator.  Returns the launch counts of the three
    paths together, and the results."""
    import torch

    from surfacenetworks_tpu_torch.data import datasets
    from surfacenetworks_tpu_torch.data.batching import IN_FRAMES
    from surfacenetworks_tpu_torch.sparse import kernels

    t0 = time.perf_counter()
    seqs = datasets.synthetic_arap_sequences(**ARAP_SEQUENCES)
    log(f"  arap: {len(seqs)} sequences of {len(seqs[0])} frames, {[s[0]['V'].shape[0] for s in seqs]} vertices, "
        f"{[s[0]['F'].shape[0] for s in seqs]} faces; made in {time.perf_counter() - t0:.2f} s")
    results, path_counts, failures = {}, {}, []
    configs = {"ell": ([], ARAP_STEPS), "dense": (["--dense"], ARAP_STEPS),
               "dir": (["--model", "dir"], ARAP_DIR_STEPS)}
    for cfg, (extra, steps) in configs.items():
        t0 = time.perf_counter()
        trainer = _arap_trainer(seqs, extra, cfg)
        b = trainer.buckets
        log(f"  arap {cfg}: bucket {b.n_vertices} x {b.n_faces}, {len(trainer.all_picks)} picks, "
            f"{trainer.n_train} train sequences; set-up {time.perf_counter() - t0:.2f} s")
        if cfg == "ell":
            kernel_report = arap_kernel_checks(trainer, device)
        if cfg == "dir":
            frames64 = _arap_frames64(seqs)
            picks = _first_picks(trainer)
            applies = dirac_apply_checks(trainer.batch(picks).operator, device,
                                         [(frames64[(si, off + IN_FRAMES - 1)], seqs[si][0]["F"]) for si, off in picks])
        snap = _arap_snapshot(trainer)
        # the main path of this configuration: every count is 0 just before it and read just after
        kernels.reset_launch_counts()
        res = _train_run(trainer, steps, _draw_picks, capture=StepCapture if cfg == "ell" else None,
                         profile_last=True)
        path_counts[cfg] = dict(kernels.launches)
        log(f"  arap {cfg}: launches on the path ({steps} updates + test pass) {path_counts[cfg]}")
        if cfg == "dir":
            res["applies"] = applies
        repeat_run(f"arap {cfg}", trainer, lambda: _arap_restore(trainer, snap), res, _draw_picks)
        if cfg == "ell":
            res["rollout"] = rollout_check(trainer, smi)
        results[cfg] = res

        expected = ARAP_PER_STEP[cfg]
        test_expected = {k: v // 2 for k, v in expected.items()}  # forward only
        log(f"  arap {cfg}: losses {['%.4f' % v for v in res['loss']]}; test loss {res['test']:.4f} ({smi})")
        log(f"  arap {cfg}: device ms per step (CUDA events) {['%.2f' % v for v in res['device_ms']]}, median of "
            f"steps 1-{steps - 2} {res['device_ms_median']:.3f}; host wall per step "
            f"{['%.2f' % v for v in res['wall_ms']]}, median {res['wall_ms_median']:.3f}; profiled step device busy "
            f"{res['busy_ms']:.3f} ms in {res['device_ops']} device ops, idle share {res['idle_share']:.3f}; peak "
            f"device memory {res['peak_mib']:.1f} MiB ({smi})")
        for dev_us, count, key in res["top"]:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        log(f"  arap {cfg}: launches per step {res['per_step'][0]} (expected {expected}); test pass "
            f"{res['test_launches']} (expected {test_expected})")
        if not (np.isfinite(res["loss"]).all() and np.isfinite(res["test"])):
            failures.append(f"arap {cfg}: a loss is not finite")
        if any(step != expected for step in res["per_step"]) or res["test_launches"] != test_expected:
            failures.append(f"arap {cfg}: launches per step {res['per_step']}, test pass {res['test_launches']}")
        if not res["reproduced"]:
            failures.append(f"arap {cfg}: a second run of the {steps} steps from the same state differs")
        if cfg == "ell":
            for k, grad in res["grads0"].items():
                if not (bool(torch.isfinite(grad).all()) and bool((grad != 0).any())):
                    failures.append(f"arap ell: step-0 gradient of {k} is not finite and non-zero")
            failures += arap_step0_check(trainer, snap["params"], res)
            res["kernel"] = kernel_report
        for key in ("capture", "grads0", "batch0", "drawn0", "params", "drawn"):
            res.pop(key, None)
        del trainer
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    counts = {k: sum(c[k] for c in path_counts.values()) for k in path_counts["ell"]}
    return counts, results


def _is_operator(a) -> bool:
    from surfacenetworks_tpu_torch.dist import PartitionedDirac, PartitionedOperator
    from surfacenetworks_tpu_torch.sparse import BsrOperator, DiracOperator, EllOperator

    return isinstance(a, (EllOperator, BsrOperator, DiracOperator, PartitionedOperator, PartitionedDirac))


def mesh_objective(family: str, model, b, noise, kw: float = 0.0):
    """The trainer's loss on batch ``b`` with the step's noise (the keep
    mask, or ``eps``): the classifier's NLL, or the VAE's ELBO at KLD
    weight ``kw``.  Returns (loss, the VAE's KLD or None)."""
    from surfacenetworks_tpu_torch.train import losses

    if family == "mnist":
        logp = model(b.operator, b.mask, b.inputs, deterministic=False, keep=noise)
        return losses.nll_loss(logp, b.targets), None
    out = model(b.inputs, b.aux["flat_inputs"], b.operator, b.aux["flat_operator"], b.mask, eps=noise)
    bce, kld = losses.vae_elbo_terms(out[0], out[1], b.mask, b.inputs, *out[2:])
    return bce + kld * kw, kld


def mesh_head(family: str, cap: ModuleCapture, loss: float, grads: dict, model64, b64, noise64, kw: float) -> dict:
    """The head of a mesh-MNIST step against fp64 at the card's own last
    outputs (the classifier's log-probabilities; the VAE's decoder mean,
    encoder mean and log-variance, with the card's cotangent at the
    decoder's latent input standing in for the decoder): the loss and its
    cotangents of those outputs against the card's, and the decoder's bare
    ``fc_logvar`` gradient; relative errors by key."""
    import torch

    from surfacenetworks_tpu_torch.train import losses

    errs = {}
    if family == "mnist":
        rec = cap.calls["head"][0]
        logp = rec["out"][0].double().requires_grad_()
        loss64 = losses.nll_loss(logp, b64.targets)
        loss64.backward()
        errs["loss on the card's log-probabilities"] = abs(loss - float(loss64)) / abs(float(loss64))
        errs["head cotangent of the log-probabilities"] = _rel_fro(rec["g"][0], logp.grad)
        return errs
    recs = {k: cap.calls[k][0] for k in ("decoder.fc_mu", "encoder.fc_mu", "encoder.fc_logvar")}
    dec, mu, lv = (recs[k]["out"][0].double().requires_grad_() for k in recs)
    fcl = model64.decoder.fc_logvar
    z = noise64 * torch.exp(0.5 * lv) + mu
    recon_mu = dec + b64.aux["flat_inputs"]
    bce, kld = losses.vae_elbo_terms(recon_mu, fcl.expand_as(recon_mu), b64.mask, b64.inputs, z, mu, lv)
    loss64 = bce + kld * kw
    z_bar = cap.calls["decoder.conv_noise"][0]["gin"][0]  # the decoder's cotangent at its tiled latent
    (loss64 + (z * z_bar.double().sum(1)).sum()).backward()
    errs["loss on the card's outputs"] = abs(loss - float(loss64)) / abs(float(loss64))
    for (k, rec), t in zip(recs.items(), (dec, mu, lv)):
        errs[f"head cotangent of {k}"] = _rel_fro(rec["g"][0], t.grad)
    errs["decoder.fc_logvar gradient"] = _rel_fro(grads["decoder.fc_logvar"], fcl.grad)
    return errs


def _mesh_model(family: str, model: str, state0, device, dtype):
    from surfacenetworks_tpu_torch.models import mnist_models, vae

    net = (mnist_models.MODELS[model](layers=MESH_LAYERS) if family == "mnist"
           else vae.MODELS[model](num_layers=MESH_LAYERS))
    net.load_state_dict(state0)
    return net.to(device, dtype)


def _mesh_ops64(family: str, cfg: str, samples: list, trainer) -> dict:
    """Step 0's operators in fp64 on the card, lifted (and for the VAE
    flat): the dense fp64 Laplacians of the samples' ``L`` (``flat_L``), or
    the dense fp64 Dirac pairs of their float32 vertices ``V`` (``flat_V``)
    widened to float64, of which the tables were made."""
    import torch

    from surfacenetworks_tpu_torch.data.batching import dense_dirac_pair

    dev, N, M = trainer.device, trainer.buckets.n_vertices, trainer.buckets.n_faces
    keys = {"lifted": ("V", "L"), "flat": ("flat_V", "flat_L")}
    if family == "mnist":
        keys.pop("flat")
    if cfg == "dirac":
        return {key: dense_dirac_pair([{"V": np.asarray(s[vk], np.float64), "F": s["F"]} for s in samples], N, M,
                                      torch.float64, dev) for key, (vk, _) in keys.items()}
    return {key: torch.cat([_dense_fp64(s[lk], N, dev) for s in samples]) for key, (_, lk) in keys.items()}


def mesh_step0_check(family: str, cfg: str, trainer, state0, res, noise0) -> list[str]:
    """Step 0 against the same step in fp64 on dense fp64 operators (the
    Dirac runs: the dense fp64 pairs) with the step's own noise: the loss
    (and the VAE's KLD), then module by module (``mesh_head``,
    ``replay_modules``);
    the mutant whose operator applies are detached must fail the
    module-wise check.  Returns the failures."""
    import dataclasses

    import torch

    from surfacenetworks_tpu_torch.cli.train_vae import kld_weight

    what, dev, b, model = f"{family} {cfg}", trainer.device, res["batch0"], trainer.args.model
    kw = kld_weight(0)
    ops64 = _mesh_ops64(family, cfg, res["drawn0"], trainer)

    def batch_in(dtype, ops):
        aux = None if b.aux is None else {"flat_inputs": b.aux["flat_inputs"].to(dtype),
                                          "flat_operator": _cast_op(ops["flat"], dtype)}
        return dataclasses.replace(b, inputs=b.inputs.to(dtype), mask=b.mask.to(dtype),
                                   targets=b.targets if family == "mnist" else b.targets.to(dtype),
                                   operator=_cast_op(ops["lifted"], dtype), aux=aux)

    def dense_step(dtype):
        net = _mesh_model(family, model, state0, dev, dtype)
        loss, kld = mesh_objective(family, net, batch_in(dtype, ops64), noise0.to(dtype), kw)
        loss.backward()
        return float(loss.detach()), None if kld is None else float(kld.detach()), {
            k: p.grad.detach() for k, p in net.named_parameters()}

    ref_loss, ref_kld, ref_grads = dense_step(torch.float64)
    loss_rel = abs(res["loss"][0] - ref_loss) / abs(ref_loss)
    whole = [_rel_fro(g, ref_grads[k]) for k, g in res["grads0"].items()]
    p_loss, _, p_grads = dense_step(torch.float32)
    plain = [_rel_fro(g, ref_grads[k]) for k, g in p_grads.items()]
    kld_note = ""
    failures = []
    if ref_kld is not None:
        kld_rel = abs(res["kld0"] - ref_kld) / abs(ref_kld)
        kld_note = f"; KLD {res['kld0']:.8f} vs {ref_kld:.8f} (rel {kld_rel:.3e}, tol {MESH_STEP0_LOSS_RTOL:g})"
        if not kld_rel <= MESH_STEP0_LOSS_RTOL:
            failures.append(f"{what}: step-0 KLD {res['kld0']} vs fp64 {ref_kld}")
    log(f"  {what}: step 0 vs the whole fp64 step: loss {res['loss'][0]:.8f} vs {ref_loss:.8f} (rel {loss_rel:.3e}, "
        f"tol {MESH_STEP0_LOSS_RTOL:g}){kld_note}; gradient rel_fro median {np.median(whole):.3e}, max "
        f"{max(whole):.3e}; the same step in fp32 on the dense operators: loss rel "
        f"{abs(p_loss - ref_loss) / abs(ref_loss):.3e}, gradient rel_fro median {np.median(plain):.3e}, max "
        f"{max(plain):.3e}")
    del ref_grads, p_grads
    if not loss_rel <= MESH_STEP0_LOSS_RTOL:
        failures.append(f"{what}: step-0 loss {res['loss'][0]} vs fp64 {ref_loss}")

    mutant = _mesh_model(family, model, state0, dev, torch.float32)
    mcap = ModuleCapture(mutant, _mesh_capture_paths(family))
    try:
        with (detached_dirac_applies if cfg == "dirac" else detached_applies)():
            mloss, _ = mesh_objective(family, mutant, b, noise0, kw)
            mloss.backward()
    finally:
        mcap.remove()
    # with the Dirac applies detached the face stream reaches no loss: its parameters get no gradient
    mgrads = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach() for k, p in mutant.named_parameters()}
    b64 = batch_in(torch.float64, ops64)
    res["step0"] = {"loss_rel": loss_rel, "whole_grad_fro_median": float(np.median(whole)),
                    "whole_grad_fro_max": max(whole)}
    runs = {}
    for label, (loss, grads, cap) in {"real": (res["loss"][0], res["grads0"], res["capture"]),
                                      "mutant detached applies": (float(mloss.detach()), mgrads, mcap)}.items():
        model64 = _mesh_model(family, model, state0, dev, torch.float64)
        runs[label] = {**mesh_head(family, cap, loss, grads, model64, b64, noise0.double(), kw),
                       **replay_modules(cap, grads, model64, lambda name, k, op: ops64[
                           "flat" if name.startswith("decoder.") else "lifted"], torch.float64)}
    del ops64, b64
    torch.cuda.empty_cache()
    return failures + judge_step0(what, runs, {"chain": MESH_STEP0_CHAIN_RTOL, "parameter": MESH_STEP0_PARAM_RTOL},
                                  res)


def _cast_op(op, dtype):
    """A dense operator, a dense Dirac pair or a list of dense pyramid
    levels in ``dtype``."""
    return type(op)(t.to(dtype) for t in op) if isinstance(op, (tuple, list)) else op.to(dtype)


def _mesh_trainer(family: str, samples: list, model: str, fmt: str, label: str, extra: tuple = ()):
    from surfacenetworks_tpu_torch.cli import train_mnist, train_vae

    mod = train_mnist if family == "mnist" else train_vae
    args = mod.parser.parse_args(MESH_ARGS[family] + ["--model", model, *extra])
    cls = train_mnist.MnistTrainer if family == "mnist" else train_vae.VaeTrainer
    return cls(args, samples, fmt=fmt, log=lambda m: log(f"  [{family} {label}] {m}"))


def _mesh_snapshot(trainer) -> dict:
    """Weights, optimizer state, both samplers, the noise generator and the
    update count: what a repeat of the run starts from."""
    return {"params": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            "opt": copy.deepcopy(trainer.opt.state_dict()), "gen": trainer.gen.get_state(),
            "train_sampler": _sampler_like(trainer.train_sampler, trainer.train_samples),
            "test_sampler": _sampler_like(trainer.test_sampler, trainer.test_samples), "step": trainer.step}


def _mesh_restore(trainer, snap: dict) -> None:
    trainer.model.load_state_dict(snap["params"])
    trainer.opt.load_state_dict(snap["opt"])
    trainer.gen.set_state(snap["gen"])
    trainer.train_sampler = _sampler_like(snap["train_sampler"], trainer.train_samples)
    trainer.test_sampler = _sampler_like(snap["test_sampler"], trainer.test_samples)
    trainer.step = snap["step"]


def _mesh_capture_paths(family: str) -> dict:
    """The modules a mesh-MNIST step 0 is held by (``ModuleCapture``
    paths): the classifier's conv1, blocks and head; every module of the
    VAE's encoder and decoder."""
    blocks = [f"rn{i}" for i in range(MESH_LAYERS)]
    if family == "mnist":
        names = ["conv1"] + blocks + ["head"]
    else:
        names = ([f"encoder.{n}" for n in ["conv1"] + blocks + ["bn_conv2", "fc_mu", "fc_logvar"]]
                 + [f"decoder.{n}" for n in ["conv_inputs", "conv_noise"] + blocks + ["bn_conv2", "fc_mu"]])
    return {n: n for n in names}


def mesh_phase(family: str, device, smi: str, samples: list) -> tuple[dict, dict]:
    """The mesh-MNIST classifier (``family='mnist'``) or VAE (``'vae'``)
    trainer at batch 64 on 216-vertex meshes: per configuration (``auto``,
    which resolves to dense; ELL; the Dirac model), counts at 0, its updates
    (two epochs of 4; Dirac 4 updates) and the test pass; the ELL and Dirac
    step 0 against fp64 module by module with the step's own noise; every
    run repeated from its start, bit for bit; the classifier's ELL batch's
    ``ell_matmul`` held and timed at C=64.  Returns the launch counts of
    the three runs together, and the results."""
    import torch

    from surfacenetworks_tpu_torch.cli.train_vae import kld_weight
    from surfacenetworks_tpu_torch.sparse import kernels

    results, path_counts, failures = {}, {}, []
    configs = {"dense": ("lap", "auto", MESH_STEPS), "ell": ("lap", "ell", MESH_STEPS),
               "dirac": ("dirac", "auto", MESH_DIRAC_STEPS)}
    for cfg, (model, fmt, steps) in configs.items():
        t0 = time.perf_counter()
        trainer = _mesh_trainer(family, samples, model, fmt, cfg)
        b = trainer.buckets
        first_samples = _sampler_like(trainer.train_sampler, trainer.train_samples).next_batch()
        first = trainer.batch(first_samples)
        op = first.operator
        log(f"  {family} {cfg}: bucket {b.n_vertices} x {b.n_faces}, {len(trainer.train_samples)} train and "
            f"{len(trainer.test_samples)} test meshes, {trainer.steps_per_epoch} updates per epoch, operator "
            f"{type(op).__name__} {tuple(op.shape) if torch.is_tensor(op) else ''}; "
            f"{trainer.store.stats() if trainer.store else 'batches stacked on the host'}; "
            f"set-up {time.perf_counter() - t0:.2f} s")
        if family == "mnist" and cfg == "ell":
            kernel_report = batched_ell_checks(first.operator, [s["L"] for s in first_samples], device,
                                               "the mesh-MNIST batch", MNIST_WIDTH, SEED + 400)
        del first, first_samples
        snap = _mesh_snapshot(trainer)
        noise0 = {}

        def update(t, batch, u):
            if family == "mnist":
                out = t.update(batch)
                noise = t.last_keep
            else:
                out = t.update(batch, kld_weight(u // t.steps_per_epoch))
                noise = t.last_eps
            if u == 0 and "noise" not in noise0:
                noise0.update(noise=noise, kld=float(out[2]) if family == "vae" else None)
            return out

        capture = (lambda m: ModuleCapture(m, _mesh_capture_paths(family))) if cfg != "dense" else None
        annotate = (annotated_dirac_applies, DIRAC_RANGE) if cfg == "dirac" else None
        # the main path of this configuration: every count is 0 just before it and read just after
        kernels.reset_launch_counts()
        res = _train_run(trainer, steps, capture=capture, profile_last=True, annotate=annotate, update=update)
        path_counts[cfg] = dict(kernels.launches)
        log(f"  {family} {cfg}: launches on the path ({steps} updates + test pass) {path_counts[cfg]}")
        res["kld0"] = noise0["kld"]
        repeat_run(f"{family} {cfg}", trainer, lambda: _mesh_restore(trainer, snap), res, update=update)
        results[cfg] = res

        expected = MESH_PER_STEP[family][cfg]
        test_expected = {k: v // 2 * trainer.test_steps for k, v in expected.items()}  # forward only
        extra = "acc" if family == "mnist" else "(bce, kld)"
        log(f"  {family} {cfg}: losses {[repr(v) for v in res['loss']]}; {extra} {res['mad']}; test {res['test']} "
            f"({smi})")
        log(f"  {family} {cfg}: device ms per step (CUDA events) {['%.2f' % v for v in res['device_ms']]}, median of "
            f"steps 1-{steps - 2} {res['device_ms_median']:.3f}; host wall per step "
            f"{['%.2f' % v for v in res['wall_ms']]}, median {res['wall_ms_median']:.3f}; profiled step device busy "
            f"{res['busy_ms']:.3f} ms in {res['device_ops']} device ops, idle share {res['idle_share']:.3f}; peak "
            f"device memory {res['peak_mib']:.1f} MiB ({smi})")
        for dev_us, count, key in res["top"]:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        if cfg == "dirac":
            res["apply_share"] = res["range_ms"] / res["busy_ms"]
            log(f"  {family} dirac: the Dirac applies in the profiled step: {res['range_ms']:.4f} ms in "
                f"{res['range_ops']} device ops, {res['apply_share']:.1%} of its busy time ({smi})")
            if not 0 < res["range_ms"] <= res["busy_ms"]:
                failures.append(f"{family} dirac: the applies' device time reads {res['range_ms']} ms")
        log(f"  {family} {cfg}: launches per step {res['per_step'][0]} (expected {expected}); test pass "
            f"{res['test_launches']} (expected {test_expected})")
        if not (np.isfinite(res["loss"]).all() and np.isfinite(res["mad"]).all() and np.isfinite(res["test"]).all()):
            failures.append(f"{family} {cfg}: a loss or metric is not finite")
        if any(step != expected for step in res["per_step"]) or res["test_launches"] != test_expected:
            failures.append(f"{family} {cfg}: launches per step {res['per_step']}, test pass {res['test_launches']}")
        if not res["reproduced"]:
            failures.append(f"{family} {cfg}: a second run of the {steps} steps from the same state differs")
        if capture is not None:
            for k, grad in res["grads0"].items():
                if not (bool(torch.isfinite(grad).all()) and bool((grad != 0).any())):
                    failures.append(f"{family} {cfg}: step-0 gradient of {k} is not finite and non-zero")
            failures += mesh_step0_check(family, cfg, trainer, snap["params"], res, noise0["noise"])
        if family == "mnist" and cfg == "ell":
            res["kernel"] = kernel_report
        for key in ("capture", "grads0", "batch0", "drawn0", "params", "drawn"):
            res.pop(key, None)
        del trainer
        torch.cuda.empty_cache()
    same = results["dense"]["loss"] == results["ell"]["loss"]
    diff = [a - b for a, b in zip(results["dense"]["loss"], results["ell"]["loss"])]
    verdict = "bit-identical" if same else f"differ: {diff}"
    log(f"  {family}: dense and ELL losses over the {MESH_STEPS} steps {verdict}; "
        f"test {results['dense']['test']} and {results['ell']['test']}")
    results["dense_equals_ell"] = same
    if failures:
        raise AssertionError("; ".join(failures))
    counts = {k: sum(c[k] for c in path_counts.values()) for k in path_counts["ell"]}
    return counts, results


class FaustRun:
    """A FAUST trainer behind ``_train_run``'s interface: a batch is one
    update of the epoch plan (pair and rotations), drawn by ``_draw_plan``;
    the test pass's metrics come as a sorted tuple."""

    def __init__(self, trainer, steps: int):
        self.t, self.model = trainer, trainer.model
        pair_idx, rots = trainer.epoch_plan()
        self.plan = [(int(a), int(b), tuple(float(v) for v in r)) for (a, b), r in zip(pair_idx, rots)][:steps]
        self.pos = 0

    def batch(self, drawn):
        return drawn

    def update(self, b):
        return self.t.update(*b)

    def test_pass(self, epoch: int):
        res = self.t.test_pass(epoch)  # None on the light path, which skips it
        return None if res is None else tuple(sorted(res.items()))


def _draw_plan(run: FaustRun) -> tuple:
    drawn = run.plan[run.pos]
    run.pos += 1
    return drawn, drawn


def _plain_of(m):
    """The plain version of an ELL or BSR matrix's apply."""
    from surfacenetworks_tpu_torch.sparse import kernels

    if hasattr(m, "block_vals"):
        return lambda x: kernels.bsr_matmul_plain(m.block_cols, m.block_vals, x)
    return lambda x: kernels.ell_matmul_plain(m.cols, m.vals, x)


def _plain_apply(op):
    """``sparse.ops``'s apply of an ELL or BSR operator with the kernels'
    plain versions in their place: the forward ``op.fwd @ x``, the backward
    the stored transpose on the cotangent, cast to x's dtype; the same
    dtypes and roundings as the autograd Functions, the sums in another
    order."""
    import torch

    class PlainApply(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.dtype = x.dtype
            return _plain_of(op.fwd)(x)

        @staticmethod
        def backward(ctx, g):
            return _plain_of(op.bwd)(g.contiguous()).to(ctx.dtype)

    return PlainApply.apply


def plain_step0_check(label: str, res: dict, ref_model, prefix: str = "", chain_rtol: float = BF16_STEP0_CHAIN_RTOL,
                      param_rtol: float = BF16_STEP0_PARAM_RTOL, key: str = "step0") -> list[str]:
    """The run's step 0 (``res["capture"]``, ``res["grads0"]``) replayed
    module by module (``replay_modules``) against the same modules in the
    card's dtype (``ref_model``, the model at step 0's weights) with the
    kernels' plain versions (``_plain_apply``), on the card's own inputs and
    output cotangents: outputs and cotangents within ``chain_rtol``,
    parameters within ``param_rtol`` (bf16 runs: BF16_STEP0_CHAIN_RTOL and
    BF16_STEP0_PARAM_RTOL); the reference with detached applies must read
    above the chain's bound.  Both sides round at the same places; they
    differ in the applies' fp32 summation order (and in BSR's bf16
    backward, the kernel's rounding of the fp32 cotangent).  Keeps the
    worst rows in ``res[key]``; returns the failures."""
    cap, grads = res["capture"], res["grads0"]
    mutant_model = copy.deepcopy(ref_model)
    errs = replay_modules(cap, grads, ref_model, lambda name, k, op: _plain_apply(op), prefix=prefix, outputs=True)
    mutant = replay_modules(cap, grads, mutant_model, lambda name, k, op: lambda x, f=_plain_apply(op): f(x).detach(),
                            prefix=prefix, outputs=True)
    chain = {k: v for k, v in errs.items() if not k.endswith("gradient")}
    params = {k: v for k, v in errs.items() if k.endswith("gradient")}
    mchain = {k: v for k, v in mutant.items() if not k.endswith("gradient")}
    wc, wp, wm = (max(d.items(), key=lambda kv: kv[1]) for d in (chain, params, mchain))
    res[key] = {"chain_worst": wc, "param_worst": wp, "chain_median": float(np.median(list(chain.values()))),
                "param_median": float(np.median(list(params.values()))), "mutant_chain_worst": wm}
    ok = wc[1] <= chain_rtol and wp[1] <= param_rtol
    log(f"  {label}: step 0 module by module vs the plain versions in the card's dtype: chain ({len(chain)}) worst "
        f"{wc[0]} {wc[1]:.3e} (tol {chain_rtol:.4g}), median {res[key]['chain_median']:.3e}; parameters "
        f"({len(params)}) worst {wp[0]} {wp[1]:.3e} (tol {param_rtol:.4g}), median "
        f"{res[key]['param_median']:.3e}; {'ok' if ok else 'FAIL'}; mutant reference with detached applies: chain "
        f"worst {wm[0]} {wm[1]:.3e} {'refused' if wm[1] > chain_rtol else 'NOT refused'}")
    failures = [] if ok else [f"{label}: step 0 disagrees with the plain versions at {wc}, {wp}"]
    if not wm[1] > chain_rtol:
        failures.append(f"{label}: the detached-apply reference passes the step-0 check")
    return failures


def bf16_run_checks(label: str, res: dict, model, test_batches: int, fp32: dict | None, smi: str) -> list[str]:
    """A bf16 run's report and checks: finite losses; every step's launches
    (BF16_PER_STEP) and the test pass's (BF16_PER_TEST_BATCH per batch);
    the repeat bit for bit; step 0's gradients finite, non-zero and fp32,
    the parameters fp32; wall, busy, idle share and peak memory beside the
    fp32 run of the same path (``fp32``).  Returns the failures."""
    import torch

    expected = BF16_PER_STEP[label]
    test_expected = {k: v * test_batches for k, v in BF16_PER_TEST_BATCH[label].items()}
    log(f"  bf16 {label}: losses {[repr(v) for v in res['loss']]}; test {res['test']!r} ({smi})")
    log(f"  bf16 {label}: host wall per step {['%.2f' % v for v in res['wall_ms']]}, median {res['wall_ms_median']:.3f} "
        f"ms; device ms per step (CUDA events) median {res['device_ms_median']:.3f}; profiled step device busy "
        f"{res['busy_ms']:.3f} ms in {res['device_ops']} device ops, idle share {res['idle_share']:.3f}; peak device "
        f"memory {res['peak_mib']:.1f} MiB ({smi})")
    if fp32 is not None:
        peak = f"{fp32['peak_mib']:.1f} MiB" if "peak_mib" in fp32 else "not measured"
        log(f"  bf16 {label}: the fp32 run of the path: wall {fp32['wall_ms_median']:.3f} ms, busy "
            f"{fp32['busy_ms']:.3f} ms in {fp32['device_ops']} ops, idle share {fp32['idle_share']:.3f}, peak {peak}; "
            f"busy bf16 / fp32 {res['busy_ms'] / fp32['busy_ms']:.3f}")
    for dev_us, count, key in res["top"]:
        log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
    log(f"  bf16 {label}: launches per step {res['per_step'][0]} (expected {expected}); test pass "
        f"{res['test_launches']} (expected {test_expected})")
    failures = []
    if not np.isfinite(res["loss"]).all():
        failures.append(f"bf16 {label}: a loss is not finite")
    if any(step != expected for step in res["per_step"]) or res["test_launches"] != test_expected:
        failures.append(f"bf16 {label}: launches per step {res['per_step']}, test pass {res['test_launches']}")
    if not res["reproduced"]:
        failures.append(f"bf16 {label}: a second run from the same state differs")
    for k, g in res["grads0"].items():
        if not (g.dtype == torch.float32 and bool(torch.isfinite(g).all()) and bool((g != 0).any())):
            failures.append(f"bf16 {label}: step-0 gradient of {k} is not fp32, finite and non-zero ({g.dtype})")
    if any(p_.dtype != torch.float32 for p_ in model.parameters()):
        failures.append(f"bf16 {label}: a parameter is not fp32")
    return failures


def bf16_train_phase(device, smi: str, faust_data: list, mesh_samples: list, fp32: dict) -> tuple[dict, dict]:
    """The five trainers with ``--bf16`` (see BF16_PER_STEP): per run,
    counts at 0, its updates (step 0 captured, the last profiled) and the
    test pass; the run again from its start, bit for bit; step 0 module by
    module against the plain versions in bf16 (the kernel runs); the
    normal run's convergence against its fp32 run.  ``fp32`` holds the fp32
    runs of the same paths.  Returns the launch counts per run and the
    results."""
    import torch

    from surfacenetworks_tpu_torch.cli.train_vae import kld_weight
    from surfacenetworks_tpu_torch.data import datasets
    from surfacenetworks_tpu_torch.sparse import kernels

    results, counts, failures = {}, {}, []

    def run(label, trainer, steps, capture, draw=_draw_samples, update=None):
        res = _train_run(trainer, steps, draw, capture=capture, profile_last=True, update=update)
        counts[label] = dict(kernels.launches)
        log(f"  bf16 {label}: launches on the path ({steps} updates + test pass) {counts[label]}")
        return res

    def done(label, res):
        """Keep the run's numbers, free its captures: a later run's peak memory is its own."""
        for key in ("capture", "grads0", "batch0", "drawn0", "params", "drawn", "sampler_after_save"):
            res.pop(key, None)
        results[label] = res
        torch.cuda.empty_cache()

    # FAUST, both formats: the main path of the three bf16 variants
    for fmt in ("ell", "bsr"):
        label = f"faust {fmt}"
        t0 = time.perf_counter()
        frun, _, restore = faust_run(fmt, faust_data, BF16_STEPS, ("--bf16",))
        ref = copy.deepcopy(frun.model.trunk)
        log(f"  bf16 {label}: set-up {time.perf_counter() - t0:.2f} s; plan {[p[:2] for p in frun.plan]}; blocks "
            f"{frun.t.dev_sample(0)['op'].fwd.block_vals.dtype if fmt == 'bsr' else 'fp32 ELL values'}")
        kernels.reset_launch_counts()  # the main path: every count 0 just before it, read just after
        res = run(label, frun, BF16_STEPS, lambda m: StepCapture(m.trunk), _draw_plan)
        repeat_run(f"bf16 {label}", frun, restore, res, _draw_plan)
        failures += bf16_run_checks(label, res, frun.model, 1, fp32.get(label), smi)
        failures += plain_step0_check(f"bf16 {label}", res, ref, "trunk.")
        del frun, ref, restore
        done(label, res)

    # normal Lap-15 BSR, 8 steps: the convergence check against the fp32 run
    t0 = time.perf_counter()
    trainer = _normal_trainer(NORMAL_ARGS + ["--operator-format", "bsr", "--bf16"], "bsr bf16")
    snap = _normal_snapshot(trainer)
    ref = copy.deepcopy(trainer.model)
    log(f"  bf16 normal bsr: set-up {time.perf_counter() - t0:.2f} s; {trainer.data_stats()}")
    kernels.reset_launch_counts()
    res = run("normal bsr", trainer, BF16_NORMAL_STEPS, StepCapture)
    repeat_run("bf16 normal bsr", trainer, lambda: _normal_restore(trainer, snap), res)
    failures += bf16_run_checks("normal bsr", res, trainer.model, len(trainer.test_samples), fp32.get("normal bsr"), smi)
    failures += plain_step0_check("bf16 normal bsr", res, ref)
    f32 = fp32["normal bsr"]["loss"]
    res["convergence"] = {"bf16_final": res["loss"][-1], "fp32_final": f32[-1], "bf16_first": res["loss"][0],
                          "fp32_first": f32[0]}
    ok = res["loss"][-1] < BF16_CONVERGENCE_FACTOR * f32[-1] + 1e-3
    log(f"  bf16 normal bsr: convergence over {BF16_NORMAL_STEPS} steps from the same weights and data: bf16 loss "
        f"{res['loss'][0]:.6f} -> {res['loss'][-1]:.6f}, fp32 {f32[0]:.6f} -> {f32[-1]:.6f}; bf16 final below "
        f"{BF16_CONVERGENCE_FACTOR:g} x fp32 + 1e-3: {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"bf16 normal bsr: final loss {res['loss'][-1]} not below 3 x fp32's {f32[-1]} + 1e-3")
    del trainer, ref
    done("normal bsr", res)

    # ARAP Model-15 ELL at batch 32
    t0 = time.perf_counter()
    trainer = _arap_trainer(datasets.synthetic_arap_sequences(**ARAP_SEQUENCES), ["--bf16"], "ell bf16")
    snap = _arap_snapshot(trainer)
    ref = copy.deepcopy(trainer.model)
    log(f"  bf16 arap ell: set-up {time.perf_counter() - t0:.2f} s")
    kernels.reset_launch_counts()
    res = run("arap ell", trainer, BF16_STEPS, StepCapture, _draw_picks)
    repeat_run("bf16 arap ell", trainer, lambda: _arap_restore(trainer, snap), res, _draw_picks)
    failures += bf16_run_checks("arap ell", res, trainer.model, 1, fp32.get("arap ell"), smi)
    failures += plain_step0_check("bf16 arap ell", res, ref)
    del trainer, ref
    done("arap ell", res)

    # mesh-MNIST at batch 64: the classifier in ELL and dense, the VAE in ELL, the Dirac classifier
    for label, (family, model, fmt) in {"mnist ell": ("mnist", "lap", "ell"), "mnist dense": ("mnist", "lap", "auto"),
                                        "vae ell": ("vae", "lap", "ell"),
                                        "mnist dirac": ("mnist", "dirac", "auto")}.items():
        t0 = time.perf_counter()
        trainer = _mesh_trainer(family, mesh_samples, model, fmt, f"{label} bf16", ("--bf16",))
        snap = _mesh_snapshot(trainer)
        ref = copy.deepcopy(trainer.model)
        log(f"  bf16 {label}: set-up {time.perf_counter() - t0:.2f} s")

        def update(t, batch, u, family=family):
            return t.update(batch) if family == "mnist" else t.update(batch, kld_weight(u // t.steps_per_epoch))

        # the dense and Dirac paths have no kernel: step 0 is captured for its gradients only
        paths = _mesh_capture_paths(family) if fmt == "ell" else {}
        kernels.reset_launch_counts()
        res = run(label, trainer, BF16_STEPS, lambda m, paths=paths: ModuleCapture(m, paths), update=update)
        repeat_run(f"bf16 {label}", trainer, lambda: _mesh_restore(trainer, snap), res, update=update)
        failures += bf16_run_checks(label, res, trainer.model, trainer.test_steps, fp32.get(label), smi)
        if paths:
            failures += plain_step0_check(f"bf16 {label}", res, ref)
        del trainer, ref
        done(label, res)

    if failures:
        raise AssertionError("; ".join(failures))
    return counts, results


KERNEL_SYMBOLS = {"bsr_matmul": "bsr_spmm_kernel", "ell_matmul": "ell_spmm_kernel", "sddmm": "sddmm_kernel",
                  "bsr_matmul_bf16": "bsr_spmm_bf16_kernel", "ell_matmul_bf16": "ell_spmm_bf16x_kernel",
                  "sddmm_bf16": "sddmm_bf16_kernel"}


def _variant(symbol: str) -> str:
    """A kernel's name and template arguments from its mangled symbol."""
    import re

    for kname, fn in KERNEL_SYMBOLS.items():
        if re.search(rf"\d{fn}I", symbol):  # the length-prefixed name, then its template arguments
            args = re.findall(r"L([bi])(\d+)E", symbol.split(fn, 1)[1])
            return f"{fn}<{', '.join(({'1': 'true', '0': 'false'}[v] if t == 'b' else v) for t, v in args)}>"
    return symbol[:60]


def ptxas_report(text: str) -> dict:
    """Registers and spills of each kernel from ``nvcc -Xptxas -v``; logs
    them and returns ``{variant: {"registers": n, "spill_stores": n,
    "spill_loads": n}}``."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = _variant(m.group(1))
            out.setdefault(cur, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    for name, r in sorted(out.items()):
        log(f"  ptxas: {name}: {r.get('registers')} registers, spill stores {r.get('spill_stores')} bytes, "
            f"spill loads {r.get('spill_loads')} bytes")
    return out


def sass_check(lib_path: str) -> None:
    """``cuobjdump -sass`` of the built library, where the toolkit has it:
    every variant of the fp32 BSR kernel must run TF32 tensor-core products
    (``HMMA`` on ``TF32`` operands), and every variant of the bf16 BSR
    kernel bf16 ones (``HMMA.16816.F32.BF16``), or the run fails."""
    import os
    import re
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if not tool:
        log("  SASS check: no cuobjdump in this toolkit; not checked")
        return
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    found = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = _variant(part.split("\n", 1)[0].strip())
        hmma = [ln.strip() for ln in part.splitlines() if "HMMA" in ln]
        found[name] = (len(hmma), sum("TF32" in ln for ln in hmma), sum("HMMA.16816.F32.BF16" in ln for ln in hmma),
                       hmma[0] if hmma else "")
    for name, (n_hmma, n_tf32, n_bf16, first) in sorted(found.items()):
        log(f"  SASS: {name}: {n_hmma} HMMA, {n_tf32} on TF32 operands, {n_bf16} HMMA.16816.F32.BF16"
            f"{'; e.g. ' + first[:90] if first else ''}")
    bsr = [v for k, v in found.items() if k.startswith("bsr_spmm_kernel")]
    if not bsr or any(v[1] == 0 for v in bsr):
        raise AssertionError("the BSR kernel's SASS holds no TF32 HMMA instruction")
    bsr16 = [v for k, v in found.items() if k.startswith("bsr_spmm_bf16_kernel")]
    if len(bsr16) != 4 or any(v[2] == 0 for v in bsr16):
        raise AssertionError("a variant of the bf16 BSR kernel's SASS holds no HMMA.16816.F32.BF16 instruction")


# ---------------------------------------------------------------------------
# serving from exported artifacts, the host input pipeline, the presets
# ---------------------------------------------------------------------------

# Exported artifacts (serve.export_forward): the serve phase's LapDeepModel-15
# (its seeded weights) on its first ELL request (7,040 rows), with the
# operator baked in, as a runtime argument (answering the second request
# too) and in bf16, and DirDeepModel-15 (seeded weights) on a 7,000-vertex
# synthetic mesh of the normal cell (about 14,000 faces).  An artifact runs
# the eager module's kernels in the same order, so its answers must equal the
# module's bit for bit; the fp32 ones must lie within SERVE_FRO_RTOL of an
# fp64 forward on the dense operator (no kernel).  The bf16 one's distance
# from fp64 is reported, not held: the eager bf16 module itself reads 1.02
# there on the card (bf16 rounding where L x cancels, through 15 batch
# norms), so that bound holds fp32 models only; the Lap artifacts launch
# APPLIES_PER_FORWARD kernels a forward, counted inside them.  HOST_US_CALLS
# eager ell_matmul calls at the serve shape are timed on the host, direct
# and through the custom op.
EXPORT_DIRAC_POINTS = 7000
HOST_US_CALLS = 200
# The host input pipeline: the normal Lap-15 ELL run (NORMAL_ARGS) from its
# device store and with --no-device-store (batches built and pinned on the
# prefetch thread, uploaded without blocking), PIPE_STEPS updates each, the
# losses bit-identical; FAUST Lap-15 --loss sl1 and cel past the device
# budget (train_correspondence.DEVICE_BUDGET_BYTES forced to 1 MiB) on the
# FAUST cell's scans, without --smooth-reg (the host path refuses it, as the
# JAX trainer does): PIPE_FAUST_STEPS updates and the test pass, step 0
# against fp64 module by module, the run repeated bit for bit.  A host-path
# step launches 64 ell_matmul (16 applies per trunk forward, two trunks,
# forward and stored-transpose backward), a test pair 32.
PIPE_STEPS = 8
PIPE_FAUST_STEPS = 4
PIPE_FAUST_ARGS = ["--synthetic", "4", "--synthetic-points", "7000", "--seed", "0", "--layer", str(LAYERS),
                   "--xz-rotate", "--num-updates", str(PIPE_FAUST_STEPS), "--num-epoch", "1", "--device", "cuda",
                   "--deser-option", "no", "--operator-format", "ell"]
PIPE_FAUST_PER_STEP = launches_of(ell_matmul=64)
PIPE_FAUST_PER_TEST_PAIR = launches_of(ell_matmul=32)
# The reference's presets (config.py): train_normal --preset normal-lap and
# normal-dirac at their batch 32 and depth 15 on PRESET_MESHES synthetic
# 7,000-vertex meshes (32 train, 8 test), ELL for Lap (the flag wins over
# 'auto'), the updates and epochs cut by flags to PRESET_STEPS and 1.
PRESET_MESHES = 40
PRESET_STEPS = 4
PRESET_ARGS = ["--synthetic", str(PRESET_MESHES), "--synthetic-points", "7000", "--seed", str(SEED), "--num-updates",
               str(PRESET_STEPS), "--num-epoch", "1", "--device", "cuda", "--operator-format", "ell"]
PRESET_PER_STEP = {"normal-lap": launches_of(ell_matmul=32), "normal-dirac": launches_of()}


def _ell_dense64(op, N: int):
    """An ELL operator's ``fwd`` (one item) as a dense fp64 ``[1, N, N]``
    on its device."""
    import torch

    cols, vals = op.fwd.cols[0].long(), op.fwd.vals[0].double()
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None].expand_as(cols)
    dense = torch.zeros(N, N, dtype=torch.float64, device=cols.device)
    dense.index_put_((rows.reshape(-1), cols.reshape(-1)), vals.reshape(-1), accumulate=True)
    return dense[None]


def _event_ms(fn, calls: int = 10) -> tuple[float, float, float]:
    """Median CUDA-event time and median host wall of ``calls`` synchronised
    ``fn()`` calls, and the device busy time of one more under the profiler
    (its kernels and copies), ms."""
    import torch

    fn()
    with counted_profile() as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    profile_gap(f"{sys._getframe(1).f_code.co_name}, one call", prof, rows)
    ev, wall = [], []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(start.elapsed_time(end))
    return float(np.median(ev)), float(np.median(wall)), busy


def export_phase(device, smi: str, served: dict, requests: list) -> tuple[dict, dict]:
    """Serving from exported artifacts: the host time of one eager kernel
    call direct and through the custom op; the Lap-15 artifacts (baked,
    runtime operator, bf16) and the Dir-15 one exported and loaded; then
    (counts at 0) each artifact answers once, its launches counted; each
    answer against the eager module bit for bit and against fp64; the
    artifacts' and the eager forwards' device ms.  Returns the launch counts
    of the artifacts' run and the results."""
    import torch

    from surfacenetworks_tpu_torch import serve
    from surfacenetworks_tpu_torch.data import Buckets, datasets, dirac_batch
    from surfacenetworks_tpu_torch.data.batching import dense_dirac_pair
    from surfacenetworks_tpu_torch.models import DirDeepModel, LapDeepModel, init_weights
    from surfacenetworks_tpu_torch.sparse import kernels

    failures, res = [], {}
    server, req = served["ell"]
    model = server.model
    N = req.inputs.shape[1]
    # host time of one eager ell_matmul call at the serve shape, direct and through snx::ell_matmul
    cols, vals = req.operator.fwd.cols, req.operator.fwd.vals
    x = torch.randn((1, N, WIDTH), device=device, generator=torch.Generator(device).manual_seed(SEED))
    call = lambda: kernels.ell_matmul(cols, vals, x)  # noqa: E731
    outs, hu = {}, {"direct": [], "op": []}
    for through in (False, True, False, True):
        with kernels.through_ops() if through else contextlib.nullcontext():
            outs[through] = call()
            hu["op" if through else "direct"].append(host_us(call, HOST_US_CALLS))
    res["host_us"] = hu
    log(f"  host us per eager ell_matmul call at [1, {N}, {WIDTH}]: direct {['%.2f' % v for v in hu['direct']]}, "
        f"through snx::ell_matmul {['%.2f' % v for v in hu['op']]} (the eager path calls the launch directly; "
        f"{HOST_US_CALLS} calls each, {smi})")
    if not torch.equal(outs[False], outs[True]):
        failures.append("ell_matmul through the custom op differs from the direct call")

    # the artifacts
    t0 = time.perf_counter()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model16 = LapDeepModel(3, 3, layers=LAYERS, dtype=torch.bfloat16)
    model16.load_state_dict(state)
    model16.to(device).eval()
    dsamples = datasets.synthetic_normal_dataset(1, EXPORT_DIRAC_POINTS, seed=SEED, operator="dirac")
    db = Buckets.for_samples(dsamples)
    dbatch = dirac_batch(dsamples, db)
    dmodel = init_weights(DirDeepModel(3, 3, LAYERS), torch.Generator().manual_seed(SEED)).to(device).eval()
    dop, dmask, dx = dbatch.operator.to(device), dbatch.mask.to(device), dbatch.inputs.to(device)
    cases = {
        "lap": (model, req.operator, req.mask, req.inputs, True),
        "lap runtime": (model, req.operator, req.mask, req.inputs, False),
        "lap bf16": (model16, req.operator, req.mask, req.inputs, True),
        "dir": (dmodel, dop, dmask, dx, True),
    }
    blobs, export_s = {}, {}
    for label, (m, op, mask, inputs, bake) in cases.items():
        t1 = time.perf_counter()
        blobs[label] = serve.export_forward(m, None, op, mask, inputs, bake_operator=bake)
        export_s[label] = time.perf_counter() - t1
    fns = {label: serve.load(b) for label, b in blobs.items()}
    infos = {label: serve.export_info(b) for label, b in blobs.items()}
    log(f"  exported and loaded {len(blobs)} artifacts in {time.perf_counter() - t0:.2f} s (export s "
        f"{ {k: round(v, 2) for k, v in export_s.items()} }); bytes { {k: len(b) for k, b in blobs.items()} }; "
        f"info {infos['lap']} / dir {infos['dir']['in_avals']}")

    def args_of(label, r):
        m, op, mask, inputs, bake = cases[label]
        if bake:
            return (inputs,)
        return (r.inputs, r.mask, *serve.operator_leaves(r.operator)[0])

    # the main path: every count is 0 just before it and read just after
    kernels.reset_launch_counts()
    answers, per = {}, {}
    for label in cases:
        before = dict(kernels.launches)
        answers[label] = fns[label](*args_of(label, req))
        per[label] = {k: kernels.launches[k] - before[k] for k in before if kernels.launches[k] != before[k]}
    before = dict(kernels.launches)
    answers["lap runtime, request 1"] = fns["lap runtime"](*args_of("lap runtime", requests[1]))
    per["lap runtime, request 1"] = {k: kernels.launches[k] - before[k] for k in before
                                     if kernels.launches[k] != before[k]}
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    log(f"  launches inside the artifacts: {per}")
    want = {"lap": {"ell_matmul": APPLIES_PER_FORWARD}, "lap runtime": {"ell_matmul": APPLIES_PER_FORWARD},
            "lap bf16": {"ell_matmul_bf16": APPLIES_PER_FORWARD}, "dir": {},
            "lap runtime, request 1": {"ell_matmul": APPLIES_PER_FORWARD}}
    if per != want:
        failures.append(f"artifact launches {per} != {want}")

    # each answer against the eager module on the same operator, and against fp64
    eager = {"lap": lambda: model(req.operator, req.mask, req.inputs),
             "lap runtime": lambda: model(req.operator, req.mask, req.inputs),
             "lap bf16": lambda: model16(req.operator, req.mask, req.inputs),
             "dir": lambda: dmodel(dop, dmask, dx),
             "lap runtime, request 1": lambda: model(requests[1].operator, requests[1].mask, requests[1].inputs)}
    with torch.no_grad():
        model64 = copy.deepcopy(model).double()
        ref64 = {}
        for label, r in (("lap", req), ("lap runtime, request 1", requests[1])):
            ref64[label] = model64(_ell_dense64(r.operator, N), r.mask.double(), r.inputs.double())[0, : r.n]
        ref64["lap runtime"] = ref64["lap bf16"] = ref64["lap"]
        dpair = dense_dirac_pair([{"V": np.asarray(dsamples[0]["V"], np.float64), "F": dsamples[0]["F"]}],
                                 db.n_vertices, db.n_faces, torch.float64, device)
        n_dir = dsamples[0]["V"].shape[0]
        ref64["dir"] = copy.deepcopy(dmodel).double()(dpair, dmask.double(), dx.double())[0, :n_dir]
        del model64, dpair
    res["artifacts"] = {}
    for label, got in answers.items():
        with torch.no_grad():
            mine = eager[label]()
        n = ref64[label].shape[0]
        ref = ref64[label]
        fro = float((got[0, :n].double() - ref).norm() / ref.norm())
        fro_eager = float((mine[0, :n].double() - ref).norm() / ref.norm())
        same = torch.equal(got, mine)
        ms, wall, busy = _event_ms(lambda: fns[label.split(",")[0]](
            *args_of(label.split(",")[0], requests[1] if "request 1" in label else req)))
        with torch.no_grad():
            ems, ewall, ebusy = _event_ms(eager[label])
        res["artifacts"][label] = {"bytes": len(blobs[label.split(",")[0]]), "bit_equal": same, "rel_fro_fp64": fro,
                                   "eager_rel_fro_fp64": fro_eager, "device_ms": ms, "wall_ms": wall,
                                   "busy_ms": busy, "eager_device_ms": ems, "eager_wall_ms": ewall,
                                   "eager_busy_ms": ebusy, "launches": per[label]}
        log(f"  artifact {label}: {'bit-identical to' if same else 'DIFFERS from'} the eager module; rel_fro vs fp64 "
            f"{fro:.3e} (eager {fro_eager:.3e}, tol {'none: bf16' if label == 'lap bf16' else SERVE_FRO_RTOL}); "
            f"per forward: device busy {busy:.3f} ms (eager {ebusy:.3f}), CUDA-event ms {ms:.3f} (eager {ems:.3f}), "
            f"host wall {wall:.3f} ms (eager {ewall:.3f}); {len(blobs[label.split(',')[0]])} bytes ({smi})")
        if not (same and np.isfinite(fro) and (fro <= SERVE_FRO_RTOL or label == "lap bf16")):
            failures.append(f"artifact {label}: bit-identical {same}, rel_fro vs fp64 {fro}")
    if failures:
        raise AssertionError("; ".join(failures))
    del fns, blobs, model16, dmodel
    torch.cuda.empty_cache()
    return counts, res


def _pipelined(batches, update, steps: int) -> dict:
    """``update(batch)`` over the first ``steps`` of ``batches`` (an
    iterator, which may build them on another thread): each step's outputs,
    host wall from the end of the step before (synchronised) to its own
    (the wait for its batch included), launch counts; the last step under
    the profiler, and the peak device memory."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    res = {"out": [], "wall_ms": [], "per_step": []}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    it = iter(batches)
    t_prev = time.perf_counter()
    for u in range(steps):
        before = dict(kernels.launches)
        ctx = counted_profile() if u == steps - 1 else contextlib.nullcontext()
        with ctx as prof:
            out = update(next(it))
            torch.cuda.synchronize()
        now = time.perf_counter()
        res["wall_ms"].append((now - t_prev) * 1e3)
        t_prev = now
        res["out"].append(tuple(float(v) for v in (out if isinstance(out, tuple) else (out,))))
        res["per_step"].append({k: kernels.launches[k] - before[k] for k in before})
    rows = device_rows(prof)
    profile_gap(f"{sys._getframe(1).f_code.co_name}, step {steps - 1}", prof, rows)
    res["busy_ms"] = sum(r[0] for r in rows) / 1e3
    res["device_ops"] = sum(r[1] for r in rows)
    res["wall_ms_median"] = float(np.median(res["wall_ms"][1:-1]))
    res["idle_share"] = 1 - res["busy_ms"] / res["wall_ms_median"]
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return res


def _faust_host_step0(label: str, trainer, state0, res: dict) -> list[str]:
    """Step 0 of a host-path run against fp64 module by module: the loss
    (``--loss`` over the full logits against the step's own uploaded cost)
    and the cotangents at the card's trunk outputs, and each trunk module
    replayed in fp64 on the dense fp64 operators (``replay_modules``); the
    same step with detached operator applies must be refused."""
    import torch

    from surfacenetworks_tpu_torch.cli import train_correspondence as tc

    item = res["item0"]
    ia, ib = item["ia"], item["ib"]
    dense = [_trunk_op64(trainer, i) for i in (ia, ib)]
    dev = {k: (v.to(trainer.device) if isinstance(v, torch.Tensor) else v) for k, v in item.items()}
    gab64 = dev["GAB"].double()

    def head64(fa, fb):
        return trainer.loss_fn(torch.einsum("bnc,bmc->bnm", fa, fb)[0], gab64)

    model64 = _model(state0, trainer.device, torch.float64).trunk
    mutant = _model(state0, trainer.device, torch.float32)
    cap = StepCapture(mutant.trunk)
    try:
        with detached_applies():
            da = dict(trainer.dev_sample(ia), inputs=dev["xa"])
            db = dict(trainer.dev_sample(ib), inputs=dev["xb"])
            mloss = tc.objective(mutant, da, db, None, None, 0.0, False, None, trainer.loss_fn, dev["GAB"])
            mloss.backward()
    finally:
        cap.remove()
    mgrads = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach() for k, p in mutant.named_parameters()}
    runs = {}
    for run, (loss, grads, capture) in {"real": (res["out"][0][0], res["grads0"], res["capture"]),
                                        "mutant detached applies": (float(mloss.detach()), mgrads, cap)}.items():
        runs[run] = {**output_head(capture, loss, head64),
                     **replay_modules(capture, grads, model64, lambda name, k, op: _block_op(dense[k], name),
                                      torch.float64, "trunk.")}
    res["step0"] = {}
    del dense, model64, mutant
    torch.cuda.empty_cache()
    return judge_step0(label, runs, {"chain": STEP0_CHAIN_RTOL, "parameter": STEP0_PARAM_RTOL}, res)


def host_pipeline_phase(device, smi: str, faust_data: list) -> tuple[dict, dict]:
    """The host input pipeline: the normal Lap-15 ELL run from its device
    store and through the prefetch thread (counts at 0 before the latter),
    losses bit for bit; FAUST sl1 and cel past the device budget (counts at
    0 before each), 4 updates and the test pass, step 0 against fp64, the
    repeat bit for bit.  Returns the launch counts of the host routes and
    the results."""
    import torch

    from surfacenetworks_tpu_torch.cli import train_correspondence as tc
    from surfacenetworks_tpu_torch.sparse import kernels

    failures, results, counts = [], {}, launches_of()
    t0 = time.perf_counter()
    trainers = {label: _normal_trainer(NORMAL_ARGS + ["--operator-format", "ell", *extra], f"pipeline {label}")
                for label, extra in (("store", []), ("host", ["--no-device-store"]))}
    log(f"  normal pipeline: store {trainers['store'].data_stats()}; host {trainers['host'].data_stats()}; set-up "
        f"{time.perf_counter() - t0:.2f} s")
    for label, trainer in trainers.items():
        if label == "host":  # the main path: every count is 0 just before it and read just after
            kernels.reset_launch_counts()
        r = _pipelined(trainer.train_batches(PIPE_STEPS), trainer.update, PIPE_STEPS)
        if label == "host":
            counts = {k: counts[k] + v for k, v in kernels.launches.items()}
        r["params"] = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        results[f"normal {label}"] = r
        log(f"  normal {label}: losses {[repr(o[0]) for o in r['out']]}; host wall per step "
            f"{['%.2f' % v for v in r['wall_ms']]}, median {r['wall_ms_median']:.3f} ms; profiled step busy "
            f"{r['busy_ms']:.3f} ms in {r['device_ops']} device ops, idle share {r['idle_share']:.3f}; peak "
            f"{r['peak_mib']:.1f} MiB; launches per step {r['per_step'][0]} ({smi})")
        if any(step != NORMAL_PER_STEP["ell"] for step in r["per_step"]):
            failures.append(f"normal {label}: launches per step {r['per_step']}")
    a, b = results["normal store"], results["normal host"]
    same = a["out"] == b["out"] and all(torch.equal(v, b["params"][k]) for k, v in a["params"].items())
    log(f"  normal host route vs device store: losses, mads and weights {'bit-identical' if same else 'DIFFER'}")
    if not same:
        failures.append("normal: the host route's losses or weights differ from the device store's")
    for r in (a, b):
        r.pop("params")
    del trainers, a, b
    torch.cuda.empty_cache()

    saved = tc.DEVICE_BUDGET_BYTES
    tc.DEVICE_BUDGET_BYTES = 1 << 20
    try:
        for loss in ("sl1", "cel"):
            t0 = time.perf_counter()
            trainer = tc.CorrespondenceTrainer(tc.parser.parse_args(PIPE_FAUST_ARGS + ["--loss", loss]),
                                               log=lambda m: log(f"  [faust host {loss}] {m}"), data=faust_data)
            if not (trainer.host_path and not trainer.light):
                raise AssertionError(f"faust {loss}: the host path was not taken")
            for i in range(len(trainer.data)):
                trainer.dev_sample(i)
            torch.cuda.synchronize()
            state0 = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
            opt0, rng0 = copy.deepcopy(trainer.opt.state_dict()), copy.deepcopy(trainer.rng.bit_generator.state)
            log(f"  faust host {loss}: bucket {trainer.N}, n_train {trainer.n_train}; set-up "
                f"{time.perf_counter() - t0:.2f} s")
            runs = []
            for rep_ in range(2):
                if rep_:
                    trainer.model.load_state_dict(state0)
                    trainer.opt.load_state_dict(opt0)
                    trainer.rng.bit_generator.state = copy.deepcopy(rng0)
                    trainer.step = 0
                else:  # the main path: every count is 0 just before it and read just after
                    kernels.reset_launch_counts()
                items, seen = trainer.host_items(PIPE_FAUST_STEPS), []

                def update(item, seen=seen):
                    seen.append(item)
                    if len(seen) == 1 and rep_ == 0:
                        cap = StepCapture(trainer.model.trunk)
                        try:
                            out = trainer.update_host(item)
                        finally:
                            cap.remove()
                        r_cap.update(capture=cap, item0=item, grads0={
                            k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()})
                        return out
                    return trainer.update_host(item)

                r_cap: dict = {}
                r = _pipelined(items, update, PIPE_FAUST_STEPS)
                r.update(r_cap)
                r["bytes_per_step"] = [sum(v.numel() * v.element_size() for v in it.values()
                                           if isinstance(v, torch.Tensor)) for it in seen]
                before = dict(kernels.launches)
                r["test"] = trainer.test_pass(0)
                r["test_launches"] = {k: kernels.launches[k] - before[k] for k in before}
                if rep_ == 0:
                    counts = {k: counts[k] + v for k, v in kernels.launches.items()}
                r["params"] = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
                runs.append(r)
            r, again = runs
            same = (r["out"] == again["out"] and r["test"] == again["test"]
                    and all(torch.equal(v, again["params"][k]) for k, v in r["params"].items()))
            test_pairs = (len(trainer.data) - trainer.n_train) ** 2 if trainer.args.complete_test else min(
                20, (len(trainer.data) - trainer.n_train) ** 2)
            test_expected = {k: v * test_pairs for k, v in PIPE_FAUST_PER_TEST_PAIR.items()}
            log(f"  faust host {loss}: losses {[repr(o[0]) for o in r['out']]}, repeat "
                f"{[repr(o[0]) for o in again['out']]} ({'bit-identical' if same else 'DIFFERENT'}); test {r['test']}; "
                f"bytes uploaded per step {r['bytes_per_step']}; host wall per step "
                f"{['%.2f' % v for v in r['wall_ms']]}, median {r['wall_ms_median']:.3f} ms; profiled step busy "
                f"{again['busy_ms']:.3f} ms in {again['device_ops']} device ops, idle share "
                f"{1 - again['busy_ms'] / r['wall_ms_median']:.3f}; peak {r['peak_mib']:.1f} MiB; launches per step "
                f"{r['per_step'][0]}, test pass {r['test_launches']} ({smi})")
            if not all(np.isfinite([o[0] for o in r["out"]])):
                failures.append(f"faust host {loss}: a loss is not finite")
            if any(s != PIPE_FAUST_PER_STEP for s in r["per_step"]) or r["test_launches"] != test_expected:
                failures.append(f"faust host {loss}: launches per step {r['per_step']}, test {r['test_launches']}")
            if not same:
                failures.append(f"faust host {loss}: a second run from the same state differs")
            failures += _faust_host_step0(f"faust host {loss}", trainer, state0, r)
            res = {k: r[k] for k in ("out", "wall_ms", "wall_ms_median", "peak_mib", "bytes_per_step", "test",
                                     "per_step", "test_launches", "step0")}
            res.update(busy_ms=again["busy_ms"], device_ops=again["device_ops"],
                       idle_share=1 - again["busy_ms"] / r["wall_ms_median"], reproduced=same)
            results[f"faust host {loss}"] = res
            del trainer, runs, r, again, state0, opt0
            torch.cuda.empty_cache()
    finally:
        tc.DEVICE_BUDGET_BYTES = saved
    if failures:
        raise AssertionError("; ".join(failures))
    return counts, results


def presets_phase(device, smi: str) -> tuple[dict, dict]:
    """The normal trainer from the reference's presets at their batch 32:
    per preset (counts at 0 before it) PRESET_STEPS updates and the test
    pass; launches per step, finite losses, host wall, busy, idle share and
    peak memory.  Returns the launch counts and the results."""
    import torch

    from surfacenetworks_tpu_torch import config
    from surfacenetworks_tpu_torch.cli import train_normal as tn
    from surfacenetworks_tpu_torch.sparse import kernels

    failures, results, counts = [], {}, launches_of()
    for preset in ("normal-lap", "normal-dirac"):
        t0 = time.perf_counter()
        args = config.parse_with_config(tn.parser, ["--preset", preset] + PRESET_ARGS)
        if (args.batch_size, args.layer, args.num_updates, args.half_lr) != (32, LAYERS, PRESET_STEPS, 20):
            raise AssertionError(f"{preset}: resolved to {vars(args)}")
        trainer = tn.NormalTrainer(args, log=lambda m: log(f"  [{preset}] {m}"))
        log(f"  {preset}: model {type(trainer.model).__name__}, format {trainer.fmt}, batch {args.batch_size}, bucket "
            f"{trainer.buckets.n_vertices}, {len(trainer.train_samples)} train / {len(trainer.test_samples)} test "
            f"meshes; {trainer.data_stats()}; set-up {time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()
        # the main path: every count is 0 just before it and read just after
        kernels.reset_launch_counts()
        r = _train_run(trainer, PRESET_STEPS, profile_last=True)
        counts = {k: counts[k] + v for k, v in kernels.launches.items()}
        log(f"  {preset}: losses {[repr(v) for v in r['loss']]}; test {r['test']}; host wall per step "
            f"{['%.2f' % v for v in r['wall_ms']]}, median {r['wall_ms_median']:.3f} ms; device ms median "
            f"{r['device_ms_median']:.3f}; profiled step busy {r['busy_ms']:.3f} ms in {r['device_ops']} device ops, "
            f"idle share {r['idle_share']:.3f}; peak {r['peak_mib']:.1f} MiB; launches per step {r['per_step'][0]} "
            f"({smi})")
        for dev_us, count, key in r["top"]:
            log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        if not np.isfinite(r["loss"]).all():
            failures.append(f"{preset}: a loss is not finite")
        if any(s != PRESET_PER_STEP[preset] for s in r["per_step"]):
            failures.append(f"{preset}: launches per step {r['per_step']} != {PRESET_PER_STEP[preset]}")
        results[preset] = {k: r[k] for k in ("loss", "wall_ms", "wall_ms_median", "device_ms_median", "busy_ms",
                                            "device_ops", "idle_share", "peak_mib", "per_step", "test")}
        results[preset]["set_up_s"] = time.perf_counter() - t0
        del trainer, r
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return counts, results


# ---------------------------------------------------------------------------
# The offline stage, the native host runtime, the large-mesh remat trunk and
# the --jax-profile trace
# ---------------------------------------------------------------------------

# The native runtime (``surfacenetworks_tpu_torch/native``) against the NumPy
# route on the normal cell's first 7,000-vertex mesh: the same bits, and the
# host ms of each (median of NATIVE_REPS calls on the card machine's CPU).
NATIVE_REPS = 5
NATIVE_ELL_K = 16  # the normal trainer's ELL slot counts
# Preprocessing into the trainers: each ``cli.preprocess`` runs as its own
# process with ``--workers`` every core, on inputs written here from seeds;
# then the trainers read the files with ``--data-path``.  The normal meshes
# are 4 in the train tree and 1 in the test tree (``--test-path``; the
# trainer's own split gives 5 meshes no train mesh): ``preprocess normal``
# writes one flat ``.npz`` directory of the whole ``.obj`` tree, and the test
# mesh's file is moved to a test directory.
PRE_DIGITS = 192
PRE_NORMAL_MESHES = 5
PRE_NORMAL_POINTS = 7000
PRE_ARAP = {"num_seq": 5, "n_frames": 50, "n_points": 2000, "seed": SEED}
PRE_NORMAL_ARGS = ["--seed", "0", "--layer", str(LAYERS), "--batch-size", "1", "--num-epoch", "1",
                   "--device", "cuda"]
PRE_STEPS = {"mnist": 4, "normal lap": 8, "normal dirac": 4, "arap": 4}
PRE_PER_STEP = {"mnist": launches_of(ell_matmul=4 * MESH_LAYERS), "normal lap": launches_of(ell_matmul=32),
                "normal dirac": launches_of(), "arap": launches_of(ell_matmul=32)}
# The large-mesh trunk (``benchmarks/large_mesh.py``'s configuration):
# LapDeepModel-15 at width 128 on ``random_blob_mesh`` at 25,000 and 100,000
# vertices, BSR over RCM-ordered rows, ``remat=True``, one forward and
# backward of the masked magnitude loss; at 100,000 also in bf16 (bf16
# blocks), at 25,000 also without remat.  bsr_matmul launches: 16 forward,
# 16 stored-transpose backward, 16 forward replays under remat.
LARGE_POINTS = (25000, 100000)
LARGE_PER_STEP = {True: 48, False: 32}
# jax-profile: ``train_normal --jax-profile DIR`` on Lap-15 ELL, 2 updates; the
# trace must hold 32 ell_spmm_kernel events a step.
PROFILE_UPDATES = 2
PROFILE_ARGS = ["--synthetic", "5", "--synthetic-points", "7000", "--seed", "0", "--layer", str(LAYERS),
                "--batch-size", "1", "--num-updates", str(PROFILE_UPDATES), "--num-epoch", "1", "--device", "cuda",
                "--operator-format", "ell"]


def _host_ms(fn, reps: int = NATIVE_REPS) -> float:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _same_arrays(a, b) -> bool:
    a, b = (x.numpy() if hasattr(x, "numpy") else np.asarray(x) for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.array_equal(a, b))


def native_phase(smi: str) -> dict:
    """The native runtime: built (``g++``, seconds reported) and loaded;
    on the normal cell's first mesh each entry point against its NumPy
    counterpart, bit for bit, and both timed on the host.  Returns the
    rows."""
    from surfacenetworks_tpu_torch import native
    from surfacenetworks_tpu_torch.data import datasets
    from surfacenetworks_tpu_torch.geometry import mesh_ops
    from surfacenetworks_tpu_torch.sparse import ell

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native runtime is off: SNX_NO_NATIVE is set")
    info = native.build_info
    log(f"  native build: {info['seconds']:.2f} s of g++ -> {info['path']}" if "seconds" in info
        else f"  native library already built: {info['path']}; loaded in {time.perf_counter() - t0:.2f} s")
    V, F = datasets.random_blob_mesh(np.random.default_rng(SEED), PRE_NORMAL_POINTS)
    n = V.shape[0]
    L = mesh_ops.igl_style_laplacian(V, F, hack=1.0).tocsr().astype(np.float32)
    k = NATIVE_ELL_K

    def numpy_pair(M):
        # ell_from_scipy sorts its argument's rows in place: hand it copies
        return (ell.ell_from_scipy(M.copy(), k=k, n_rows=n, n_cols=n),
                ell.ell_from_scipy(M.T.tocsr(), k=k, n_rows=n, n_cols=n))

    def same_ell(arrays, pair) -> bool:
        fc, fv, bc, bv = arrays
        return all(_same_arrays(x, y) for x, y in ((fc, pair[0].cols), (fv, pair[0].vals),
                                                   (bc, pair[1].cols), (bv, pair[1].vals)))

    def dirac_np():
        return mesh_ops.dirac_coeffs(V, F)

    rows = {}
    got, ref = native.dirac_coeffs(V, F), dirac_np()
    rows["dirac_coeffs"] = (all(_same_arrays(getattr(got, f), getattr(ref, f))
                                for f in ("F", "q_fv", "vf_face", "vf_corner", "q_vf", "q_bwd_v", "q_bwd_f"))
                            and (got.n_vertices, got.n_faces) == (ref.n_vertices, ref.n_faces),
                            _host_ms(lambda: native.dirac_coeffs(V, F)), _host_ms(dirac_np))
    op = native.ell_operator_from_csr(L, n, k, k)
    rows["ell_operator_from_csr"] = (same_ell((op.fwd.cols, op.fwd.vals, op.bwd.cols, op.bwd.vals), numpy_pair(L)),
                                     _host_ms(lambda: native.ell_operator_from_csr(L, n, k, k)),
                                     _host_ms(lambda: numpy_pair(L)))
    rows["igl_laplacian_ell_arrays"] = (
        same_ell(native.igl_laplacian_ell_arrays(V, F, n, k, k), numpy_pair(L)),
        _host_ms(lambda: native.igl_laplacian_ell_arrays(V, F, n, k, k)),
        _host_ms(lambda: numpy_pair(mesh_ops.igl_style_laplacian(V, F, hack=1.0).tocsr().astype(np.float32))))
    Lm = mesh_ops.mesh_laplacian(V, F).tocsr().astype(np.float32)
    rows["mesh_laplacian_ell_arrays"] = (
        same_ell(native.mesh_laplacian_ell_arrays(V, F, n, k, k), numpy_pair(Lm)),
        _host_ms(lambda: native.mesh_laplacian_ell_arrays(V, F, n, k, k)),
        _host_ms(lambda: numpy_pair(mesh_ops.mesh_laplacian(V, F).tocsr().astype(np.float32))))
    rows["vertex_normals"] = (_same_arrays(native.vertex_normals(V, F), mesh_ops.vertex_normals(V, F).astype(np.float32)),
                              _host_ms(lambda: native.vertex_normals(V, F)),
                              _host_ms(lambda: mesh_ops.vertex_normals(V, F).astype(np.float32)))
    out = {}
    for name, (same, native_ms, numpy_ms) in rows.items():
        log(f"  native {name} at {n} vertices: {'bit-identical to' if same else 'DIFFERS from'} NumPy; host "
            f"{native_ms:.3f} ms native, {numpy_ms:.3f} ms NumPy ({numpy_ms / native_ms:.1f}x), on the card machine's "
            f"CPU ({smi})")
        out[name] = {"bit_equal": same, "native_ms": native_ms, "numpy_ms": numpy_ms}
    bad = [name for name, r in out.items() if not r["bit_equal"]]
    if bad:
        raise AssertionError(f"native and NumPy differ: {bad}")
    out["build_s"] = info.get("seconds")
    return out


def _fake_digits(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_mnist_data.py``'s digits: a 12x12 block of 220 at a
    random offset in a 28x28 image, random labels."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, 28, 28), np.uint8)
    for i in range(n):
        r0, c0 = rng.integers(4, 10, 2)
        imgs[i, r0 : r0 + 12, c0 : c0 + 12] = 220
    return imgs, rng.integers(0, 10, n).astype(np.uint8)


def _write_inputs(root: str) -> dict:
    """The preprocessing inputs, from seeds: MNIST idx files, the normal
    ``.obj`` trees (train and test) and the ARAP frame directories.  Returns
    their paths and the normal meshes' float64 vertices by stem."""
    import gzip
    import struct

    from surfacenetworks_tpu_torch import geometry as geo
    from surfacenetworks_tpu_torch.data import datasets

    imgs, labels = _fake_digits(PRE_DIGITS, SEED)
    paths = {"images": os.path.join(root, "train-images-idx3-ubyte.gz"),
             "labels": os.path.join(root, "train-labels-idx1-ubyte.gz")}
    with gzip.open(paths["images"], "wb") as fh:
        fh.write(struct.pack(">IIII", 2051, len(imgs), 28, 28) + imgs.tobytes())
    with gzip.open(paths["labels"], "wb") as fh:
        fh.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())
    rng = np.random.default_rng(SEED)
    meshes64 = {}
    for i in range(PRE_NORMAL_MESHES):
        V, F = datasets.random_blob_mesh(rng, PRE_NORMAL_POINTS)
        tree = "normal_test" if i == PRE_NORMAL_MESHES - 1 else "normal_train"
        os.makedirs(os.path.join(root, "objs", tree), exist_ok=True)
        geo.save_obj(os.path.join(root, "objs", tree, f"mesh_{i:02d}.obj"), V, F)
    for tree in ("normal_train", "normal_test"):
        for p in sorted(os.listdir(os.path.join(root, "objs", tree))):
            meshes64[os.path.splitext(p)[0]] = geo.load_obj(os.path.join(root, "objs", tree, p))
    for s, (frames, F) in enumerate(datasets.arap_wave_frames(**PRE_ARAP)):
        d = os.path.join(root, "seqs", f"seq{s:02d}")
        os.makedirs(d)
        for t, V in enumerate(frames):
            geo.save_obj(os.path.join(d, f"frame{t:03d}.obj"), V, F)
    paths["meshes64"] = meshes64
    return paths


def _preprocess(argv: list) -> tuple[float, str]:
    """``python -m surfacenetworks_tpu_torch.cli.preprocess argv --workers
    <cores>`` as its own process (it forks its pool, so never in this one
    once CUDA is up): its wall seconds and what it printed."""
    cmd = [sys.executable, "-m", "surfacenetworks_tpu_torch.cli.preprocess", *argv, "--workers", str(os.cpu_count())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[2:])} failed ({res.returncode}):\n{res.stderr[-3000:]}")
    return wall, res.stdout.strip()


def _pre_report(label: str, res: dict, smi: str) -> None:
    log(f"  preprocessed {label}: losses {[repr(v) for v in res['loss']]}; test {res['test']!r} ({smi})")
    log(f"  preprocessed {label}: host wall per step {['%.2f' % v for v in res['wall_ms']]}, median "
        f"{res['wall_ms_median']:.3f} ms; device ms per step (CUDA events) median {res['device_ms_median']:.3f}; "
        f"profiled step device busy {res['busy_ms']:.3f} ms in {res['device_ops']} device ops, idle share "
        f"{res['idle_share']:.3f}; peak device memory {res['peak_mib']:.1f} MiB ({smi})")


def preprocess_train_phase(device, smi: str) -> tuple[dict, dict]:
    """``preprocess mnist``, ``normal`` (lap and ``--operator dirac``) and
    ``arap`` as their own processes on inputs written from seeds, then the
    trainers on the files (counts at 0 before each run): mesh-MNIST Model-5
    ELL at batch 64, normal Lap-15 ELL and Dir-15, ARAP Model-15 ELL at
    batch 32; per run its launches per step, step 0 against fp64 module by
    module, the repeat bit for bit; the Lap run's losses against a run on
    the ``.obj`` trees through the lazy path, bit for bit.  Returns the
    launch counts of the runs together, and the results."""
    import torch

    from surfacenetworks_tpu_torch.cli import train_arap, train_mnist
    from surfacenetworks_tpu_torch.sparse import kernels

    tmp = tempfile.mkdtemp(prefix="preprocess_smoke_")
    try:
        t0 = time.perf_counter()
        inputs = _write_inputs(tmp)
        log(f"  inputs: {PRE_DIGITS} digits as idx files, {PRE_NORMAL_MESHES} {PRE_NORMAL_POINTS}-vertex meshes as "
            f".obj, {PRE_ARAP['num_seq']} ARAP sequences of {PRE_ARAP['n_frames']} {PRE_ARAP['n_points']}-vertex "
            f".obj frames; written in {time.perf_counter() - t0:.2f} s")
        out = {k: os.path.join(tmp, k) for k in ("mnist.np", "npz_lap", "npz_dirac", "data_plus")}
        walls = {}
        for label, argv in (
                ("mnist", ["mnist", "--images", inputs["images"], "--labels", inputs["labels"], "--out",
                           out["mnist.np"]]),
                *((f"normal {op}", ["normal", "--data-path", os.path.join(tmp, "objs"), "--out",
                                    os.path.join(out[f"npz_{op}"], "normal_train"), "--operator", op])
                  for op in ("lap", "dirac")),
                ("arap", ["arap", "--data-path", os.path.join(tmp, "seqs"), "--out", out["data_plus"]])):
            walls[label], said = _preprocess(argv)
            log(f"  preprocess {label}: {walls[label]:.2f} s wall with {os.cpu_count()} workers: {said}")
        for op in ("lap", "dirac"):  # the .obj test tree's mesh goes to the .npz test tree
            test_dir = os.path.join(out[f"npz_{op}"], "normal_test")
            os.makedirs(test_dir)
            for p in os.listdir(os.path.join(tmp, "objs", "normal_test")):
                stem = os.path.splitext(p)[0] + ".npz"
                os.replace(os.path.join(out[f"npz_{op}"], "normal_train", stem), os.path.join(test_dir, stem))

        runs, path_counts, failures = {}, {}, []
        for label in PRE_STEPS:
            t0 = time.perf_counter()
            tlog = lambda m, label=label: log(f"  [preprocessed {label}] {m}")  # noqa: E731
            if label == "mnist":
                args = train_mnist.parser.parse_args(MESH_ARGS["mnist"] + ["--data-path", out["mnist.np"]])
                trainer = train_mnist.MnistTrainer(args, fmt="ell", log=tlog)
            elif label.startswith("normal"):
                op = label.split()[1]
                trainer = _normal_trainer(PRE_NORMAL_ARGS + [
                    "--model", op, "--operator-format", "ell", "--num-updates", str(PRE_STEPS[label]),
                    "--data-path", os.path.join(out[f"npz_{op}"], "normal_train"),
                    "--test-path", os.path.join(out[f"npz_{op}"], "normal_test"),
                    "--result-dir", os.path.join(tmp, "results", op)], f"preprocessed {op}")
            else:
                args = train_arap.parser.parse_args(ARAP_ARGS + ["--data-path", out["data_plus"], "--num-updates",
                                                                 str(PRE_STEPS[label])])
                trainer = train_arap.ArapTrainer(args, log=tlog)
            log(f"  preprocessed {label}: set-up (reading the files, packing, upload) {time.perf_counter() - t0:.2f} s")
            noise0 = {}
            if label == "mnist":
                snap, restore, draw = _mesh_snapshot(trainer), _mesh_restore, _draw_samples
                capture = lambda m: ModuleCapture(m, _mesh_capture_paths("mnist"))  # noqa: E731

                def update(t, batch, u):
                    out_ = t.update(batch)
                    noise0.setdefault("noise", t.last_keep)
                    return out_
            elif label == "arap":
                snap, restore, draw, capture, update = _arap_snapshot(trainer), _arap_restore, _draw_picks, StepCapture, None
            else:
                snap, restore, draw, capture, update = (_normal_snapshot(trainer), _normal_restore, _draw_samples,
                                                        StepCapture, None)
            # the main path of this run: every count is 0 just before it and read just after
            kernels.reset_launch_counts()
            res = _train_run(trainer, PRE_STEPS[label], draw, capture=capture, profile_last=True, update=update)
            path_counts[label] = dict(kernels.launches)
            log(f"  preprocessed {label}: launches on the path ({PRE_STEPS[label]} updates + test pass) "
                f"{path_counts[label]}")
            repeat_run(f"preprocessed {label}", trainer, lambda: restore(trainer, snap), res, draw, update=update)
            expected = PRE_PER_STEP[label]
            steps_t = trainer.test_steps if label == "mnist" else 1
            failures += _run_failures(f"preprocessed {label}", res, expected,
                                      {k: v // 2 * steps_t for k, v in expected.items()})
            _pre_report(label, res, smi)
            if label == "mnist":
                failures += mesh_step0_check("mnist", "ell", trainer, snap["params"], res, noise0["noise"])
            elif label == "arap":
                failures += arap_step0_check(trainer, snap["params"], res)
            elif label == "normal lap":
                dense = torch.cat([_dense_fp64(s["L"], trainer.buckets.n_vertices, device) for s in res["drawn0"]])
                failures += fp64_step0_check("preprocessed normal lap", res, _normal_model_at(trainer, snap["params"]),
                                             _cosine_head, dense, NORMAL_STEP0_BOUNDS, NORMAL_STEP0_LOSS_RTOL)
                del dense
            else:
                meshes64 = {}
                for s in trainer.train_samples + trainer.test_samples:
                    V64, F64 = inputs["meshes64"][os.path.splitext(os.path.basename(s["name"]))[0]]
                    if not (np.array_equal(V64.astype(np.float32), s["V"]) and np.array_equal(F64, s["F"])):
                        failures.append(f"preprocessed normal dirac: {s['name']} is not its .obj mesh")
                    meshes64[s["name"]] = V64
                failures += dirac_step0_check(trainer, snap["params"], res, meshes64)
            for key in ("capture", "grads0", "batch0", "drawn0", "drawn"):
                res.pop(key, None)
            runs[label] = res
            del trainer
            torch.cuda.empty_cache()

        # the Lap run again on the .obj trees through the lazy path, on the same draws
        lazy = _normal_trainer(PRE_NORMAL_ARGS + [
            "--model", "lap", "--operator-format", "ell", "--num-updates", str(PRE_STEPS["normal lap"]),
            "--data-path", os.path.join(tmp, "objs", "normal_train"),
            "--test-path", os.path.join(tmp, "objs", "normal_test"),
            "--result-dir", os.path.join(tmp, "results", "lazy")], "lazy .obj lap")
        lazy_res = _train_run(lazy, PRE_STEPS["normal lap"])
        pre = runs["normal lap"]
        same = (lazy_res["loss"] == pre["loss"] and lazy_res["mad"] == pre["mad"] and lazy_res["test"] == pre["test"]
                and all(torch.equal(v, pre["params"][k]) for k, v in lazy_res["params"].items()))
        log(f"  normal lap from the .npz tree vs the lazy .obj path: losses {[repr(v) for v in pre['loss']]} vs "
            f"{[repr(v) for v in lazy_res['loss']]}; test {pre['test']!r} vs {lazy_res['test']!r}; "
            f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            failures.append("normal lap: the .npz run differs from the lazy .obj run")
        del lazy
        for res in runs.values():
            res.pop("params", None)
        torch.cuda.empty_cache()
        if failures:
            raise AssertionError("; ".join(failures))
        counts = {k: sum(c[k] for c in path_counts.values()) for k in path_counts["mnist"]}
        return counts, {"preprocess_s": walls, "runs": runs, "npz_equals_obj": same}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _large_mesh(n: int) -> dict:
    """``benchmarks/large_mesh.py``'s host build: ``random_blob_mesh(n)``
    (seed 0), its igl Laplacian, RCM order, the 128-row bucket; the inputs
    are the RCM-ordered vertices, the mask the real rows."""
    from surfacenetworks_tpu_torch import geometry as geo
    from surfacenetworks_tpu_torch.data import datasets, round_up
    from surfacenetworks_tpu_torch.sparse import rcm_permutation

    t0 = time.perf_counter()
    V, F = datasets.random_blob_mesh(np.random.default_rng(0), n)
    L = geo.igl_style_laplacian(V, F, hack=1.0).tocsr()
    perm = rcm_permutation(L)
    L = L[perm][:, perm].tocsr()
    coo = L.tocoo()
    n_bucket = round_up(L.shape[0], 128)
    mask = np.zeros((1, n_bucket, 1), np.float32)
    mask[0, : L.shape[0]] = 1.0
    inputs = np.zeros((1, n_bucket, 3), np.float32)
    inputs[0, : V.shape[0]] = V[perm]
    return {"L": L, "n_bucket": n_bucket, "mask": mask, "inputs": inputs, "nnz": int(L.nnz),
            "bandwidth": int(np.abs(coo.row - coo.col).max()), "host_s": time.perf_counter() - t0}


def large_bsr_checks(op, label: str, seed: int) -> dict:
    """The BSR kernel of a large-mesh operator (fp32 or bf16 blocks) at the
    trunk's width, against its plain version on random x: the forward
    blocks on x as the trunk's activations (bf16 for bf16 blocks) and the
    stored transpose on fp32 cotangents, each with the live-chunk mask the
    path hands it and without; every element within KERNEL_RTOL of |A||x|
    (over the bf16-rounded x for bf16 blocks), fp32 blocks also against the
    fp64 plain version; then one slot of one block-row taken out of the
    kernel's result must be refused.  These launches are not the path's.
    Returns the largest error of each side."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    bf = torch.bfloat16
    plain = kernels.bsr_matmul_plain
    gen = torch.Generator(device=op.fwd.block_cols.device).manual_seed(seed)
    errs = {}
    for side, m, live in (("forward", op.fwd, op.fwd_live), ("backward", op.bwd, op.bwd_live)):
        cols, vals = m.block_cols, m.block_vals
        B, nb, kb = cols.shape
        bf16 = vals.dtype == bf
        x = torch.randn(B, nb * 128, WIDTH, device=cols.device, generator=gen)
        if bf16 and side == "forward":
            x = x.to(bf)
        scale = plain(cols, vals.double().abs(), (x.to(bf) if bf16 else x).double().abs())
        name = f"large {label} bsr_matmul{'_bf16' if bf16 else ''} {side} NB={nb} KB={kb} C={WIDTH}"
        got = kernels.bsr_matmul(cols, vals, x, live)
        errs[side] = check(f"{name} vs {'' if bf16 else 'fp32 '}plain", got, plain(cols, vals, x), scale, KERNEL_RTOL)
        if not bf16:
            errs[side] = max(errs[side], check(f"{name} vs fp64 plain", got, plain(cols, vals.double(), x.double()),
                                               scale, KERNEL_RTOL))
        if live is not None:
            same = torch.equal(got, kernels.bsr_matmul(cols, vals, x))
            log(f"  {name}: with and without the live-chunk mask {'bit-identical' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"{name}: the live-chunk mask changes the result")
        # the check's power at this shape: block-row i without its first live slot
        i = nb // 2
        s_ = int(torch.nonzero(vals[0, i].flatten(-2).ne(0).any(-1))[0])
        j = int(cols[0, i, s_])
        xs = x[0, j * 128 : (j + 1) * 128]
        drop = vals[0, i, s_].to(torch.float32) @ (xs.to(bf) if bf16 else xs).to(torch.float32)
        mutant = got.clone()
        mutant[0, i * 128 : (i + 1) * 128] -= drop
        refused(f"{name} without slot {s_} of block-row {i}", mutant, plain(cols, vals, x), scale, KERNEL_RTOL)
    return errs


def _magnitude_loss(out, mask):
    """``benchmarks/large_mesh.py``'s stand-in loss: the masked mean squared
    output (the trunk's full backward, no N x N head)."""
    return ((out * mask) ** 2).sum() / mask.sum()


def _large_step(model, op, mask, inputs) -> dict:
    """One forward and backward (counts at 0 just before it), CUDA-event
    timed and profiled: loss, gradients, launches, device busy, the step's
    peak device memory."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    kernels.reset_launch_counts()
    with counted_profile() as prof:
        t0 = time.perf_counter()
        start.record()
        loss = _magnitude_loss(model(op, mask, inputs), mask)
        loss.backward()
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counts = dict(kernels.launches)
    rows = device_rows(prof)
    profile_gap(f"large mesh, {op.fwd.block_cols.shape[-2] * 128} rows", prof, rows)
    return {"loss": float(loss), "grads": {k: p.grad.detach().clone() for k, p in model.named_parameters()},
            "launches": counts, "device_ms": start.elapsed_time(end), "wall_ms": wall,
            "busy_ms": sum(r[0] for r in rows) / 1e3, "device_ops": sum(r[1] for r in rows),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "step_peak_mib": (torch.cuda.max_memory_allocated() - resident) / 2**20}


def large_mesh_phase(device, smi: str) -> tuple[dict, dict]:
    """LapDeepModel-15 (width 128, ``remat=True``) on the large meshes, BSR
    after RCM: per mesh and dtype the BSR kernel held at the trunk's width
    (``large_bsr_checks``), a warm-up, then one counted forward and
    backward; at 25,000 the same step without remat must give the same loss
    and gradients bit for bit, the BSR apply of the inputs is held element
    by element against fp64 and the output against an fp64 forward on the
    dense fp64 operator (no kernel).  Returns the launch counts and the
    rows."""
    import torch

    from surfacenetworks_tpu_torch.models import LapDeepModel, init_weights
    from surfacenetworks_tpu_torch.nn import apply_operator
    from surfacenetworks_tpu_torch.sparse import bsr_operator_from_scipy, stack_bsr_operators

    totals, rows, failures = {}, {}, []
    for n in LARGE_POINTS:
        mesh = _large_mesh(n)
        nb = mesh["n_bucket"]
        mask = torch.from_numpy(mesh["mask"]).to(device)
        inputs = torch.from_numpy(mesh["inputs"]).to(device)
        for dtype in ((torch.float32,) if n == LARGE_POINTS[0] else (torch.float32, torch.bfloat16)):
            label = f"{n} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            t0 = time.perf_counter()
            op = stack_bsr_operators([bsr_operator_from_scipy(mesh["L"], block_size=128, n_rows=nb, n_cols=nb,
                                                              dtype=dtype)]).to(device)
            live_blocks = (op.fwd.block_vals != 0).flatten(-2).any(-1).sum(-1).float()
            build_s = time.perf_counter() - t0
            model = init_weights(LapDeepModel(3, 3, layers=LAYERS, remat=True,
                                              dtype=torch.bfloat16 if dtype == torch.bfloat16 else None),
                                 torch.Generator().manual_seed(SEED)).to(device)
            row_checks = large_bsr_checks(op, label, SEED + n)
            _magnitude_loss(model(op, mask, inputs), mask).backward()  # warm-up: first-call library set-up
            step = _large_step(model, op, mask, inputs)
            kname = "bsr_matmul_bf16" if dtype == torch.bfloat16 else "bsr_matmul"
            row = {k: v for k, v in step.items() if k != "grads"}
            row.update(rows=n, bucket=nb, nnz=mesh["nnz"], bandwidth=mesh["bandwidth"], host_s=mesh["host_s"],
                       pack_s=build_s, block_rows=int(op.fwd.block_cols.shape[-2]),
                       blocks_per_block_row=int(op.fwd.block_cols.shape[-1]),
                       live_blocks_per_block_row_mean=float(live_blocks.mean()), kernel_max_abs_err=row_checks)
            if step["launches"][kname] != LARGE_PER_STEP[True] or sum(step["launches"].values()) != LARGE_PER_STEP[True]:
                failures.append(f"large {label}: launches {step['launches']}, expected {LARGE_PER_STEP[True]} {kname}")
            if not (np.isfinite(step["loss"]) and all(bool(torch.isfinite(g).all()) and bool((g != 0).any())
                                                      for g in step["grads"].values())):
                failures.append(f"large {label}: the loss or a gradient is not finite and non-zero")
            for k, v in step["launches"].items():
                totals[k] = totals.get(k, 0) + v
            if n == LARGE_POINTS[0]:
                model.remat = False
                plain = _large_step(model, op, mask, inputs)
                model.remat = True
                row["plain"] = {k: v for k, v in plain.items() if k != "grads"}
                same = plain["loss"] == step["loss"] and all(torch.equal(plain["grads"][k], g)
                                                             for k, g in step["grads"].items())
                row["remat_equals_plain"] = same
                if not same or plain["launches"][kname] != LARGE_PER_STEP[False]:
                    failures.append(f"large {label}: without remat loss {plain['loss']!r} vs {step['loss']!r}, "
                                    f"launches {plain['launches']}")
                for k, v in plain["launches"].items():
                    totals[k] = totals.get(k, 0) + v
                # the kernel at this shape, element by element, and the whole output, against fp64
                L64 = mesh["L"].astype(np.float32).astype(np.float64)
                x64 = mesh["inputs"][0, : n].astype(np.float64)
                with torch.no_grad():
                    lx = apply_operator(op, inputs)[0, :n].double().cpu().numpy()
                row["apply_rel_err"] = check(f"large {label} BSR apply of the inputs", lx, L64 @ x64,
                                             abs(L64) @ abs(x64), PIPELINE_RTOL)
                model64 = copy.deepcopy(model).double()
                model64.remat = False
                dense = _dense_fp64(mesh["L"], nb, device)
                with torch.no_grad():
                    ref = model64(dense, mask.double(), inputs.double())[0, :n].cpu().numpy()
                    got = model(op, mask, inputs)[0, :n].double().cpu().numpy()
                fro = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
                row["output_rel_fro_vs_fp64"] = fro
                log(f"  large {label}: output vs an fp64 forward on the dense fp64 operator: rel_fro {fro:.3e} "
                    f"(tol {SERVE_FRO_RTOL})")
                if not (np.isfinite(got).all() and fro <= SERVE_FRO_RTOL):
                    failures.append(f"large {label}: output rel_fro {fro} vs fp64")
                del model64, dense
            log(f"  large {label}: {n} rows in a {nb}-row bucket, nnz {mesh['nnz']}, RCM bandwidth "
                f"{mesh['bandwidth']}, {row['block_rows']} block-rows of {row['blocks_per_block_row']} blocks "
                f"({row['live_blocks_per_block_row_mean']:.2f} live on average); host build {mesh['host_s']:.2f} s + "
                f"pack and upload {build_s:.2f} s")
            log(f"  large {label} remat: loss {step['loss']!r}; launches {step['launches']}; device {step['device_ms']:.3f} "
                f"ms (CUDA events), busy {step['busy_ms']:.3f} ms in {step['device_ops']} device ops, wall "
                f"{step['wall_ms']:.3f} ms; peak {step['peak_mib']:.1f} MiB ({step['step_peak_mib']:.1f} MiB above the "
                f"resident operator and inputs) ({smi})")
            if "plain" in row:
                p = row["plain"]
                log(f"  large {label} without remat: device {p['device_ms']:.3f} ms, busy {p['busy_ms']:.3f} ms; peak "
                    f"{p['peak_mib']:.1f} MiB ({p['step_peak_mib']:.1f} above resident); loss and gradients "
                    f"{'bit-identical to' if row['remat_equals_plain'] else 'DIFFERENT from'} the remat step ({smi})")
            rows[label] = row
            del model, op, step
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return totals, rows


def jax_profile_phase(device, smi: str) -> tuple[dict, dict]:
    """``train_normal --jax-profile DIR`` through its ``main`` on Lap-15
    ELL, 2 updates (counts at 0 before it): the trace file must exist, hold
    32 ``ell_spmm_kernel`` events a step, and hold each of the port's
    kernels as often as its launch counter rose inside the traced epoch
    (``timing.trace`` wrapped to read the counters at its edges).  Returns
    the launch counts and what the trace held."""
    from surfacenetworks_tpu_torch.cli import train_normal as tn
    from surfacenetworks_tpu_torch.sparse import kernels
    from surfacenetworks_tpu_torch.train import timing

    tmp = tempfile.mkdtemp(prefix="profile_smoke_")
    real_trace, in_trace = timing.trace, {}

    @contextlib.contextmanager
    def counting_trace(log_dir):
        before = dict(kernels.launches)
        with real_trace(log_dir) as box:
            yield box
        in_trace.update({k: kernels.launches[k] - before[k] for k in before})

    try:
        prof_dir = os.path.join(tmp, "trace")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        timing.trace = counting_trace
        try:
            tn.main(PROFILE_ARGS + ["--result-dir", os.path.join(tmp, "run"), "--jax-profile", prof_dir])
        finally:
            timing.trace = real_trace
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        traces = sorted(p for p in os.listdir(prof_dir) if p.endswith(".json")) if os.path.isdir(prof_dir) else []
        if len(traces) != 1:
            raise AssertionError(f"--jax-profile wrote {traces} into {prof_dir}")
        path = os.path.join(prof_dir, traces[0])
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        kernel_events = [e for e in events if e.get("cat") == "kernel"]
        traced = traced_launches((e.get("name", ""), 1) for e in kernel_events)
        ell = [e for e in kernel_events if "ell_spmm_kernel" in e.get("name", "")]
        logged = open(os.path.join(tmp, "run", "log", "debug.log")).read()
        out = {"trace_bytes": os.path.getsize(path), "ell_spmm_kernel_events": len(ell),
               "kernel_events": len(kernel_events), "ell_ms": sum(e.get("dur", 0) for e in ell) / 1e3,
               "wall_s": wall, "launches": counts, "launches_in_trace": dict(in_trace), "traced": traced}
        log(f"  --jax-profile: {traces[0]} ({out['trace_bytes']} bytes): {len(kernel_events)} kernel events, "
            f"{len(ell)} ell_spmm_kernel ({out['ell_ms']:.3f} ms) over {PROFILE_UPDATES} updates; the port's kernels "
            f"in the trace {traced}, their launch counters' rise inside the traced epoch {in_trace}; launches on the "
            f"path (updates + test pass) {counts}; main's wall {wall:.2f} s ({smi})")
        if len(ell) != 32 * PROFILE_UPDATES:
            first = sorted(kernel_events, key=lambda e: e.get("ts", 0))[:24]
            raise AssertionError(f"the trace holds {len(ell)} ell_spmm_kernel events, not {32 * PROFILE_UPDATES}; its "
                                 f"first kernels: {[e.get('name', '')[:40] for e in first]}")
        if traced != in_trace:
            raise AssertionError(f"the trace holds the port's kernels {traced}, the traced epoch launched {in_trace}")
        if f"profiler trace written to {prof_dir}" not in logged:
            raise AssertionError("train_normal did not log where the trace went")
        if counts["ell_matmul"] != 32 * PROFILE_UPDATES + 16:
            raise AssertionError(f"--jax-profile run launches {counts}")
        return counts, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the distributed runtime: gloo ranks sharing the one card, and one NCCL rank
# ---------------------------------------------------------------------------

DIST_RANKS = 2  # ranks sharing the card over gloo (NCCL refuses two ranks on one device)
DIST_POINTS = 7000
DIST_BSR_ROWS = 7168  # 2 partitions of 28 128-row blocks
DIST_NORMAL_ARGS = ["--synthetic", "3", "--synthetic-points", str(DIST_POINTS), "--seed", str(SEED), "--layer",
                    str(LAYERS), "--num-epoch", "1", "--device", "cuda", "--debug", "--no-test"]
DIST_GP_STEPS = 4
DIST_DP_STEPS = 2
DIST_ARAP_SEQUENCES = {"num_seq": 3, "n_frames": 50, "n_points": 2000, "seed": SEED}
# Step 0 of a sharded run against the same step on one rank, module by
# module: each module's captured inputs, gathered over the ranks, rerun on one
# rank (fp32, the kernels, the whole unpartitioned operator), its output and
# the cotangents of its inputs against the sharded run's, gathered, and each
# parameter's gradient against the one the ranks summed (``replay_modules``,
# ``judge_step0``; relative Frobenius).  Within one module the inputs are the
# same and only the order of batch norm's sums differs (and, with BSR
# interiors, the order of the interior's sums); where ``L x`` cancels (the
# first block, on raw coordinates) batch norm amplifies that.  The worst
# module is held to DIST_STEP0_BOUNDS, set between the real runs' largest
# readings (chain 0.158, parameters 0.234) and the rank-local batch-norm
# mutant's smallest (0.979, 1.206) on an NVIDIA H100 80GB HBM3 at 700.00 W,
# near their geometric means; the runs are deterministic (every reading
# repeated to the last digit between two calls), and the worst leaves'
# reference gradients are not nearly zero (their shares of the largest are
# logged), so no leaf is put under the null-gradient rule.  The median
# module is held to DIST_STEP0_MEDIAN_RTOL.  The mutant must fail both.
# The parameters after the update must equal, bit for bit on every rank, one
# optimizer step from step 0's weights with the summed gradients.
# The single-card trainer's own step (``loop.update`` without a grid) on the
# whole batch from the same weights: its loss and its update (the parameters
# after it less step 0's) against the sharded step's, relative, held to
# DIST_SINGLE_CARD_RTOL.  For ARAP (real 1e-6 and 0.009) both bounds refuse
# the mutant (0.018 and 1.1).  For the normal model at depth 15 fp32
# rounding alone moves the whole step by far more: the loss by 0.1-1.9% (the
# same step on the CPU: 0.696 with two ranks, 0.653 on one, 0.676 in fp64,
# where the two agree to 5e-11) and Adam's first update, a sign per element,
# by 0.76-1.22 (the mutant 1.32-1.34), so only the loss is held there, at
# 0.1: it catches a wrong normaliser or a lost sum of the loss shares, and
# the module-wise check catches a rank-local batch norm (0.8-4.1% off in the
# loss).
DIST_STEP0_BOUNDS = {"chain": 0.4, "parameter": 0.5}
DIST_STEP0_MEDIAN_RTOL = 1e-4
DIST_SINGLE_CARD_RTOL = {"gp ell": {"loss": 0.1}, "gp bsr": {"loss": 0.1}, "dp normal": {"loss": 0.1},
                         "dp arap": {"loss": 1e-4, "update": 0.1}}
# launches a step per rank: LapDeepModel-15 applies 16 operators forward and
# 16 backward; a partitioned apply is one interior and one boundary launch
DIST_PER_STEP = {"gp ell": launches_of(ell_matmul=64), "gp bsr": launches_of(bsr_matmul=32, ell_matmul=32),
                 "dp normal": launches_of(ell_matmul=32), "dp arap": launches_of(ell_matmul=32)}
# The graph-parallel runs of every other trainer (2 updates each after step
# 0, at DIST_GP_LAYERS layers where the trainer's own depth is 15, printed):
# the Dirac and GAT models launch no kernel (their applies and attends are
# plain PyTorch, as in the JAX package); a partitioned Laplacian apply is one
# interior and one boundary launch, forward and backward: ARAP-7 has 4 Lap
# blocks of 2 applies, the classifier 5, the FAUST lap trunk 4 for each of
# the two shapes, whose streaming dcel head adds one ell_matmul (the mirror
# of its target) a step.
DIST_GP_LAYERS = 7
DIST_GP_STEPS_NEW = 2
DIST_MNIST_DATA = {"num": 80, "seed": SEED, "n_points": 210}  # 64 train meshes: one batch of 64
DIST_FAUST_DATA = {"num": 2, "n_points": DIST_POINTS, "seed": SEED}
DIST_PER_STEP.update({
    "gp normal dirac": launches_of(), "gp normal gat": launches_of(), "gp arap": launches_of(ell_matmul=32),
    "gp mnist": launches_of(ell_matmul=40), "gp vae dirac": launches_of(), "gp faust lap": launches_of(ell_matmul=65),
    "gp faust bsr": launches_of(bsr_matmul=32, ell_matmul=33), "gp faust dir": launches_of(ell_matmul=1)})
# Against the single-card step (loss relative; the update only for ARAP,
# whose fp32 step is not chaotic): the step-0 bounds are those of the first
# graph-parallel runs above; the loss bounds below are theirs for the normal
# and ARAP models and, where the run
# is new, set above the real reading and, for mesh-MNIST and the VAE, below
# the rank-local batch-norm mutant's (measured on NVIDIA H100 80GB
# HBM3 cards at 700.00 W, real / mutant: normal Dirac 1.1e-6 / 0.100, GAT 9.4e-7
# / 0.047, ARAP 2.1e-7 / 0.042 (update 0.013 / 1.16), mesh-MNIST 1.6e-5 /
# 0.011, VAE Dirac 1.2e-5 / 0.0020, FAUST lap 0.021 / 0.22, BSR 0.0024 /
# 0.22, dir 5.4e-6 / 0.26: the dcel head's near-one-hot softmax turns fp32
# rounding into other argmax rows, as in the FAUST phases).  Module by
# module the real runs' worst chain / parameter readings are 4.8e-6-0.140 /
# 1.8e-5-0.302 (FAUST BSR's first block) and the mutants' 0.31-3.95 /
# 0.86-22.2: the bounds of the first graph-parallel runs hold them.
DIST_SINGLE_CARD_RTOL.update({
    "gp normal dirac": {"loss": 0.1}, "gp normal gat": {"loss": 0.1}, "gp arap": {"loss": 1e-4, "update": 0.1},
    "gp mnist": {"loss": 1e-3}, "gp vae dirac": {"loss": 1e-3}, "gp faust lap": {"loss": 0.1},
    "gp faust bsr": {"loss": 0.1}, "gp faust dir": {"loss": 0.1}})
# the partitioned GAT attend against the single-card one: each output and
# gradient within this share of its largest element
DIST_GAT_RTOL = 1e-5


def _dist_log(mesh, msg: str) -> None:
    log(f"  [rank {mesh.rank}] {msg}")


def _dist_operator():
    """The RCM-ordered Laplacian of a synthetic 7,000-vertex mesh."""
    from surfacenetworks_tpu_torch.data import datasets
    from surfacenetworks_tpu_torch.data.batching import rcm_reorder_sample

    return rcm_reorder_sample(datasets.synthetic_normal_dataset(1, n_points=DIST_POINTS, seed=SEED,
                                                                operator="lap")[0])["L"]


def dist_apply_checks(mesh, device) -> dict:
    """``partitioned_spmm`` on this rank's rows (``make_partitioned_spmm``:
    the global operator and x in, this rank's rows out), ELL interior (7,000
    rows, K=16, C=128) and BSR interior (7,168 rows), forward and
    stored-transpose backward, against the single-card ``ell_matmul`` /
    ``bsr_matmul`` on the whole operator, element by element within KERNEL_RTOL of |A||x|; the
    launches of one apply (one interior, one boundary); a dropped boundary
    slot and a zeroed halo refused; the interior and boundary products timed
    at their local shapes on rank 0 (the other rank waiting) with their
    bounds and ``torch.sparse.mm``; the whole apply timed on both ranks."""
    import torch
    import torch.distributed as dist

    from surfacenetworks_tpu_torch import parallel_context
    from surfacenetworks_tpu_torch.dist import edge_partition as ep
    from surfacenetworks_tpu_torch.sparse import bsr_from_scipy, ell_from_scipy, kernels

    rep = {}
    L = _dist_operator()
    n = L.shape[0]
    g = mesh.graph_index
    for interior, n_rows in (("ell", n), ("bsr", DIST_BSR_ROWS)):
        halo = ep.suggest_halo(L)
        op = ep.partition_operator(L, mesh.n_graph, halo=halo, k=16, n_rows=n_rows, interior_fmt=interior)
        loc = ep.shard_partitioned(op, g).to(device)
        gen = torch.Generator().manual_seed(SEED + 900)
        x = torch.randn(n_rows, WIDTH, generator=gen).to(device)
        cot = torch.randn(n_rows, WIDTH, generator=gen).to(device)
        rows = slice(g * n_rows // mesh.n_graph, (g + 1) * n_rows // mesh.n_graph)
        whole = ell_from_scipy(L, k=16, n_rows=n_rows, n_cols=n_rows).to(device)
        whole_t = ell_from_scipy(L.T.tocsr(), k=16, n_rows=n_rows, n_cols=n_rows).to(device)
        if interior == "bsr":
            ref = kernels.bsr_matmul(*(lambda m: (m.block_cols, m.block_vals))(
                bsr_from_scipy(L, 128, n_rows=n_rows, n_cols=n_rows).to(device)), x)
            ref_t = kernels.bsr_matmul(*(lambda m: (m.block_cols, m.block_vals))(
                bsr_from_scipy(L.T.tocsr(), 128, n_rows=n_rows, n_cols=n_rows).to(device)), cot)
        else:
            ref = kernels.ell_matmul(whole.cols, whole.vals, x)
            ref_t = kernels.ell_matmul(whole_t.cols, whole_t.vals, cot)
        scale = kernels.ell_matmul_plain(whole.cols, whole.vals.abs(), x.abs())
        scale_t = kernels.ell_matmul_plain(whole_t.cols, whole_t.vals.abs(), cot.abs())
        xg = x.clone().requires_grad_(True)
        kernels.reset_launch_counts()
        y = ep.make_partitioned_spmm(mesh)(op, xg)  # this rank's rows of L x
        fwd_launches = {k: v for k, v in kernels.launches.items() if v}
        kernels.reset_launch_counts()
        y.backward(cot[rows])
        bwd_launches = {k: v for k, v in kernels.launches.items() if v}
        want = {"ell_matmul": 2} if interior == "ell" else {"bsr_matmul": 1, "ell_matmul": 1}
        if fwd_launches != want or bwd_launches != want:
            raise AssertionError(f"partitioned {interior} apply launched {fwd_launches} forward and {bwd_launches} "
                                 f"backward, not {want}")
        what = f"rank {mesh.rank}: partitioned {interior} interior, rows {rows.start}-{rows.stop} of {n_rows}"
        r = {"rows": n_rows, "halo": halo, "boundary_rows": int(loc.fwd.bnd_rows.shape[0]),
             "max_abs_err": check(f"{what}, forward", y, ref[rows], scale[rows], KERNEL_RTOL),
             "backward_max_abs_err": check(f"{what}, backward", xg.grad[rows], ref_t[rows], scale_t[rows], KERNEL_RTOL),
             "launches_per_apply": want}
        # mutants: one boundary slot dropped, the halo zeroed
        bad = ep.PartitionedOperator(ep.PartitionedEll(**{**vars(loc.fwd), "bnd_vals": loc.fwd.bnd_vals.clone()}),
                                     loc.bwd)
        live = bad.fwd.bnd_vals.nonzero()
        slot = next(tuple(t.tolist()) for t in live if int(bad.fwd.bnd_cols[tuple(t.tolist())]) < halo
                    or int(bad.fwd.bnd_cols[tuple(t.tolist())]) >= halo + n_rows // mesh.n_graph)
        bad.fwd.bnd_vals[slot] = 0.0
        with parallel_context.sharded_axes(vertex_axis=mesh.graph), torch.no_grad():
            refused(f"{what}, one remote boundary slot dropped", ep.partitioned_spmm(bad, x[rows]), ref[rows],
                    scale[rows], KERNEL_RTOL)
            with swapped(ep._Exchange, "wait", lambda self: (torch.zeros_like(self.from_left, device=device),
                                                             torch.zeros_like(self.from_right, device=device))):
                zeroed = ep.partitioned_spmm(loc, x[rows])
            refused(f"{what}, halo zeroed", zeroed, ref[rows], scale[rows], KERNEL_RTOL)
        # the whole apply, both ranks together (the exchange staged through the host over gloo)
        ep.reset_exchange_stats()
        with parallel_context.sharded_axes(vertex_axis=mesh.graph), torch.no_grad():
            xr = x[rows].contiguous()
            for _ in range(3):
                ep.partitioned_spmm(loc, xr)
            torch.cuda.synchronize()
            ep.reset_exchange_stats()
            reps = 20
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                ep.partitioned_spmm(loc, xr)
            end.record()
            end.synchronize()
        st = dict(ep.exchange_stats)
        r.update(apply_wall_ms=(time.perf_counter() - t0) * 1e3 / reps, apply_device_ms=start.elapsed_time(end) / reps,
                 halo_rows_per_apply=st["rows"] / reps, halo_bytes_per_apply=st["bytes"] / reps,
                 exchange_host_ms_per_apply=st["host_s"] * 1e3 / reps)
        _dist_log(mesh, f"partitioned {interior} apply (rows {n_rows}, halo {halo}, {r['boundary_rows']} boundary rows "
                        f"a partition): wall {r['apply_wall_ms']:.3f} ms, CUDA-event {r['apply_device_ms']:.3f} ms "
                        f"per apply; {r['halo_rows_per_apply']:.0f} halo rows ({r['halo_bytes_per_apply']:.0f} bytes) "
                        f"sent per apply, the exchange's host time {r['exchange_host_ms_per_apply']:.3f} ms per apply "
                        f"(gloo on one card, staged through pinned host buffers; not NCCL)")
        if interior == "ell":
            r["overlap"] = _dist_overlap(mesh, loc, xr)
        # the local products alone, timed on rank 0 while the other rank waits
        dist.barrier(group=mesh.graph.group)
        if mesh.rank == 0:
            r["local"] = _dist_local_timing(loc.fwd, interior, xr, device)
        dist.barrier(group=mesh.graph.group)
        rep[interior] = r
    return rep


def _dist_overlap(mesh, loc, x_loc) -> dict:
    """The overlap check on the card (``dist/analysis.py``) of this rank's
    partitioned ELL apply, which must report the interior issued before the
    exchange is waited on (and JAX's dataflow split), and one apply's device
    timeline from a ``torch.profiler`` trace: the interior
    ``ell_spmm_kernel``, then the halo's host-to-device copies, then the
    boundary kernel.  On this gloo axis two ranks share the card and the
    halo goes through the host, so the trace shows the order, not overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from surfacenetworks_tpu_torch import parallel_context
    from surfacenetworks_tpu_torch.dist import analysis
    from surfacenetworks_tpu_torch.dist import edge_partition as ep

    with parallel_context.sharded_axes(vertex_axis=mesh.graph), torch.no_grad():
        structure = analysis.check_overlap_structure(ep.partitioned_spmm, loc, x_loc)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ep.partitioned_spmm(loc, x_loc)
            torch.cuda.synchronize()
    timeline = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        kind = ("ell_spmm_kernel" if KERNEL_SYMBOLS["ell_matmul"] in e.name else
                "H2D copy" if "HtoD" in e.name else "D2H copy" if "DtoH" in e.name else e.name[:40])
        timeline.append((e.time_range.start, kind, e.time_range.elapsed_us()))
    timeline.sort()
    ells = [i for i, (_, k, _) in enumerate(timeline) if k == "ell_spmm_kernel"]
    for i, role in zip(ells, ("interior", "boundary")):  # the first launched is the interior's
        timeline[i] = (timeline[i][0], f"{role} ell_spmm_kernel", timeline[i][2])
    kinds = [k for _, k, _ in timeline]
    h2d = [i for i, k in enumerate(kinds) if k == "H2D copy"]
    ordered = len(ells) == 2 and bool(h2d) and ells[0] < min(h2d) and ells[1] > max(h2d)
    _dist_log(mesh, f"overlap check on the card: {structure}; one apply's device timeline: "
                    + ", ".join(f"{k} {us:.1f} us" for _, k, us in timeline))
    want = {"interior_before_wait": True, "output_depends_on_halo": True}
    if not (ordered and all(structure[k] == v for k, v in want.items()) and structure["interior_indep"] >= 1
            and structure["boundary_dep"] >= 1 and structure["n_ppermute"] >= 1):
        raise AssertionError(f"rank {mesh.rank}: the partitioned apply does not issue its interior before the halo "
                             f"wait: {structure}, device order {kinds}")
    return {**structure, "device_order": kinds}


def _dist_local_timing(m, interior: str, x_loc, device) -> dict:
    """The interior and the boundary product of one partition at their local
    shapes: warm ms, plain ms, bound (``ell_live_bytes``: the rows of x that
    a live slot reads, not the whole frame) and ``torch.sparse.mm`` on a CSR
    copy of the same table."""
    import torch

    from surfacenetworks_tpu_torch.sparse import kernels

    def csr_of(cols, vals, n_cols):
        live = vals != 0
        rows = torch.arange(cols.shape[0], device=device)[:, None].expand_as(cols)[live]
        return torch.sparse_coo_tensor(torch.stack([rows, cols[live].long()]), vals[live],
                                       (cols.shape[0], n_cols)).coalesce().to_sparse_csr()

    out = {}
    x_ext = torch.cat([torch.zeros(m.halo, x_loc.shape[1], device=device), x_loc,
                       torch.zeros(m.halo, x_loc.shape[1], device=device)])
    tables = [("boundary", m.bnd_cols, m.bnd_vals, x_ext)]
    if interior == "ell":
        tables.insert(0, ("interior", m.cols, m.vals, x_loc))
    for label, cols, vals, xx in tables:
        nnz = int((vals != 0).sum())
        res = torch.empty(cols.shape[0], xx.shape[1], device=device)
        n_bytes = ell_live_bytes(cols, vals, xx, res)
        b_ms, b_by = bound_ms(n_bytes, 2 * nnz * xx.shape[1])
        lib = csr_of(cols, vals, xx.shape[0])
        out[label] = {"shape": [cols.shape[0], cols.shape[1], xx.shape[1]], "live_slots": nnz,
                      "ms": time_ms(lambda: kernels.ell_matmul(cols, vals, xx)),
                      "plain_ms": time_ms(lambda: kernels.ell_matmul_plain(cols, vals, xx)),
                      "library_ms": time_ms(lambda: torch.sparse.mm(lib, xx)), "library_call": "torch.sparse.mm(csr, x)",
                      "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                      "x_rows_read": int(cols[vals != 0].unique().numel()), "flops": 2 * nnz * xx.shape[1]}
        r = out[label]
        log(f"  ell_matmul, partition {label} table (R={r['shape'][0]}, K={r['shape'][1]}, C={r['shape'][2]}, "
            f"{nnz} live slots reading {r['x_rows_read']} of {xx.shape[0]} rows of x): {r['ms']:.5f} ms warm (plain {r['plain_ms']:.4f}, {r['library_call']} "
            f"{r['library_ms']:.4f}); bound {b_ms:.5f} ms by {b_by}")
    return out


def _local_batch_norm():
    """The mutant: every batch norm takes its statistics over this rank's
    rows only."""
    from surfacenetworks_tpu_torch import parallel_context
    from surfacenetworks_tpu_torch.nn.layers import GraphBatchNorm

    forward = GraphBatchNorm.forward

    def local(self, x, mask=None):
        with parallel_context.sharded_axes():
            return forward(self, x, mask)

    return swapped(GraphBatchNorm, "forward", local)


def _loss_of(out) -> float:
    return float(out[0] if isinstance(out, tuple) else out)


def _gathered(cap, axis, dim: int):
    """``cap`` (a ``ModuleCapture`` of this rank's shard) with every
    captured array gathered over ``axis`` along ``dim`` (every rank calls it,
    in the same order).  Along the rows (``dim`` -2) only per-row arrays
    (``[B, n, C]``) are sharded: a pooled value (``[B, C]``: a classifier's
    log-probabilities, the VAE's latent statistics, a dropout mask) is the
    same on every rank and kept, and its cotangent, of which each rank holds
    its share of the loss's, is summed over the axis."""
    import torch

    from surfacenetworks_tpu_torch import parallel_context
    from surfacenetworks_tpu_torch.dist import mesh_setup

    def g(t, cot=False):
        if not isinstance(t, torch.Tensor):
            return t
        if dim == -2 and t.dim() < 3:
            return parallel_context.total(t, [axis]) if cot else t
        return mesh_setup.all_gather(t.contiguous(), axis, dim)

    out = copy.copy(cap)
    out.calls = {name: [{"needs": r["needs"], "args": [g(a) for a in r["args"]], "out": [g(o) for o in r["out"]],
                         "g": [g(t, True) for t in r["g"]], "gin": [g(t, True) for t in r["gin"]]} for r in recs]
                 for name, recs in cap.calls.items()}
    return out


def _dist_step0(mesh, label: str, trainer, batch, whole, head, make_opt, vertex: bool, capture=None, single=None,
                head_errs=None, replay=None, null=frozenset()) -> dict:
    """Step 0 on every rank's shard (``trainer.update(batch)``) against the
    same step on one rank, module by module (see DIST_STEP0_BOUNDS): the
    captured modules gathered over the graph axis (rows, ``vertex``) or the
    data axis (batch items), replayed by rank 0 on ``whole`` (the whole
    batch, unpartitioned) with the loss ``head(out, whole)``; the same for
    the rank-local batch-norm mutant, which must fail; the parameters after
    the update bit-identical on every rank and to one step of
    ``make_opt(model)`` (the trainer's optimizer, made afresh) from step 0's
    weights with the summed gradients; the loss and the update against the
    single-card step on ``whole``.  The trainer's weights, optimizer and
    update count are put back after each.  For models that are not called
    ``model(op, mask, inputs)``: ``capture(model)`` makes the
    ``ModuleCapture`` (default ``StepCapture``), ``single(model)`` is the
    single-card step's loss on ``whole``, ``head_errs(cap, loss, grads)``
    holds the step's head (default ``output_head`` with ``head``), and
    ``replay = (submodule of the model, key prefix, operator of (name,
    call))`` what the modules are replayed on (default the model, its keys,
    ``whole.operator``); ``null`` names parameters whose gradient is zero in
    exact arithmetic, held to NULL_GRAD_RTOL of the largest gradient."""
    import torch

    from surfacenetworks_tpu_torch.dist import mesh_setup

    state0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())
    axis, dim = (mesh.graph, -2) if vertex else (mesh.data, 0)

    def restart():
        trainer.model.load_state_dict(state0)
        trainer.opt.load_state_dict(opt0)
        trainer.step = 0

    def captured(ctx):
        restart()
        cap = (capture or StepCapture)(trainer.model)
        try:
            with ctx():
                loss = _loss_of(trainer.update(batch))
        finally:
            cap.remove()
        grads = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}
        return loss, grads, _gathered(cap, axis, dim), torch.cat([p.detach().reshape(-1)
                                                                  for p in trainer.model.parameters()])

    loss, grads, cap, after = captured(contextlib.nullcontext)
    replicas = mesh_setup.all_gather(after[None], mesh.world, 0)
    mutant = captured(_local_batch_norm)
    restart()
    res = {"loss0": loss}
    if mesh.rank == 0:
        if not all(torch.equal(r, after) for r in replicas):
            raise AssertionError(f"{label}: the ranks' parameters differ after the update")
        from surfacenetworks_tpu_torch.train import loop, optim

        def flat(m):
            return torch.cat([p.detach().reshape(-1) for p in m.parameters()])

        # one optimizer step from step 0's weights with the summed gradients, on one rank
        model = copy.deepcopy(trainer.model)
        model.load_state_dict(state0)
        opt = make_opt(model)
        for k, p in model.named_parameters():
            p.grad = grads[k].clone()
        optim.apply_schedule(opt, trainer.schedule)
        opt.step()
        if not torch.equal(flat(model), after):
            raise AssertionError(f"{label}: the update is not one optimizer step with the summed gradients")
        # the single-card trainer's step on the whole batch from the same weights
        model.load_state_dict(state0)
        p0 = flat(model)
        (one,) = loop.update(model, make_opt(model), lambda: ((single or (
            lambda m: head(m(whole.operator, whole.mask, whole.inputs), whole)))(model),), trainer.schedule)
        single = {"loss": float(one), "update": flat(model) - p0}
        model.load_state_dict(state0)
        failures, runs, bounds = [], {}, DIST_SINGLE_CARD_RTOL[label]
        sub, prefix, apply = replay or (lambda m: m, "", lambda name, k, op: whole.operator)
        for lab, (lo, gr, c, af) in (("real", (loss, grads, cap, after)), ("mutant rank-local batch norm", mutant)):
            norms = {}
            runs[lab] = errs = {**(head_errs(c, lo, gr) if head_errs else output_head(c, lo, lambda out: head(out, whole))),
                                **replay_modules(c, gr, sub(model), apply, prefix=prefix, null=null, norms=norms)}
            if lab == "real":
                leaves = sorted((k[:-len(" gradient")] for k in errs if k.endswith(" gradient")),
                                key=lambda k: -errs[k + " gradient"])[:4]
                res["worst_leaf_shares"] = {k: norms[k] for k in leaves}
                log(f"  {label} real: the worst leaves' reference gradients as shares of the largest: "
                    + ", ".join(f"{k} {norms[k]:.3e}" for k in leaves))
            step = {"loss": abs(lo - single["loss"]) / abs(single["loss"]),
                    "update": _rel_fro(af - p0, single["update"].double())}
            res.setdefault("single_card", {})[lab] = step
            held = all(step[k] <= b for k, b in bounds.items())
            word = ("ok" if held else "FAIL") if lab == "real" else (
                ("NOT refused" if held else "refused") if "update" in bounds else "reported")
            log(f"  {label} {lab}: against the single-card step: loss {lo!r} / {single['loss']!r}, rel "
                f"{step['loss']:.3e}; update rel {step['update']:.3e}; held to {bounds}: {word}")
            if word in ("FAIL", "NOT refused"):
                failures.append(f"{label} {lab}: step 0 against the single-card step: {step}")
        verdict = {"step0": {}}
        failures += judge_step0(label, runs, {**DIST_STEP0_BOUNDS, "null": NULL_GRAD_RTOL}, verdict,
                                against="one rank on the whole batch")
        res["step0"] = verdict["step0"]
        for lab, errs in runs.items():
            med = {g: float(np.median([v for k, v in errs.items() if k.endswith("gradient") == (g == "parameter")]))
                   for g in ("chain", "parameter")}
            res["step0"].setdefault("median", {})[lab] = med
            passes = all(v <= DIST_STEP0_MEDIAN_RTOL for v in med.values())
            log(f"  {label} {lab}: median module chain {med['chain']:.3e}, parameter {med['parameter']:.3e} (tol "
                f"{DIST_STEP0_MEDIAN_RTOL:g}) " + (("ok" if passes else "FAIL") if lab == "real" else
                                                  ("NOT refused" if passes else "refused")))
            if passes != (lab == "real"):
                failures.append(f"{label} {lab}: median module errors {med}")
        if failures:
            raise AssertionError("; ".join(failures))
    mesh_setup.all_gather(torch.zeros(1, device=mesh.device), mesh.world, 0)  # rank 0's verdict before going on
    return res


def _dist_run(mesh, label: str, trainer, draw, steps: int) -> dict:
    """``steps`` updates on this rank's shards, timed (host wall of a
    synchronised update, CUDA events), launches per step held to
    DIST_PER_STEP and summed over the steps (``launches``, as counted); the
    last step under the profiler: device busy and idle share; the halo
    exchanged per step."""
    import torch

    from surfacenetworks_tpu_torch.dist import edge_partition as ep
    from surfacenetworks_tpu_torch.sparse import kernels

    res = {"loss": [], "wall_ms": [], "device_ms": [], "launches": dict.fromkeys(kernels.launches, 0)}
    for u in range(steps):
        batch = trainer.batch(draw())
        kernels.reset_launch_counts()
        ep.reset_exchange_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        if u == steps - 1:
            with counted_profile() as prof:
                out = trainer.update(batch)
                torch.cuda.synchronize()
        else:
            out = trainer.update(batch)
        end.record()
        end.synchronize()
        res["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        res["device_ms"].append(start.elapsed_time(end))
        res["loss"].append(_loss_of(out))
        got = {k: v for k, v in kernels.launches.items() if v}
        for k, v in got.items():
            res["launches"][k] += v
        if got != {k: v for k, v in DIST_PER_STEP[label].items() if v}:
            raise AssertionError(f"{label}: step {u} launched {got}, not {DIST_PER_STEP[label]}")
        res["exchange"] = dict(ep.exchange_stats)
    rows = device_rows(prof)
    res["busy_ms"] = sum(r[0] for r in rows) / 1e3
    res["wall_ms_median"] = float(np.median(res["wall_ms"]))
    res["device_ms_median"] = float(np.median(res["device_ms"]))
    res["idle_share"] = 1 - res["busy_ms"] / res["wall_ms"][-1]
    if not all(np.isfinite(res["loss"])):
        raise AssertionError(f"{label}: non-finite losses {res['loss']}")
    ex = res["exchange"]
    _dist_log(mesh, f"{label}: losses {[round(v, 6) for v in res['loss']]}; median per step wall "
                    f"{res['wall_ms_median']:.3f} ms, CUDA-event {res['device_ms_median']:.3f} ms; profiled step "
                    f"busy {res['busy_ms']:.3f} ms, idle share {res['idle_share']:.3f}; a step's halo exchanges "
                    f"{ex['exchanges']} sending {ex['rows']} rows ({ex['bytes']} bytes), host time "
                    f"{ex['host_s'] * 1e3:.3f} ms (gloo on one card, not NCCL)")
    return res


def dist_rank(mesh, out_dir: str) -> dict:
    """One of DIST_RANKS ranks on the card: the partitioned applies, then
    ``train_normal --graph-parallel 2`` (ELL and BSR interiors),
    ``train_normal --data-parallel 2`` at batch 2 and ``train_arap
    --data-parallel 2`` at batch 32, then the graph-parallel work of the
    other families (``dist_gp_rank``); writes its report to
    ``out_dir/rank<r>.json``."""
    import torch

    from surfacenetworks_tpu_torch.cli import train_arap, train_normal
    from surfacenetworks_tpu_torch.data import datasets, laplacian_batch
    from surfacenetworks_tpu_torch.data.pipeline import to_device
    from surfacenetworks_tpu_torch.dist import mesh_setup
    from surfacenetworks_tpu_torch.train import losses, optim

    device = mesh.device

    def normal_opt(model):
        return optim.adam(model.parameters(), 1e-3)

    torch.backends.cuda.matmul.allow_tf32 = False
    rep = {"rank": mesh.rank, "backend": mesh.backend, "apply": dist_apply_checks(mesh, device)}
    for interior in ("ell", "bsr"):
        label = f"gp {interior}"
        argv = DIST_NORMAL_ARGS + ["--batch-size", "1", "--graph-parallel", "2", "--operator-format", interior,
                                   "--num-updates", str(DIST_GP_STEPS)]
        trainer = train_normal.NormalTrainer(train_normal.parser.parse_args(argv), lambda m: None, mesh)
        samples = trainer.train_sampler.next_batch()
        tier = trainer.bucketset.tiers[trainer.bucketset.tier_index(samples)]
        whole = to_device(laplacian_batch(samples, tier, fmt="ell"), device)  # the same rows, unpartitioned
        rep[label] = _dist_step0(mesh, label, trainer, trainer.batch(samples), whole, _cosine_head, normal_opt,
                                 vertex=True)
        rep[label].update(_dist_run(mesh, label, trainer, trainer.train_sampler.next_batch, DIST_GP_STEPS))
        del trainer
    dp = mesh_setup.make_mesh(DIST_RANKS, 1, ["cuda:0"] * DIST_RANKS)
    argv = DIST_NORMAL_ARGS + ["--batch-size", "2", "--data-parallel", "2", "--operator-format", "ell",
                               "--num-updates", str(DIST_DP_STEPS)]
    trainer = train_normal.NormalTrainer(train_normal.parser.parse_args(argv), lambda m: None, dp)
    samples = trainer.train_sampler.next_batch()
    rep["dp normal"] = _dist_step0(dp, "dp normal", trainer, trainer.batch(samples),
                                   trainer.batch(samples, shard=False), _cosine_head, normal_opt, vertex=False)
    rep["dp normal"].update(_dist_run(dp, "dp normal", trainer, trainer.train_sampler.next_batch, DIST_DP_STEPS))
    del trainer
    seqs = datasets.synthetic_arap_sequences(**DIST_ARAP_SEQUENCES)
    argv = ["--layer", str(LAYERS), "--batch-size", "32", "--num-updates", str(DIST_DP_STEPS), "--num-epoch", "1",
            "--seed", str(SEED), "--device", "cuda", "--data-parallel", "2"]
    trainer = train_arap.ArapTrainer(train_arap.parser.parse_args(argv), seqs, lambda m: None, dp)
    picks = trainer.sample_train_picks()

    def arap_head(out, b):
        return losses.smooth_l1_sum(out * b.mask, b.targets, b.inputs.shape[0])

    rep["dp arap"] = _dist_step0(dp, "dp arap", trainer, trainer.batch(picks, shard=True), trainer.batch(picks),
                                 arap_head, lambda m: optim.adam(m.parameters(), trainer.schedule, weight_decay=1e-5),
                                 vertex=False)
    rep["dp arap"].update(_dist_run(dp, "dp arap", _ArapShards(trainer), trainer.sample_train_picks, DIST_DP_STEPS))
    rep.update(dist_gp_rank(mesh, device))
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(rep, f)
    return rep


class _ArapShards:
    """An ARAP trainer whose ``batch(picks)`` is this rank's shard of them
    (what its ``train_batches`` feeds ``update``)."""

    def __init__(self, trainer):
        self.trainer = trainer

    def batch(self, picks):
        return self.trainer.batch(picks, shard=True)

    def update(self, batch):
        return self.trainer.update(batch)


class _Steps:
    """A trainer as ``_dist_step0`` and ``_dist_run`` see it: its model,
    optimizer and schedule, ``batch(x)`` (default the trainer's) and
    ``update(batch)`` as given (a fixed random draw, a FAUST pair)."""

    def __init__(self, trainer, update, batch=None):
        self.trainer, self._update, self._batch = trainer, update, batch or trainer.batch
        self.model, self.opt, self.schedule = trainer.model, trainer.opt, getattr(trainer, "schedule", None)
        self.step = 0

    def batch(self, x):
        return self._batch(x)

    def update(self, batch):
        return self._update(batch)


def _zeroed_halos():
    """The mutant exchange: every halo arrives as zeros (the exchange itself
    runs and is waited on, so no send is left pending)."""
    import torch

    from surfacenetworks_tpu_torch.dist import edge_partition as ep

    wait = ep._Exchange.wait
    return swapped(ep._Exchange, "wait", lambda self: tuple(torch.zeros_like(t) for t in wait(self)))


def _dirac_mesh():
    """The smoke's 7,000-vertex synthetic mesh as ``--graph-parallel`` reads
    it: RCM-ordered, its faces sorted by their smallest vertex."""
    from surfacenetworks_tpu_torch.data import datasets
    from surfacenetworks_tpu_torch.data.batching import rcm_reorder_sample
    from surfacenetworks_tpu_torch.dist import dirac_partition as dp

    s = rcm_reorder_sample(datasets.synthetic_normal_dataset(1, n_points=DIST_POINTS, seed=SEED, operator="lap")[0])
    s["F"] = np.asarray(s["F"])[dp.sort_faces_for_partition(s["F"])]
    return s


def dist_dirac_checks(mesh, device, s: dict) -> dict:
    """The partitioned Dirac pair on this rank's rows (vertex and face rows
    each halved; ``nn.blocks.apply_dirac_vf`` / ``_fv`` in the graph-sharded
    context), C=128: ``Di v`` and ``DiA f`` and both backwards against the
    single-card structured applies on the whole operator (the same
    coefficients), element by element within DIRAC_APPLY_RTOL of the sum
    |q||x| of each (the fp64 scipy pair's |D| on |x|, on the host); a
    boundary face dropped and the face halo zeroed refused; the halos, the
    boundary widths and the bytes sent per apply (gloo on one card)."""
    import dataclasses

    import torch

    from surfacenetworks_tpu_torch import geometry as geo
    from surfacenetworks_tpu_torch import native
    from surfacenetworks_tpu_torch.data import round_up
    from surfacenetworks_tpu_torch.dist import dirac_partition as dp
    from surfacenetworks_tpu_torch.dist import edge_partition as ep
    from surfacenetworks_tpu_torch.nn.blocks import apply_dirac_fv, apply_dirac_vf
    from surfacenetworks_tpu_torch.sparse import dirac_apply_fv, dirac_apply_vf, dirac_from_coeffs, stack_dirac

    G, g = mesh.n_graph, mesh.graph_index
    n, m = s["V"].shape[0], s["F"].shape[0]
    N, M, C = round_up(n, 8 * G), round_up(m, 8 * G), WIDTH
    coeffs = native.dirac_coeffs(s["V"], s["F"])
    pop = dp.stack_partitioned_dirac([dp.partition_dirac(coeffs, G, N, M)])
    loc = dp.shard_partitioned_dirac(pop, g).to(device)
    whole = stack_dirac([dirac_from_coeffs(coeffs, N, M)]).to(device)
    gen = torch.Generator().manual_seed(SEED + 901)
    v, f, gf, gv = (torch.randn(1, r, C, generator=gen).to(device) for r in (N, M, M, N))
    vr, fr = slice(g * N // G, (g + 1) * N // G), slice(g * M // G, (g + 1) * M // G)
    D, DA = geo.dirac(np.asarray(s["V"], np.float64), s["F"])

    def absapply(Mx, t, rows_out, r):
        """|Mx| on |t| (the first real rows of t), padded to ``rows_out`` and cut to ``r``."""
        out = np.zeros((rows_out, C))
        k = Mx.shape[1] // 4
        out[: Mx.shape[0] // 4] = _quaternion_apply(abs(Mx), np.abs(t[0, :k].double().cpu().numpy()))
        return out[r]

    scales = {"vf": absapply(D, v, M, fr), "fv": absapply(DA, f, N, vr),
              "vf backward": absapply(D.T.tocsr(), gf, N, vr), "fv backward": absapply(DA.T.tocsr(), gv, M, fr)}

    def sharded(op):
        vl, fl = v[:, vr].clone().requires_grad_(), f[:, fr].clone().requires_grad_()
        with mesh.context(vertex=True, batch=False):
            yf, yv = apply_dirac_vf(op, vl), apply_dirac_fv(op, fl)
        torch.autograd.backward([yf, yv], [gf[:, fr], gv[:, vr]])
        return {"vf": yf.detach(), "fv": yv.detach(), "vf backward": vl.grad, "fv backward": fl.grad}

    vw, fw = v.clone().requires_grad_(), f.clone().requires_grad_()
    yf, yv = dirac_apply_vf(whole, vw), dirac_apply_fv(whole, fw)
    torch.autograd.backward([yf, yv], [gf, gv])
    ref = {"vf": yf.detach()[:, fr], "fv": yv.detach()[:, vr], "vf backward": vw.grad[:, vr], "fv backward": fw.grad[:, fr]}
    got = sharded(loc)
    what = f"rank {mesh.rank}: partitioned Dirac"
    r = {"N": N, "M": M, "halo_v": pop.halo_v, "halo_f": pop.halo_f, "Mbf": int(loc.fbnd_rows.shape[-1]),
         "Mbv": int(loc.vbnd_rows.shape[-1]),
         "max_abs_err": {k: check(f"{what} {k}", got[k][0], ref[k][0], scales[k], DIRAC_APPLY_RTOL) for k in got}}
    # mutants: one boundary face dropped (a face of this partition whose vertices reach a neighbour), the face halo zeroed
    bad_q = loc.fbnd_q_fv.clone()
    bad_q[0, 0] = 0.0
    bad = sharded(dataclasses.replace(loc, fbnd_q_fv=bad_q))
    refused(f"{what} vf, one boundary face dropped", bad["vf"][0], ref["vf"][0], scales["vf"], DIRAC_APPLY_RTOL)
    with _zeroed_halos():
        zeroed = sharded(loc)
    refused(f"{what} fv, the face halo zeroed", zeroed["fv"][0], ref["fv"][0], scales["fv"], DIRAC_APPLY_RTOL)
    # the applies, both ranks together: wall, CUDA-event and the halo per apply
    vl, fl = v[:, vr].contiguous(), f[:, fr].contiguous()
    with mesh.context(vertex=True, batch=False), torch.no_grad():
        for side, fn, x in (("vf", apply_dirac_vf, vl), ("fv", apply_dirac_fv, fl)):
            for _ in range(3):
                fn(loc, x)
            torch.cuda.synchronize()
            ep.reset_exchange_stats()
            reps = 20
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn(loc, x)
            end.record()
            end.synchronize()
            st = dict(ep.exchange_stats)
            r[side] = {"wall_ms": (time.perf_counter() - t0) * 1e3 / reps, "device_ms": start.elapsed_time(end) / reps,
                       "halo_rows": st["rows"] / reps, "halo_bytes": st["bytes"] / reps,
                       "exchange_host_ms": st["host_s"] * 1e3 / reps}
    _dist_log(mesh, f"partitioned Dirac pair ({N} vertex rows, {M} face rows, C={C}): halo_v {r['halo_v']}, halo_f "
                    f"{r['halo_f']}, Mbf {r['Mbf']}, Mbv {r['Mbv']}; vf {r['vf']['wall_ms']:.3f} ms wall, "
                    f"{r['vf']['halo_bytes']:.0f} bytes sent per apply; fv {r['fv']['wall_ms']:.3f} ms wall, "
                    f"{r['fv']['halo_bytes']:.0f} bytes sent per apply (gloo on one card, staged through pinned host "
                    f"buffers; not NCCL); errors {r['max_abs_err']}")
    return r


def dist_gat_checks(mesh, device, s: dict) -> dict:
    """The partitioned GAT attend (4 heads of 32 channels) on this rank's
    rows of the 7,000-vertex mesh's RCM-ordered Laplacian pattern, forward
    and the gradients of its three inputs, against the single-card
    ``gat_attend`` on the whole pattern, within DIST_GAT_RTOL of each
    tensor's largest element; the payload halo zeroed refused."""
    import torch

    from surfacenetworks_tpu_torch.data import round_up
    from surfacenetworks_tpu_torch.dist import edge_partition as ep
    from surfacenetworks_tpu_torch.dist import graph_parallel as gpar
    from surfacenetworks_tpu_torch.nn.blocks import gat_attend
    from surfacenetworks_tpu_torch.sparse import operator_from_scipy, stack_operators

    G, g = mesh.n_graph, mesh.graph_index
    L = s["L"]
    N = round_up(L.shape[0], 8 * G)
    halo = min(ep.suggest_halo(L), N // G)
    loc = gpar.shard_operator(gpar.partition_batch_operator([L], G, n_rows=N, halo=halo, k=16), g).to(device)
    whole = stack_operators([operator_from_scipy(L, k=16, n_rows=N, n_cols=N)]).to(device)
    gen = torch.Generator().manual_seed(SEED + 902)
    xh, ss, sd, go = (torch.randn(shape, generator=gen).to(device) for shape in
                      ((1, N, 4, 32), (1, N, 4), (1, N, 4), (1, N, 4, 32)))
    rows = slice(g * N // G, (g + 1) * N // G)

    def sharded():
        a = [t[:, rows].clone().requires_grad_() for t in (xh, ss, sd)]
        with mesh.context(vertex=True, batch=False):
            o = gat_attend(loc, *a)
        o.backward(go[:, rows])
        return [o.detach()] + [t.grad for t in a]

    A = [t.clone().requires_grad_() for t in (xh, ss, sd)]
    O = gat_attend(whole, *A)
    O.backward(go)
    ref = [O.detach()[:, rows]] + [t.grad[:, rows] for t in A]
    names = ("out", "xh gradient", "source score gradient", "destination score gradient")
    what = f"rank {mesh.rank}: partitioned GAT attend"

    def errs(got):
        return {k: float((a - b).abs().max() / b.abs().max()) for k, a, b in zip(names, got, ref)}

    real = errs(sharded())
    with _zeroed_halos():
        mutant = errs(sharded())
    if max(real.values()) > DIST_GAT_RTOL:
        raise AssertionError(f"{what}: {real} above {DIST_GAT_RTOL}")
    if max(mutant.values()) <= DIST_GAT_RTOL:
        raise AssertionError(f"{what}: the payload halo zeroed passes ({mutant})")
    _dist_log(mesh, f"partitioned GAT attend (rows {N}, halo {halo}, {int(loc.fwd.bnd_rows.shape[-1])} boundary rows, "
                    f"4 heads x 32): worst share of the largest element {max(real.values()):.3e} (tol {DIST_GAT_RTOL:g}); "
                    f"the payload halo zeroed {max(mutant.values()):.3e}, refused")
    return {"rows": N, "halo": halo, "rel_err": real, "mutant_rel_err": mutant}


def _dist_gp_normal(mesh, device, model: str) -> dict:
    """``train_normal --graph-parallel 2 --model dirac|gat`` at
    DIST_GP_LAYERS layers on the 7,000-vertex meshes: step 0 against one
    rank on the whole batch (Dirac: the unpartitioned tables of the same
    coefficients; GAT: the ELL pattern), then DIST_GP_STEPS_NEW updates."""
    from surfacenetworks_tpu_torch import native
    from surfacenetworks_tpu_torch.cli import train_normal
    from surfacenetworks_tpu_torch.data import dirac_batch, laplacian_batch
    from surfacenetworks_tpu_torch.data.pipeline import to_device
    from surfacenetworks_tpu_torch.sparse import dirac_from_coeffs, stack_dirac
    from surfacenetworks_tpu_torch.train import optim

    label = f"gp normal {model}"
    argv = DIST_NORMAL_ARGS + ["--layer", str(DIST_GP_LAYERS), "--batch-size", "1", "--graph-parallel", "2",
                               "--model", model, "--operator-format", "ell", "--num-updates", str(DIST_GP_STEPS_NEW)]
    trainer = train_normal.NormalTrainer(train_normal.parser.parse_args(argv), lambda m: None, mesh)
    samples = trainer.train_sampler.next_batch()
    tier = trainer.bucketset.tiers[trainer.bucketset.tier_index(samples)]
    if model == "dirac":
        op = stack_dirac([dirac_from_coeffs(native.dirac_coeffs(x["V"], x["F"]), tier.n_vertices, tier.n_faces,
                                            tier.max_valence) for x in samples])
        whole = to_device(dirac_batch(samples, tier, operator=op), device)
    else:
        whole = to_device(laplacian_batch(samples, tier, fmt="ell"), device)
    # DirDeepModel's last block adds its vertex biases right before conv2's batch norm, which removes them
    null = {f"rn{DIST_GP_LAYERS - 1}.bn_fc1.fc.bias", f"rn{DIST_GP_LAYERS - 1}.bn_fc1.bn.bias"} if model == "dirac" else ()
    rep = _dist_step0(mesh, label, trainer, trainer.batch(samples), whole, _cosine_head,
                      lambda m: optim.adam(m.parameters(), 1e-3), vertex=True, null=frozenset(null))
    rep.update(_dist_run(mesh, label, trainer, trainer.train_sampler.next_batch, DIST_GP_STEPS_NEW))
    rep["layers"] = DIST_GP_LAYERS
    return rep


def _dist_gp_arap(mesh, device) -> dict:
    """``train_arap --graph-parallel 2 --model lap`` at batch 32 and
    DIST_GP_LAYERS layers on the 2,000-vertex sequences."""
    from surfacenetworks_tpu_torch.cli import train_arap
    from surfacenetworks_tpu_torch.data import arap_batch, datasets
    from surfacenetworks_tpu_torch.data.pipeline import to_device
    from surfacenetworks_tpu_torch.train import losses, optim

    seqs = datasets.synthetic_arap_sequences(**DIST_ARAP_SEQUENCES)
    argv = ["--layer", str(DIST_GP_LAYERS), "--batch-size", "32", "--num-updates", str(DIST_GP_STEPS_NEW),
            "--num-epoch", "1", "--seed", str(SEED), "--device", "cuda", "--graph-parallel", "2"]
    trainer = train_arap.ArapTrainer(train_arap.parser.parse_args(argv), seqs, lambda m: None, mesh)
    picks = trainer.sample_train_picks()
    whole = to_device(arap_batch(trainer.sequences, picks, trainer.buckets, model="lap", fmt="ell"), device)

    def head(out, b):
        return losses.smooth_l1_sum(out * b.mask, b.targets, b.inputs.shape[0])

    rep = _dist_step0(mesh, "gp arap", trainer, trainer.batch(picks, shard=True), whole, head,
                      lambda m: optim.adam(m.parameters(), trainer.schedule, weight_decay=1e-5), vertex=True)
    rep.update(_dist_run(mesh, "gp arap", _ArapShards(trainer), trainer.sample_train_picks, DIST_GP_STEPS_NEW))
    rep["layers"] = DIST_GP_LAYERS
    return rep


def _dist_gp_mesh(mesh, device, family: str) -> dict:
    """``train_mnist --graph-parallel 2 --model lap`` at batch 64 and
    ``train_vae --graph-parallel 2 --model dirac`` at batch 1, both at
    MESH_LAYERS on 210-vertex height fields: step 0 with a fixed draw (the
    keep mask, the noise) against one rank on the whole batch (the pooled
    head held through ``mesh_head``), then DIST_GP_STEPS_NEW updates with the
    trainer's own draws."""
    import dataclasses

    import torch

    from surfacenetworks_tpu_torch.cli import train_mnist, train_vae
    from surfacenetworks_tpu_torch.data import datasets, mnist_batch, vae_batch
    from surfacenetworks_tpu_torch.data.pipeline import to_device
    from surfacenetworks_tpu_torch.models.mnist_models import WIDTH as MW, dropout_keep
    from surfacenetworks_tpu_torch.models.vae import LATENT
    from surfacenetworks_tpu_torch.train import losses, optim

    samples = datasets.synthetic_mnist_dataset(**DIST_MNIST_DATA)
    mod = train_mnist if family == "mnist" else train_vae
    model = "lap" if family == "mnist" else "dirac"
    label = "gp mnist" if family == "mnist" else "gp vae dirac"
    argv = MESH_ARGS[family] + ["--graph-parallel", "2", "--model", model]
    if family == "vae":
        argv += ["--batch-size", "1"]
    cls = train_mnist.MnistTrainer if family == "mnist" else train_vae.VaeTrainer
    trainer = cls(mod.parser.parse_args(argv), samples, fmt="ell", log=lambda m: None, mesh=mesh)
    drawn = trainer.train_sampler.next_batch()
    B = len(drawn)
    gen = torch.Generator(device=device).manual_seed(SEED + 903)
    paths = _mesh_capture_paths(family)
    if family == "mnist":
        draw = dropout_keep((B, MW), gen, device)
        whole = to_device(mnist_batch(drawn, trainer.buckets, model=model, fmt="ell"), device)
        steps = _Steps(trainer, lambda b: trainer.update(b, keep=draw), lambda x: trainer.batch(x, shard=True))

        def single(m):
            return losses.nll_loss(m(whole.operator, whole.mask, whole.inputs, deterministic=False, keep=draw),
                                   whole.targets)

        def head_errs(cap, lo, gr):
            return mesh_head("mnist", cap, lo, gr, None, whole, None, 0.0)

        run = _Steps(trainer, trainer.update, lambda x: trainer.batch(x, shard=True))
    else:
        draw = torch.randn(B, LATENT, generator=gen, device=device)
        kw = train_vae.kld_weight(0)
        whole = to_device(vae_batch(drawn, trainer.buckets, model=model, fmt="auto"), device)
        steps = _Steps(trainer, lambda b: trainer.update(b, kw, eps=draw), lambda x: trainer.batch(x, shard=True))

        def single(m):
            return mesh_objective("vae", m, whole, draw, kw)[0]

        def head_errs(cap, lo, gr):
            b64 = dataclasses.replace(whole, inputs=whole.inputs.double(), mask=whole.mask.double(),
                                      aux={"flat_inputs": whole.aux["flat_inputs"].double()})
            return mesh_head("vae", cap, lo, gr, copy.deepcopy(trainer.model).double(), b64, draw.double(), kw)

        run = _Steps(trainer, lambda b: trainer.update(b, kw), lambda x: trainer.batch(x, shard=True))
    apply = (lambda name, k, op: whole.aux["flat_operator"] if name.startswith("decoder.") else whole.operator)
    rep = _dist_step0(mesh, label, steps, steps.batch(drawn), whole, None,
                      lambda m: optim.adam(m.parameters(), 1e-3, weight_decay=1e-5), vertex=True,
                      capture=lambda m: ModuleCapture(m, paths), single=single, head_errs=head_errs,
                      replay=(lambda m: m, "", apply))
    rep.update(_dist_run(mesh, label, run, trainer.train_sampler.next_batch, DIST_GP_STEPS_NEW))
    rep["layers"] = MESH_LAYERS
    return rep


def _dist_gp_faust(mesh, device, data: list, fmt: str) -> dict:
    """``train_correspondence --graph-parallel 2`` with the lap trunk (ELL,
    or BSR interiors with ``fmt`` bsr) or the dir trunk (``fmt`` dir), dcel
    on the streaming head, at DIST_GP_LAYERS layers on two 7,000-vertex
    scans: step 0 (the epoch plan's first pair and rotations) against one
    rank on both whole shapes (the trunk replayed module by module on the
    unpartitioned operators, the head in fp64 on the gathered features),
    then DIST_GP_STEPS_NEW updates of the plan."""
    import torch

    from surfacenetworks_tpu_torch.cli import train_correspondence as tc
    from surfacenetworks_tpu_torch.data import correspondence_batch
    from surfacenetworks_tpu_torch.train import losses

    label = {"ell": "gp faust lap", "bsr": "gp faust bsr", "dir": "gp faust dir"}[fmt]
    argv = TRAIN_ARGS + ["--layer", str(DIST_GP_LAYERS), "--smooth-reg", "0", "--graph-parallel", "2",
                         "--num-updates", str(DIST_GP_STEPS_NEW + 1)]  # step 0, then the run
    argv += ["--model", "dir"] if fmt == "dir" else ["--operator-format", fmt]
    trainer = tc.CorrespondenceTrainer(tc.parser.parse_args(argv), lambda m: None, data=data, mesh=mesh)
    pairs, rots = trainer.epoch_plan()
    plan = iter([(int(a), int(b), [float(r) for r in rr]) for (a, b), rr in zip(pairs, rots)])
    ia, ib, r0 = next(plan)
    target = trainer.pair_target(ia, ib)

    def entry(i):
        pack = correspondence_batch(trainer.data[i], trainer.buckets, fmt="ell", model=trainer.model_key)
        return {"op": pack.operator.to(device), "mask": pack.mask.to(device), "inputs": pack.inputs.to(device)}

    ends = [entry(ia), entry(ib)]
    steps = _Steps(trainer, lambda p: trainer.update(*p), lambda p: p)

    def single(m):
        return tc.objective(m, ends[0], ends[1], r0, target, 0.0, trainer.use_stream, None, trainer.loss_fn)

    def head_errs(cap, lo, gr):
        return output_head(cap, lo, lambda fa, fb: losses.corr_delta_cross_entropy_from_target(
            torch.einsum("bnc,bmc->bnm", fa, fb)[0], target))

    rep = _dist_step0(mesh, label, steps, (ia, ib, r0), None, None,
                      lambda m: tc.optim.adam(m.parameters(), float(trainer.args.lr), weight_decay=1e-5), vertex=True,
                      capture=lambda m: StepCapture(m.trunk), single=single, head_errs=head_errs,
                      replay=(lambda m: m.trunk, "trunk.", lambda name, k, op: ends[k]["op"]))
    rep.update(_dist_run(mesh, label, steps, lambda: next(plan), DIST_GP_STEPS_NEW))
    rep["layers"] = DIST_GP_LAYERS
    return rep


def dist_gp_rank(mesh, device) -> dict:
    """This rank's share of the graph-parallel work of every other trainer
    (after the first graph-parallel runs): the partitioned Dirac applies and
    GAT attend, then the graph-parallel train runs."""
    from surfacenetworks_tpu_torch.data import datasets

    t0 = time.perf_counter()
    s = _dirac_mesh()
    rep = {"dirac apply": dist_dirac_checks(mesh, device, s), "gat attend": dist_gat_checks(mesh, device, s)}
    for model in ("dirac", "gat"):
        rep[f"gp normal {model}"] = _dist_gp_normal(mesh, device, model)
    rep["gp arap"] = _dist_gp_arap(mesh, device)
    rep["gp mnist"] = _dist_gp_mesh(mesh, device, "mnist")
    rep["gp vae dirac"] = _dist_gp_mesh(mesh, device, "vae")
    faust = datasets.synthetic_correspondence_dataset(**DIST_FAUST_DATA)
    for fmt in ("lap", "bsr", "dir"):
        rep[f"gp faust {fmt}"] = _dist_gp_faust(mesh, device, faust, "ell" if fmt == "lap" else fmt)
    rep["seconds"] = time.perf_counter() - t0
    _dist_log(mesh, f"graph-parallel checks and runs of the Dirac pair, the GAT attend and every trainer: "
                    f"{rep['seconds']:.2f} s")
    return rep


def nccl_check(device) -> dict:
    """One rank over NCCL in this process (``initialize_multihost`` on a
    loopback address, a one-rank grid whose axes are not staged): the normal
    trainer's own DP step on a 7,000-vertex mesh, ``train_normal.train_step``
    over the grid after ``data_parallel.replicate`` (NCCL ``broadcast`` of
    every parameter and buffer) with its gradients summed by
    ``parallel_context.sum_gradients`` (one NCCL ``all_reduce`` through
    ``all_reduce_``'s device branch), held bit for bit to the same step
    without a grid; ``all_reduce_`` of a tensor on the card; ``_Exchange``
    on the one-rank graph axis (its device path: no host staging, zero halos
    at both chain ends).  The collectives are counted as they are called and
    must have taken CUDA tensors.  NCCL's peer-to-peer sends and its
    collectives across cards are not exercised on a one-card machine."""
    import torch
    import torch.distributed as dist

    from surfacenetworks_tpu_torch import parallel_context
    from surfacenetworks_tpu_torch.cli import train_normal
    from surfacenetworks_tpu_torch.dist import data_parallel, mesh_setup
    from surfacenetworks_tpu_torch.dist import edge_partition as ep

    calls = {"all_reduce": [], "broadcast": []}

    def counted(name):
        fn = getattr(dist, name)

        def call(t, *a, **k):
            calls[name].append(t.device.type)
            return fn(t, *a, **k)
        return call

    # one rank on a card of its own: the backend its identity asks for is nccl
    mesh_setup.initialize_multihost(f"tcp://127.0.0.1:{mesh_setup.free_port()}", 0, 1, device, timeout_s=120)
    try:
        mesh = mesh_setup.make_mesh(1, 1, devices=[device])
        if mesh.backend != "nccl" or mesh.world.staged or mesh.graph.staged:
            raise AssertionError(f"the one-rank grid is {mesh.backend}, staged {mesh.world.staged}")
        argv = DIST_NORMAL_ARGS + ["--batch-size", "1", "--operator-format", "ell", "--num-updates", "1"]
        trainer = train_normal.NormalTrainer(train_normal.parser.parse_args(argv), lambda m: None)
        model, opt = trainer.model, trainer.opt
        batch = trainer.batch(trainer.train_sampler.next_batch())
        state0, opt0 = copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())

        def flat():
            return torch.cat([p.detach().reshape(-1) for p in model.parameters()])

        loss_one, _ = train_normal.train_step(model, opt, batch, trainer.schedule)
        one = flat()
        model.load_state_dict(state0)
        opt.load_state_dict(opt0)
        with swapped(dist, "all_reduce", counted("all_reduce")), swapped(dist, "broadcast", counted("broadcast")):
            data_parallel.replicate(mesh, model)
            loss_grid, _ = train_normal.train_step(model, opt, batch, trainer.schedule, mesh=mesh)
            grid = flat()
            n_params = len(list(model.parameters())) + len(list(model.buffers()))
            if calls != {"all_reduce": ["cuda"], "broadcast": ["cuda"] * n_params}:
                raise AssertionError(f"the DP step's collectives over NCCL: {calls}, not one all_reduce and "
                                     f"{n_params} broadcasts of CUDA tensors")
            t = torch.randn(1 << 20, device=device, generator=torch.Generator(device).manual_seed(SEED))
            summed = parallel_context.all_reduce_(t.clone(), mesh.world)
        torch.cuda.synchronize()
        if not (torch.equal(loss_one, loss_grid) and torch.equal(one, grid)):
            raise AssertionError("the DP step over one NCCL rank differs from the step without a grid")
        if not torch.equal(summed, t):
            raise AssertionError("all_reduce_ over one NCCL rank changed the tensor")
        x = torch.randn(3500, WIDTH, device=device)
        ex = ep._Exchange(x, 248, mesh.graph)
        left, right = ex.wait()
        if ex.staged or left.device != x.device or left.abs().sum() or right.abs().sum():
            raise AssertionError("the exchange on a one-rank NCCL axis: staged, off the card, or not zeros")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    version = ".".join(str(v) for v in torch.cuda.nccl.version())
    log(f"  [nccl] backend {backend} (NCCL {version}): train_normal's DP step over a one-rank grid on {device}, "
        f"{len(calls['broadcast'])} broadcasts and {len(calls['all_reduce'])} all_reduce of CUDA tensors, equal "
        f"bit for bit to the step without a grid (loss {float(loss_grid)!r}); all_reduce_ of 2^20 floats; the "
        f"exchange's device path (no staging, zero halos); peer-to-peer and cross-card collectives are not "
        f"exercised on one card")
    return {"backend": backend, "nccl": version, "loss": float(loss_grid), "collectives": {k: len(v) for k, v in
                                                                                      calls.items()}}


def dist_phase(device, smi: str) -> tuple[dict, dict]:
    """The distributed runtime on the one card: DIST_RANKS ranks over gloo
    (``dist_rank``; the kernels built here first) and one rank over NCCL in
    this process (``nccl_check``).  Returns the launches the ranks counted
    on the sharded training paths, summed over the ranks, and the ranks'
    reports."""
    from surfacenetworks_tpu_torch.dist import mesh_setup

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mesh_setup.launch(dist_rank, 1, DIST_RANKS, devices=["cuda:0"] * DIST_RANKS, args=(tmp,), timeout_s=300)
        ranks = []
        for r in range(DIST_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        log(f"  {DIST_RANKS} ranks on one card over {ranks[0]['backend']}: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    nccl = nccl_check(device)
    log(f"  one NCCL rank: {time.perf_counter() - t0:.2f} s")
    counts = dict.fromkeys(port_kernels.launches, 0)
    for rep in ranks:  # the launches each rank counted on its training paths
        for label in DIST_PER_STEP:
            for k, v in rep[label]["launches"].items():
                counts[k] += v
    return counts, {"ranks": ranks, "nccl": nccl, "card": smi}


# --multihost on the one card: each run's two processes started apart
# (``subprocess.Popen``, the CLI's own flags: ``--coordinator-address
# 127.0.0.1:<free port> --num-processes 2 --process-id i``), one rank each,
# beside the one-launch run of the same flags, whose two ranks share the card
# as the dist phase's do; all fifteen launches at once.  The normal runs
# (Lap-15, width 128, the dist phase's 7,000-vertex data, 2 updates) and the
# FAUST sl1 run take the same path either way, so their checkpoints and
# metrics lines must be equal bit for bit; FAUST dcel takes the host path
# under --multihost (as the JAX trainer) and the fast path in one launch,
# so its losses are held to DIST_SINGLE_CARD_RTOL's FAUST bound.  Launches
# per process (one rank): MH_PER_RUN.
MH_STEPS = 2
MH_NORMAL_ARGS = ["--synthetic", "3", "--synthetic-points", str(DIST_POINTS), "--seed", str(SEED), "--layer",
                  str(LAYERS), "--num-epoch", "1", "--num-updates", str(MH_STEPS), "--no-test", "--result-prefix", "mh"]
MH_FAUST_ARGS = ["--synthetic", "2", "--synthetic-points", str(DIST_POINTS), "--seed", str(SEED), "--layer",
                 str(DIST_GP_LAYERS), "--num-epoch", "1", "--num-updates", str(MH_STEPS), "--deser-option", "no",
                 "--operator-format", "ell", "--graph-parallel", "2", "--result-prefix", "mh"]
MH_RUNS = {
    "gp ell": ("train_normal", MH_NORMAL_ARGS + ["--batch-size", "1", "--graph-parallel", "2", "--operator-format",
                                                 "ell"]),
    "gp bsr": ("train_normal", MH_NORMAL_ARGS + ["--batch-size", "1", "--graph-parallel", "2", "--operator-format",
                                                 "bsr"]),
    "dp normal": ("train_normal", MH_NORMAL_ARGS + ["--batch-size", "2", "--data-parallel", "2", "--operator-format",
                                                    "ell"]),
    "gp faust sl1": ("train_correspondence", MH_FAUST_ARGS + ["--loss", "sl1"]),
    "gp faust dcel": ("train_correspondence", MH_FAUST_ARGS + ["--loss", "dcel"]),
}
# a process's launches over its run: the steps (DIST_PER_STEP's; sl1 has no
# streaming head, so no mirror) and, for FAUST, the test pass's one pair
# (two trunk forwards: 16 applies of two launches)
MH_PER_RUN = {
    "gp ell": launches_of(ell_matmul=64 * MH_STEPS),
    "gp bsr": launches_of(bsr_matmul=32 * MH_STEPS, ell_matmul=32 * MH_STEPS),
    "dp normal": launches_of(ell_matmul=32 * MH_STEPS),
    "gp faust sl1": launches_of(ell_matmul=64 * MH_STEPS + 32),
    "gp faust dcel": launches_of(ell_matmul=65 * MH_STEPS + 32),
}
MH_TIMEOUT_S = 420
MH_FILES = {"train_normal": ("pts/mh_normal_state.pt", "log/mh.metrics.jsonl"),
            "train_correspondence": ("pts/mh_state.pt", "log/mh.metrics.jsonl")}


def multihost_worker(argv: list) -> int:
    """One launch of the multihost phase (run as its own process):
    ``OUT.json TRAINER FLAGS...``; the trainer's ``main`` on its flags, the
    launch counters (this process's rank under --multihost) and the wall
    written to OUT.json.  Without --multihost (the one-launch reference) its
    ranks share card 0, as the dist phase's do."""
    import importlib

    import torch

    from surfacenetworks_tpu_torch.dist import mesh_setup

    out, trainer, *flags = argv
    mod = importlib.import_module(f"surfacenetworks_tpu_torch.cli.{trainer}")
    steps = {"wall_ms": [], "device_ms": []}
    if "--multihost" not in flags and torch.cuda.is_available():
        mesh_setup.default_devices = lambda device, n: [torch.device("cuda", 0)] * n
    else:  # this process's rank: each update timed, the last one profiled
        cls = mod.NormalTrainer if trainer == "train_normal" else mod.CorrespondenceTrainer
        for name in ("update", "update_host"):
            if hasattr(cls, name):
                setattr(cls, name, _timed_update(getattr(cls, name), steps))
    port_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mod.main(flags)
    with open(out, "w") as f:
        json.dump({"launches": dict(port_kernels.launches), "seconds": time.perf_counter() - t0, **steps}, f)
    return 0


def _timed_update(update, rec: dict):
    """``update`` with each call's host wall and CUDA-event time kept in
    ``rec`` (synchronised around it), the MH_STEPS-th under the profiler:
    its device busy and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def timed(self, *args, **kwargs):
        last = len(rec["wall_ms"]) == MH_STEPS - 1
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if last \
                else contextlib.nullcontext() as prof:
            out = update(self, *args, **kwargs)
            end.record()
            end.synchronize()
        rec["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["device_ms"].append(start.elapsed_time(end))
        if last:
            rec["busy_ms"] = sum(r[0] for r in device_rows(prof)) / 1e3
            rec["idle_share"] = 1 - rec["busy_ms"] / rec["wall_ms"][-1]
        return out

    return timed


def _tensors_of(obj, prefix: str = "") -> dict:
    import torch

    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if isinstance(obj, dict):
        return {k: v for key, val in obj.items() for k, v in _tensors_of(val, f"{prefix}/{key}").items()}
    return {prefix: torch.tensor(float(obj))} if isinstance(obj, (int, float)) else {}


def _metric_lines(path: str) -> list:
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in ("time", "steps_per_s")} for line in f]


def multihost_phase(smi: str) -> tuple[dict, dict]:
    """The --multihost runs (MH_RUNS), each against its one-launch run:
    bit for bit (the FAUST dcel losses within the FAUST bound), the
    launches of each process asserted.  Returns the launches the multihost
    processes counted, summed, and a report per run."""
    import torch

    from surfacenetworks_tpu_torch.dist import mesh_setup

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = "import sys, chip_smoke; sys.exit(chip_smoke.multihost_worker(sys.argv[1:]))"
    procs, failures, report = {}, [], {}
    counts = dict.fromkeys(port_kernels.launches, 0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            for label, (trainer, flags) in MH_RUNS.items():
                run_dir = os.path.join(tmp, label.replace(" ", "_"))
                coord = ["--multihost", "--coordinator-address", f"127.0.0.1:{mesh_setup.free_port()}",
                         "--num-processes", "2"]
                for who, extra, out in [("one", [], "one")] + [(f"p{i}", coord + ["--process-id", str(i)], "two")
                                                               for i in range(2)]:
                    os.makedirs(os.path.join(run_dir, out), exist_ok=True)
                    stem = os.path.join(run_dir, who)
                    logf = open(stem + ".log", "w")
                    procs[(label, who)] = (subprocess.Popen(
                        [sys.executable, "-c", cmd, stem + ".json", trainer, *flags, "--result-dir",
                         os.path.join(run_dir, out), *extra], cwd=root, stdout=logf, stderr=subprocess.STDOUT,
                        start_new_session=True), logf, stem)
            deadline = time.monotonic() + MH_TIMEOUT_S
            for (label, who), (proc, logf, stem) in procs.items():
                try:
                    proc.wait(timeout=max(deadline - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    failures.append(f"multihost {label} {who}: not finished in {MH_TIMEOUT_S} s")
        finally:
            for proc, logf, _ in procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, 9)
                    proc.wait()
                logf.close()
        wall = time.perf_counter() - t0
        for (label, who), (proc, _, stem) in procs.items():
            if proc.returncode != 0:
                with open(stem + ".log") as f:
                    tail = f.read()[-3000:]
                failures.append(f"multihost {label} {who}: exit {proc.returncode}")
                log(f"  multihost {label} {who} failed:\n{tail}")
        if failures:
            raise AssertionError("; ".join(failures))
        for label, (trainer, _) in MH_RUNS.items():
            run_dir = os.path.join(tmp, label.replace(" ", "_"))
            ckpt, metrics = MH_FILES[trainer]
            info = {who: json.load(open(os.path.join(run_dir, who + ".json"))) for who in ("one", "p0", "p1")}
            one_m, two_m = (_metric_lines(os.path.join(run_dir, d, metrics)) for d in ("one", "two"))
            a, b = (_tensors_of(torch.load(os.path.join(run_dir, d, ckpt), weights_only=True))
                    for d in ("one", "two"))
            with open(os.path.join(run_dir, "two", "log", "mh.log")) as f:
                mh_line = [line.strip() for line in f if line.startswith("multihost:")]
            r = {"seconds": {who: i["seconds"] for who, i in info.items()}, "metrics_one": one_m, "metrics_two": two_m,
                 "multihost_line": mh_line}
            for who in ("p0", "p1"):
                got = {k: v for k, v in info[who]["launches"].items() if v}
                if got != {k: v for k, v in MH_PER_RUN[label].items() if v}:
                    failures.append(f"multihost {label} {who}: launched {got}, not {MH_PER_RUN[label]}")
                for k, v in info[who]["launches"].items():
                    counts[k] += v
            if label == "gp faust dcel":
                rel = [abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(two_m, one_m)]
                r["loss_rel"] = rel
                bound = DIST_SINGLE_CARD_RTOL["gp faust lap"]["loss"]
                if len(one_m) != len(two_m) or max(rel) > bound:
                    failures.append(f"multihost {label}: losses {two_m} against the one-launch fast path's {one_m}")
            else:
                same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a) and one_m == two_m
                r["bit_equal"] = same
                if not same:
                    failures.append(f"multihost {label}: the checkpoint or metrics differ from the one-launch run's")
            if not mh_line:
                failures.append(f"multihost {label}: no multihost line in the log")
            report[label] = r
            r["ranks"] = {who: {k: info[who].get(k) for k in ("wall_ms", "device_ms", "busy_ms", "idle_share")}
                          for who in ("p0", "p1")}
            for who, t in r["ranks"].items():
                log(f"  multihost {label} {who}: per update wall {['%.1f' % v for v in t['wall_ms']]} ms, CUDA-event "
                    f"{['%.1f' % v for v in t['device_ms']]} ms; last update busy {t['busy_ms']:.3f} ms, idle share "
                    f"{t['idle_share']:.3f} ({smi})")
            log(f"  multihost {label}: two processes ({info['p0']['seconds']:.1f} s, {info['p1']['seconds']:.1f} s) "
                f"against one launch ({info['one']['seconds']:.1f} s): "
                + (f"losses relative to the fast path {['%.2e' % v for v in r['loss_rel']]}" if "loss_rel" in r else
                   f"checkpoint and metrics {'bit-identical' if r.get('bit_equal') else 'DIFFER'}")
                + f"; launches per process {dict((k, v) for k, v in info['p0']['launches'].items() if v)}; "
                f"{mh_line[:1]}; train loss {[m['loss'] for m in two_m if m['split'] == 'train']} ({smi})")
        log(f"  multihost: {len(procs)} launches at once, {wall:.2f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    return counts, report


def main() -> int:
    t_all = t0 = T_START
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a CUDA card",
              file=sys.stderr)
        return 1
    from surfacenetworks_tpu_torch.sparse import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {name} count {torch.cuda.device_count()}")
    phase("device", t0)

    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info
    log(f"  nvcc build {info['seconds']:.2f} s -> {info['path']}" if "seconds" in info
        else f"  library already built: {info['path']}")
    registers = ptxas_report(info.get("log", ""))
    sddmm_regs = {k: v for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS["sddmm"])}
    if not sddmm_regs or any(v.get("registers", 99) > 64 or v.get("spill_stores") or v.get("spill_loads")
                             for v in sddmm_regs.values()):
        raise AssertionError(f"the SDDMM kernel must fit in 64 registers without spills: {sddmm_regs}")
    sddmm16_regs = {k: v for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS["sddmm_bf16"])}
    if len(sddmm16_regs) != 8 or any(v.get("registers", 99) > 64 or v.get("spill_stores") or v.get("spill_loads")
                                     for v in sddmm16_regs.values()):
        raise AssertionError(f"the bf16 SDDMM kernel's 8 variants must fit in 64 registers without spills: "
                             f"{sddmm16_regs}")
    ell16_regs = {k: v for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS["ell_matmul_bf16"])}
    if len(ell16_regs) != 2 or any(v.get("registers", 99) > 64 or v.get("spill_stores") or v.get("spill_loads")
                                   for v in ell16_regs.values()):
        raise AssertionError(f"the bf16 ELL kernel must fit in 64 registers without spills: {ell16_regs}")
    bsr16_regs = {k: v for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS["bsr_matmul_bf16"])}
    if len(bsr16_regs) != 4 or any("registers" not in v or v.get("spill_stores") or v.get("spill_loads")
                                   for v in bsr16_regs.values()):
        raise AssertionError(f"the bf16 BSR kernel must not spill: {bsr16_regs}")
    sass_check(info["path"])
    phase("build", t0)

    t0 = time.perf_counter()
    native = native_phase(smi)
    phase("native", t0)

    t0 = time.perf_counter()
    report = kernel_phase(device)
    phase("kernels", t0)

    t0 = time.perf_counter()
    report.update(bf16_kernel_phase(device))
    phase("bf16 kernels", t0)

    t0 = time.perf_counter()
    counts, latency, served, ell_requests = serve_phase(device)
    phase("serve", t0)

    t0 = time.perf_counter()
    profile_phase(served)
    phase("profile", t0)

    t0 = time.perf_counter()
    backward_phase(device)
    phase("backward", t0)

    # before the export phase: once torch.export has run in the process, the
    # profiler loses some of a trace's kernel records (16-22 of 3,412 on an H100)
    t0 = time.perf_counter()
    jprof_counts, jprof = jax_profile_phase(device, smi)
    phase("jax-profile train", t0)

    t0 = time.perf_counter()
    export_counts, exported = export_phase(device, smi, served, ell_requests)
    for kname in ("ell_matmul", "ell_matmul_bf16"):
        if export_counts[kname] == 0:
            raise AssertionError(f"{kname} was not launched inside the exported artifacts")
    phase("export", t0)

    t0 = time.perf_counter()
    from surfacenetworks_tpu_torch.data import datasets

    faust_data = datasets.synthetic_correspondence_dataset(**FAUST_DATA)
    log(f"  FAUST data: {len(faust_data)} synthetic scans of {[s['V'].shape[0] for s in faust_data]} vertices; made in "
        f"{time.perf_counter() - t0:.2f} s")
    train_counts, trained = train_phase(device, smi, faust_data)
    phase("train", t0)

    t0 = time.perf_counter()
    fzoo_counts, fzoo = faust_zoo_phase(device, smi, faust_data)
    for kname in ("bsr_matmul", "ell_matmul", "sddmm"):
        if fzoo_counts[kname] == 0:
            raise AssertionError(f"{kname} was not launched on the faust zoo's paths")
    phase("faust zoo train", t0)

    t0 = time.perf_counter()
    pipe_counts, pipe = host_pipeline_phase(device, smi, faust_data)
    if pipe_counts["ell_matmul"] == 0:
        raise AssertionError("ell_matmul was not launched on the host pipeline's paths")
    phase("host pipeline", t0)

    t0 = time.perf_counter()
    preset_counts, presets = presets_phase(device, smi)
    if preset_counts["ell_matmul"] == 0:
        raise AssertionError("ell_matmul was not launched on the presets' paths")
    phase("presets", t0)

    t0 = time.perf_counter()
    normal_counts, normal = normal_phase(device, smi)
    phase("normal train", t0)

    t0 = time.perf_counter()
    dirac = dirac_phase(device, smi)
    phase("dirac train", t0)

    t0 = time.perf_counter()
    zoo = zoo_phase(device, smi)
    phase("zoo train", t0)

    t0 = time.perf_counter()
    cascade_counts, cascade = cascade_phase(device, smi)
    phase("cascade train", t0)

    t0 = time.perf_counter()
    rotate_counts, rotate = rotate_phase(device, smi, normal["ell"]["loss"][0])
    phase("rotate train", t0)

    t0 = time.perf_counter()
    tier_counts, tiers = tiers_phase(device, smi)
    phase("tiers train", t0)

    t0 = time.perf_counter()
    arap_counts, arap = arap_phase(device, smi)
    phase("arap train", t0)

    t0 = time.perf_counter()
    mesh_samples = datasets.synthetic_mnist_dataset(**MNIST_DATA)
    log(f"  mesh-MNIST data: {len(mesh_samples)} height fields of "
        f"{sorted({s['V'].shape[0] for s in mesh_samples})} vertices and "
        f"{min(s['F'].shape[0] for s in mesh_samples)}-{max(s['F'].shape[0] for s in mesh_samples)} faces; made in "
        f"{time.perf_counter() - t0:.2f} s")
    mnist_counts, mnist = mesh_phase("mnist", device, smi, mesh_samples)
    phase("mnist train", t0)

    t0 = time.perf_counter()
    vae_counts, vae = mesh_phase("vae", device, smi, mesh_samples)
    phase("vae train", t0)

    t0 = time.perf_counter()
    fp32_runs = {"faust ell": trained["ell"], "faust bsr": trained["bsr"], "normal bsr": normal["bsr"],
                 "arap ell": arap["ell"], "mnist ell": mnist["ell"], "mnist dense": mnist["dense"], "vae ell": vae["ell"],
                 "mnist dirac": mnist["dirac"]}
    bf16_counts, bf16 = bf16_train_phase(device, smi, faust_data, mesh_samples, fp32_runs)
    phase("bf16 train", t0)

    t0 = time.perf_counter()
    pre_counts, pre = preprocess_train_phase(device, smi)
    if pre_counts["ell_matmul"] == 0:
        raise AssertionError("ell_matmul was not launched on the preprocessed data's paths")
    phase("preprocess train", t0)

    t0 = time.perf_counter()
    large_counts, large = large_mesh_phase(device, smi)
    for kname in ("bsr_matmul", "bsr_matmul_bf16"):
        if large_counts[kname] == 0:
            raise AssertionError(f"{kname} was not launched on the large-mesh paths")
    phase("large mesh", t0)

    t0 = time.perf_counter()
    dist_counts, dist_rep = dist_phase(device, smi)
    phase("dist", t0)

    t0 = time.perf_counter()
    mh_counts, multihost = multihost_phase(smi)
    phase("multihost", t0)

    replaces = {
        "bsr_matmul": "surfacenetworks_tpu/sparse/pallas_kernels.py:163",
        "ell_matmul": "surfacenetworks_tpu/sparse/pallas_kernels.py:239",
        "sddmm": "surfacenetworks_tpu/sparse/pallas_kernels.py:320",
    }
    # ``launches`` counts the FAUST train path, which runs all three kernels;
    # ``serve_launches`` the serving path, ``normal_train_launches`` the
    # normal trainer's ELL and BSR paths, ``arap_train_launches`` the ARAP
    # trainer's ELL, dense and Dir paths (``arap_batch``: ``ell_matmul`` at
    # the ARAP batch's shape), ``mnist_train_launches`` and
    # ``vae_train_launches`` the mesh-MNIST trainers' dense, ELL and Dirac
    # paths (``mnist_batch``: ``ell_matmul`` at the classifier's batch).  ``ms`` and ``max_abs_err`` are
    # kept under the names ``kernel_ms`` and ``max_err_vs_plain`` too, so
    # readers of either set of names find them.
    entries = []
    for kname in ("bsr_matmul", "ell_matmul", "sddmm"):
        r = report[kname]
        if train_counts[kname] == 0:
            raise AssertionError(f"{kname} was not launched on the train path")
        entries.append({
            "name": kname, "route": "cuda", "source": "surfacenetworks_tpu_torch/sparse/csrc/spmm.cu",
            "replaces": replaces[kname], "launches": train_counts[kname], "serve_launches": counts[kname],
            "normal_train_launches": normal_counts[kname], "arap_train_launches": arap_counts[kname],
            "mnist_train_launches": mnist_counts[kname], "vae_train_launches": vae_counts[kname],
            "zoo_train_launches": sum(r["counts"][kname] for r in zoo.values()),
            "faust_zoo_train_launches": fzoo_counts[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_call": r["library_call"], "max_err_vs_plain": r["max_abs_err"], "kernel_ms": r["ms"],
            "bytes": r["bytes"], "flops": r["flops"], "card": smi, "cold_ms": r["cold_ms"],
            "registers": {k: v.get("registers") for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS[kname])},
            "spill_bytes": {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                            for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS[kname])},
        })
        if kname == "bsr_matmul":
            entries[-1].update(fp32_fma_bound_ms=r["fp32_fma_bound_ms"], fp32_fma_bound_by=r["fp32_fma_bound_by"])
        if kname == "ell_matmul":
            entries[-1].update(export_launches=export_counts[kname], host_pipeline_launches=pipe_counts[kname],
                               preset_train_launches=preset_counts[kname], export_host_us=exported["host_us"],
                               artifacts=exported["artifacts"])
            entries[-1].update(cascade_train_launches=cascade_counts["fp32"][kname],
                               rotate_train_launches=rotate_counts[kname], tiers_train_launches=tier_counts[kname],
                               tiers_launches_by_rows=tiers["launches_by_tier"])
            entries[-1]["normal_cascade_levels"] = [{**{k: v for k, v in r.items() if k != "bf16"},
                                                     "registers": entries[-1]["registers"]}
                                                    for r in cascade["kernel"]["levels"]]
            entries[-1]["normal_cascade_levels_batched"] = [{k: v for k, v in r.items() if k != "bf16"}
                                                            for r in cascade["kernel"]["levels_batched"]]
            entries[-1]["arap_batch"] = {k: v for k, v in arap["ell"]["kernel"].items() if k != "bf16"}
            entries[-1]["arap_rollout_launches"] = arap["ell"]["rollout"]["launches"][kname]
            entries[-1]["mnist_batch"] = {k: v for k, v in mnist["ell"]["kernel"].items() if k != "bf16"}
            amp = fzoo["amp"]["kernel"]
            entries[-1]["faust_amp_levels"] = amp["levels"]
            entries[-1]["faust_amp_levels_batched"] = {k: v for k, v in amp["levels_batched"].items() if k != "bf16"}
        if kname == "sddmm":
            entries[-1]["faust_amp_pattern"] = fzoo["amp"]["kernel"]["sddmm"]
        if kname == "ell_matmul":
            entries[-1].update(preprocess_train_launches=pre_counts[kname], jax_profile_train_launches=jprof_counts[kname])
        if kname in ("bsr_matmul", "ell_matmul"):
            # per rank, summed over the ranks: GP ELL and BSR interiors, DP normal and ARAP
            entries[-1]["dist_train_launches"] = dist_counts[kname]
            # the --multihost processes (one rank each), summed
            entries[-1]["multihost_launches"] = mh_counts[kname]
        if kname == "ell_matmul":
            entries[-1]["partition_local"] = dist_rep["ranks"][0]["apply"]["ell"]["local"]
            entries[-1]["partition_local_bsr_boundary"] = dist_rep["ranks"][0]["apply"]["bsr"]["local"]["boundary"]
        if kname == "bsr_matmul":
            entries[-1]["large_mesh_launches"] = large_counts[kname]
            entries[-1]["large_mesh_max_abs_err"] = {label: r["kernel_max_abs_err"] for label, r in large.items()
                                                     if "fp32" in label}
    # the bf16 variants (--bf16): ``launches`` counts the bf16 FAUST runs (both
    # formats), which launch all three; the other bf16 runs' counts beside it
    faust16 = {k: bf16_counts["faust ell"][k] + bf16_counts["faust bsr"][k] for k in port_kernels.launches}
    for kname in ("bsr_matmul_bf16", "ell_matmul_bf16", "sddmm_bf16"):
        r = report[kname]
        if faust16[kname] == 0:
            raise AssertionError(f"{kname} was not launched on the bf16 train path")
        entries.append({
            "name": kname, "route": "cuda", "source": "surfacenetworks_tpu_torch/sparse/csrc/spmm.cu",
            "replaces": replaces[kname[:-5]], "launches": faust16[kname],
            "bf16_run_launches": {run: c[kname] for run, c in bf16_counts.items()},
            "zoo_train_launches": sum(r["counts"][kname] for r in zoo.values()),
            "faust_zoo_train_launches": fzoo_counts[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "library_call": r["library_call"],
            "bytes": r["bytes"], "flops": r["flops"], "card": smi, "cold_ms": r["cold_ms"],
            "registers": {k: v.get("registers") for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS[kname])},
            "spill_bytes": {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                            for k, v in registers.items() if k.startswith(KERNEL_SYMBOLS[kname])},
        })
        if kname == "bsr_matmul_bf16":
            entries[-1].update({k: r[k] for k in ("ms_x_fp32", "ms_no_live", "ms_x_fp32_no_live", "cold_ms_no_live",
                                                  "bound_ms_no_live", "bound_by_no_live", "bytes_no_live",
                                                  "flops_no_live", "live_chunks", "chunks")})
        if kname == "bsr_matmul_bf16":
            entries[-1]["large_mesh_launches"] = large_counts[kname]
            entries[-1]["large_mesh_max_abs_err"] = {label: r["kernel_max_abs_err"] for label, r in large.items()
                                                     if "bf16" in label}
        if kname == "ell_matmul_bf16":
            entries[-1]["export_launches"] = export_counts[kname]
            entries[-1]["cascade_train_launches"] = cascade_counts["bf16"][kname]
            entries[-1]["normal_cascade_levels"] = [
                {**r["bf16"], "level": r["level"], "registers": entries[-1]["registers"]}
                for r in cascade["kernel"]["levels"]]
            entries[-1]["fp32_kernel_ms"] = r["fp32_kernel_ms"]
            entries[-1]["arap_batch"] = arap["ell"]["kernel"]["bf16"]
            entries[-1]["mnist_batch"] = mnist["ell"]["kernel"]["bf16"]
    log(f"serve median ms per request: ell {latency['ell']['median_ms']:.3f}, "
        f"bsr {latency['bsr']['median_ms']:.3f} ({smi})")
    log("train median per step: " + ", ".join(
        f"{fmt} device {r['device_ms_median']:.3f} ms, wall {r['wall_ms_median']:.3f} ms"
        for fmt, r in trained.items()) + f" ({smi})")
    log("faust zoo train median per step: " + ", ".join(
        f"{label} wall {r['wall_ms_median']:.3f} ms, device {r['device_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms in "
        f"{r['device_ops']} device ops, idle share {r['idle_share']:.3f}, peak {r['peak_mib']:.1f} MiB"
        for label, r in fzoo.items()) + f" ({smi})")
    log("normal train median per step: " + ", ".join(
        f"{fmt} device {r['device_ms_median']:.3f} ms, wall {r['wall_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms, "
        f"idle share {r['idle_share']:.3f}" for fmt, r in normal.items()) + f" ({smi})")
    log(f"dirac train median per step: device {dirac['device_ms_median']:.3f} ms, wall {dirac['wall_ms_median']:.3f} ms, "
        f"busy {dirac['busy_ms']:.3f} ms in {dirac['device_ops']} device ops, idle share {dirac['idle_share']:.3f}, "
        f"Dirac applies {dirac['range_ms']:.4f} ms ({dirac['apply_share']:.1%} of busy), peak "
        f"{dirac['peak_mib']:.1f} MiB ({smi})")
    log("zoo train median per step: " + ", ".join(
        f"{label} wall {r['wall_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms in {r['device_ops']} device ops, idle "
        f"share {r['idle_share']:.3f}, peak {r['peak_mib']:.1f} MiB"
        + (f", attends {r['attend_share']:.1%} of busy" if "attend_share" in r else "") for label, r in zoo.items())
        + f" ({smi})")
    log("cascade train median per step: " + ", ".join(
        f"{label} wall {r['wall_ms_median']:.3f} ms, device {r['device_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms "
        f"in {r['device_ops']} device ops, idle share {r['idle_share']:.3f}, peak {r['peak_mib']:.1f} MiB"
        for label, r in (("fp32", cascade["fp32"]), ("bf16", cascade["bf16"]))) + f" ({smi})")
    log(f"rotate train median per step: wall {rotate['wall_ms_median']:.3f} ms, device "
        f"{rotate['device_ms_median']:.3f} ms, busy {rotate['busy_ms']:.3f} ms in {rotate['device_ops']} device ops, "
        f"idle share {rotate['idle_share']:.3f}, peak {rotate['peak_mib']:.1f} MiB ({smi})")
    log("tiers train median per step: " + ", ".join(
        f"{t} rows wall {r['wall_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms in {r['device_ops']} device ops, idle "
        f"share {r['idle_share']:.3f}, peak {r['peak_mib']:.1f} MiB" for t, r in tiers["per_tier"].items())
        + f" ({smi})")
    log("arap train median per step: " + ", ".join(
        f"{cfg} device {r['device_ms_median']:.3f} ms, wall {r['wall_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms "
        f"in {r['device_ops']} device ops, idle share {r['idle_share']:.3f}, peak {r['peak_mib']:.1f} MiB"
        for cfg, r in arap.items()) + f" ({smi})")
    for family, runs in (("mnist", mnist), ("vae", vae)):
        log(f"{family} train median per step: " + ", ".join(
            f"{cfg} device {r['device_ms_median']:.3f} ms, wall {r['wall_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} "
            f"ms in {r['device_ops']} device ops, idle share {r['idle_share']:.3f}, peak {r['peak_mib']:.1f} MiB"
            + (f", Dirac applies {r['apply_share']:.1%} of busy" if cfg == "dirac" else "")
            for cfg, r in runs.items() if cfg != "dense_equals_ell")
            + f"; dense and ELL losses {'bit-identical' if runs['dense_equals_ell'] else 'differ'} ({smi})")
    log("bf16 train median per step: " + ", ".join(
        f"{label} wall {r['wall_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms in {r['device_ops']} device ops, idle "
        f"share {r['idle_share']:.3f}, peak {r['peak_mib']:.1f} MiB" for label, r in bf16.items()) + f" ({smi})")
    log("export: " + ", ".join(
        f"{label} busy {r['busy_ms']:.3f} ms (eager {r['eager_busy_ms']:.3f}), CUDA-event {r['device_ms']:.3f} ms "
        f"(eager {r['eager_device_ms']:.3f}), {r['bytes']} bytes, "
        f"{'bit-identical' if r['bit_equal'] else 'DIFFERS'}" for label, r in exported["artifacts"].items())
        + f"; host us per eager ell_matmul direct {exported['host_us']['direct']}, through the op "
        f"{exported['host_us']['op']} ({smi})")
    log("host pipeline median per step: " + ", ".join(
        f"{label} wall {r['wall_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
        f"peak {r['peak_mib']:.1f} MiB" + (f", {r['bytes_per_step'][0]} bytes uploaded a step" if "bytes_per_step" in r
                                          else "")
        for label, r in pipe.items()) + f" ({smi})")
    log("presets median per step: " + ", ".join(
        f"{label} wall {r['wall_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms in {r['device_ops']} device ops, "
        f"idle share {r['idle_share']:.3f}, peak {r['peak_mib']:.1f} MiB" for label, r in presets.items())
        + f" ({smi})")
    log("native host ms (native / NumPy): " + ", ".join(
        f"{k} {r['native_ms']:.3f} / {r['numpy_ms']:.3f}" for k, r in native.items() if isinstance(r, dict))
        + f" ({smi})")
    log("preprocess wall s: " + ", ".join(f"{k} {v:.2f}" for k, v in pre["preprocess_s"].items())
        + f"; preprocessed runs median per step: " + ", ".join(
        f"{label} wall {r['wall_ms_median']:.3f} ms, busy {r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
        f"peak {r['peak_mib']:.1f} MiB" for label, r in pre["runs"].items()) + f" ({smi})")
    log("large mesh forward+backward: " + ", ".join(
        f"{label} busy {r['busy_ms']:.3f} ms, device {r['device_ms']:.3f} ms, peak {r['peak_mib']:.1f} MiB"
        + (f" (no remat: busy {r['plain']['busy_ms']:.3f} ms, peak {r['plain']['peak_mib']:.1f} MiB)" if "plain" in r
           else "") for label, r in large.items()) + f" ({smi})")
    for rank in dist_rep["ranks"]:
        log(f"dist rank {rank['rank']} ({rank['backend']} on one card, not NCCL): " + ", ".join(
            f"{label} wall {r['wall_ms_median']:.3f} ms, CUDA-event {r['device_ms_median']:.3f} ms, busy "
            f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, a step's exchange {r['exchange']['rows']} rows "
            f"{r['exchange']['bytes']} bytes {r['exchange']['host_s'] * 1e3:.3f} host ms"
            for label, r in rank.items() if label.startswith(("gp", "dp"))) + f" ({smi})")
    log("multihost: " + ", ".join(
        f"{label} " + (f"losses within {max(r['loss_rel']):.2e} of the one-launch fast path" if "loss_rel" in r else
                       f"{'bit-identical to' if r['bit_equal'] else 'DIFFERS from'} the one-launch run")
        + f" (processes {r['seconds']['p0']:.1f} / {r['seconds']['p1']:.1f} s)" for label, r in multihost.items())
        + f"; two processes on one card over gloo, NCCL across hosts not exercised ({smi})")
    log(f"dist NCCL: one rank, {dist_rep['nccl']['backend']} {dist_rep['nccl']['nccl']}, a DP step with all_reduce "
        f"and broadcast on the card; cross-card collectives and peer-to-peer not exercised ({smi})")
    log(f"--jax-profile: {jprof['ell_spmm_kernel_events']} ell_spmm_kernel events in {jprof['trace_bytes']} bytes, "
        f"the port's kernels in the trace equal to the traced epoch's launch counters ({smi})")
    gaps = [g for g in PROFILE_GAPS if g["gap"]]
    log(f"profiler vs launch counters: {len(PROFILE_GAPS)} profiled regions, "
        f"{sum(g['launched'] for g in PROFILE_GAPS)} port-kernel launches counted in them, "
        f"{sum(g['traced'] for g in PROFILE_GAPS)} in their traces; {len(gaps)} regions with a gap"
        + "".join(f"; {g['where']}: {g['gap']}" for g in gaps))
    log(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
