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
drives twelve paths, each with the launch counts set to 0 just before it and
read just after:

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
  compared.

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
# data, widths and depth as the train phase (TRAIN_ARGS on FAUST_DATA:
# width 128, 120-d features, 15 layers, --smooth-reg 0.1, --xz-rotate),
# FAUST_ZOO_STEPS updates and the test pass per run, each run repeated from
# its start bit for bit.  Per run (operator format, flags): the amp trunk on
# the squared-Laplacian pyramid (every level packed at the pyramid's widest
# row, K=125 on these scans); the dir, avg and mlp trunks (``auto``: the
# Dirac tables for dir, BSR over RCM order for avg, which reads no
# operator; mlp in ELL); the sl1 and cel losses (lap, full logits); the lap trunk in
# ELL and BSR with and without --remat; --intrinsic; and the light path
# forced through ``_FORCE_LIGHT``.  Launches per step: the trunk's applies
# (16 per trunk forward, 32 with --remat's recompute, two trunks, forward
# and backward) plus the smoothness terms' 2 SDDMMs and their backward's 4
# ELL sums, plus the streaming dcel head's mirror (1; sl1 and cel have the
# full-logits head and no mirror).  A test pair runs the forward: 32
# applies where the trunk reads an operator; the light path skips the test
# pass.  --remat and the light path must give their plain runs' losses and
# weights bit for bit; step 0 of amp and dir is held against fp64 module by
# module with the train phase's bounds.
FAUST_ZOO_STEPS = 4
FAUST_ZOO_RUNS = {
    "amp": ("ell", ("--model", "amp")), "dir": ("auto", ("--model", "dir")),
    "avg": ("auto", ("--model", "avg")), "mlp": ("ell", ("--model", "mlp")),
    "sl1": ("ell", ("--loss", "sl1")), "cel": ("ell", ("--loss", "cel")),
    "lap ell": ("ell", ()), "remat ell": ("ell", ("--remat",)),
    "lap bsr": ("bsr", ()), "remat bsr": ("bsr", ("--remat",)),
    "intrinsic": ("ell", ("--intrinsic",)), "light": ("ell", ()),
}
FAUST_ZOO_PER_STEP = {
    **{k: launches_of(ell_matmul=64 + 4 + 1, sddmm=2) for k in ("amp", "lap ell", "intrinsic", "light")},
    **{k: launches_of(ell_matmul=4 + 1, sddmm=2) for k in ("dir", "avg", "mlp")},
    **{k: launches_of(ell_matmul=64 + 4, sddmm=2) for k in ("sl1", "cel")},
    "remat ell": launches_of(ell_matmul=96 + 4 + 1, sddmm=2),
    "lap bsr": launches_of(bsr_matmul=64, ell_matmul=5, sddmm=2),
    "remat bsr": launches_of(bsr_matmul=96, ell_matmul=5, sddmm=2),
}
FAUST_ZOO_PER_TEST = {k: launches_of(**({"bsr_matmul": 32} if k.endswith("bsr") else {"ell_matmul": 32}))
                      for k in FAUST_ZOO_RUNS}
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
# the card the chain read 2.4e-6 and the parameters 2.1e-6, the detached
# mutant's chain 8.5e2; the fp64 replay read about 1.0 for the real step
# and the mutant alike, and all 128 channels of the six level-2 blocks
# overflow (PERF.md, section 6).
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
# and widths (LapDeepModel's WIDTH 128, depth 15, batch 1, ~7,000-vertex
# meshes) with --model gat (8 GatResNet2 blocks of 4 heads and 7 Avg
# blocks; ELL over RCM order, whatever the format flag says; here with
# --flip-variants 1, so 4 more train meshes), avg, mlp and id, 4 updates
# and the test pass each, and gat with --bf16.  None of them launches a
# kernel: GAT's attention is plain PyTorch (one gather of [R*K, H*ch + H]
# payload rows, a masked softmax over the K slots) and the other three read
# no operator.  Step 0 of each run against fp64 module by module with the
# normal phase's bounds (GAT's fp64 reference attends over the same ELL
# pattern; the bf16 run's modules too, from its bf16 inputs), the parameters
# that are zero in exact arithmetic by size (ZOO_NULL_GRADS); a GAT whose
# attends return detached outputs must fail that check.  On the card the
# fp32 runs' chain read at most 6.2e-6 and their parameter gradients 9.0e-5,
# the bf16 GAT run's 5.4e-3 and 0.28 (bf16 rounding in batch-norm bias
# gradients whose rows cancel), the detached attends' chain 0.75 (PERF.md,
# section 6).
ZOO_STEPS = 4
ZOO_ARGS = ["--synthetic", "5", "--synthetic-points", "7000", "--seed", "0", "--layer", str(LAYERS),
            "--batch-size", "1", "--num-updates", str(ZOO_STEPS), "--num-epoch", "1", "--device", "cuda"]
ZOO_RUNS = {"gat": ["--model", "gat", "--flip-variants", "1"], "avg": ["--model", "avg"], "mlp": ["--model", "mlp"],
            "id": ["--model", "id"], "gat bf16": ["--model", "gat", "--bf16"]}
# Zero in exact arithmetic: MlpModel passes a per-channel constant through
# every block unchanged (batch norms remove it, residuals carry it) to its
# final batch norm, which removes it, so conv1's bias and every block's
# fc biases are; IdDeepModel's last block output reaches only conv2's 'pre'
# batch norm, so its last conv's biases are.
ZOO_NULL_GRADS = {
    "mlp": {"conv1.fc.bias"} | {f"rn{i}.fc{j}.fc.bias" for i in range(LAYERS) for j in (0, 1)},
    "id": {f"rn{LAYERS - 1}.bn_fc1.fc.bias", f"rn{LAYERS - 1}.bn_fc1.bn.bias"},
}
GAT_RANGE = "gat attend"  # the profiler range around each attend's forward in the profiled step
GAT_ATTENDS = 2 * ((LAYERS + 1) // 2)  # two a GAT block, GAT blocks on even layers
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


def serve_phase(device) -> tuple[dict, dict, dict]:
    """Serve LapDeepModel-15 on four ~7,000-vertex requests in both formats;
    returns the kernels' launch counts from that run, the latencies, and
    (server, first prepared request) per format."""
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
    return counts, latency, {fmt: (s, prepared[fmt][0]) for fmt, s in servers.items()}


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


def profile_phase(served: dict) -> dict:
    """Where one forward's time goes: host wall time of a synchronised
    forward, and the device time of its kernels from ``torch.profiler``
    (events on the device only: the host operators that launch them carry
    the same time again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for fmt, (server, req) in served.items():
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.answer(req)
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            server.answer(req)
        rows = device_rows(prof)
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


def _model(state0, device, dtype, model: str = "lap"):
    from surfacenetworks_tpu_torch.models import SiameseModel

    model = SiameseModel(model, LAYERS)
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

    model = _model(state0, trainer.device, dtype, trainer.args.model)
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
                   null=frozenset(), outputs: bool = False) -> dict:
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
    gradient``), the chain's (outputs and cotangents) do not."""
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
    return errs
def judge_step0(what: str, runs: dict, bounds: dict, res: dict) -> list[str]:
    """The module-wise verdict on step 0.  ``runs`` maps "real" and each
    mutant's label to their errors against fp64; each run's errors fall in
    the chain (the loss and the cotangents), the parameter gradients and,
    where there are any, the null gradients (``... null gradient``), and
    each group's worst is held to its bound in ``bounds``.  Logs each run,
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
        log(f"  {what} {label}: module-wise vs fp64: {loss_key} rel {errs[loss_key]:.3e}; chain ({len(groups['chain'])}) "
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

    model = _model(state0, trainer.device, torch.float32, trainer.args.model)
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
                    **replay_modules(cap, grads, _model(state0, trainer.device, torch.float64, trainer.args.model).trunk,
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
                frun, state0, restore = faust_run(fmt, data, FAUST_ZOO_STEPS, extra)
            finally:
                tc._FORCE_LIGHT = False
            trainer = frun.t
            log(f"  faust {label}: trunk {type(trainer.model.trunk).__name__}, operator {trainer.model_key}, format "
                f"{trainer.fmt}, bucket {trainer.N}, ell_k {trainer.buckets.ell_k}, loss {trainer.args.loss}, "
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
                    failures += plain_step0_check("faust amp", res, _model(state0, device, torch.float32, "amp").trunk,
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
    host = tc.main(TRAIN_ARGS + ["--operator-format", "ell", *FAUST_ZOO_RUNS["amp"][1], "--eval-only",
                                 "--deser-option", "auto", "--deser-path", ckpt, "--result-dir", tmp])["eval"]
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


def _sampler_like(saved, samples):
    """A copy of the sampler ``saved`` (order, position, random state) over
    ``samples``, a trainer's own sample dicts, matched by name: the device
    dataset finds a sample by the object.  A ``TieredSampler`` is copied
    tier by tier, with its own draw's state."""
    if hasattr(saved, "samplers"):
        out = copy.copy(saved)
        out.samplers = {k: _sampler_like(v, samples) for k, v in saved.samplers.items()}
        out.rng = copy.deepcopy(saved.rng)
        return out
    by_name = {s["name"]: s for s in samples}
    out = copy.copy(saved)
    out.items = [by_name[s["name"]] for s in saved.items]
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
    return samples, [s["name"] for s in samples]


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
    from torch.profiler import ProfilerActivity, profile

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
            with ranges, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
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
        log(f"  zoo {label}: {type(trainer.model).__name__}-{LAYERS}, format {trainer.fmt}, bucket "
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
    from surfacenetworks_tpu_torch.sparse import BsrOperator, DiracOperator, EllOperator

    return isinstance(a, (EllOperator, BsrOperator, DiracOperator))


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
    report = kernel_phase(device)
    phase("kernels", t0)

    t0 = time.perf_counter()
    report.update(bf16_kernel_phase(device))
    phase("bf16 kernels", t0)

    t0 = time.perf_counter()
    counts, latency, served = serve_phase(device)
    phase("serve", t0)

    t0 = time.perf_counter()
    profile_phase(served)
    phase("profile", t0)

    t0 = time.perf_counter()
    backward_phase(device)
    phase("backward", t0)

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
            entries[-1].update(cascade_train_launches=cascade_counts["fp32"][kname],
                               rotate_train_launches=rotate_counts[kname], tiers_train_launches=tier_counts[kname],
                               tiers_launches_by_rows=tiers["launches_by_tier"])
            entries[-1]["normal_cascade_levels"] = [{**{k: v for k, v in r.items() if k != "bf16"},
                                                     "registers": entries[-1]["registers"]}
                                                    for r in cascade["kernel"]["levels"]]
            entries[-1]["normal_cascade_levels_batched"] = [{k: v for k, v in r.items() if k != "bf16"}
                                                            for r in cascade["kernel"]["levels_batched"]]
            entries[-1]["arap_batch"] = {k: v for k, v in arap["ell"]["kernel"].items() if k != "bf16"}
            entries[-1]["mnist_batch"] = {k: v for k, v in mnist["ell"]["kernel"].items() if k != "bf16"}
            amp = fzoo["amp"]["kernel"]
            entries[-1]["faust_amp_levels"] = amp["levels"]
            entries[-1]["faust_amp_levels_batched"] = {k: v for k, v in amp["levels_batched"].items() if k != "bf16"}
        if kname == "sddmm":
            entries[-1]["faust_amp_pattern"] = fzoo["amp"]["kernel"]["sddmm"]
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
        if kname == "ell_matmul_bf16":
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
    log(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
