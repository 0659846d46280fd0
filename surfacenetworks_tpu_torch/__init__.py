"""surfacenetworks_tpu_torch: Surface Networks in PyTorch with hand-written CUDA kernels.

The PyTorch and CUDA port of ``surfacenetworks_tpu`` (JAX/Flax/Pallas), which
stays beside it as the reference.  This package imports torch, numpy and
scipy, and nothing of jax, flax, optax or ``surfacenetworks_tpu``; what it
needs from the host side of the JAX package it keeps as its own copy.  Its
entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Mixed precision (the trainers' ``--bf16``) follows the JAX package's
``dtype`` convention: every model and block takes a computation ``dtype``
(``torch.bfloat16``), parameters stay fp32, and each CUDA kernel has a bf16
variant (``sparse/kernels.py``).

Module map (port -> JAX package):

================================  =================================================
``geometry/mesh_ops.py``          ``geometry/mesh_ops.py`` (igl-style and cotan
                                  Laplacians, Dirac coefficients and the
                                  scipy pair, normals, curvatures,
                                  rescalings, permutations)
``geometry/graph_ops.py``,        ``geometry/graph_ops.py``, ``repair.py``
``geometry/repair.py``            (all of them)
``geometry/sampling.py``          ``geometry/sampling.py`` (Poisson disc,
                                  mesh-MNIST meshes from images)
``geometry/spectral.py``          ``geometry/spectral.py`` (eigenpairs, WKS,
                                  HKS)
``geometry/io.py``                ``geometry/io.py`` (OBJ and ascii PLY)
``native/``                       ``native/`` (ctypes bindings of its own
                                  copy of ``csrc/snx_native.cc``, built
                                  with ``g++`` into ``_build/``)
``data/datasets.py``              ``data/datasets.py`` (``random_blob_mesh``,
                                  ``synthetic_normal_dataset``,
                                  ``synthetic_correspondence_dataset``,
                                  ``synthetic_arap_sequences``,
                                  ``load_faust_npz``, ``load_normal_sample``,
                                  ``scan_mesh_tree``, ``load_normal_npz``
                                  with Dirac samples, ``load_arap_sequence``,
                                  ``height_field_mesh``,
                                  ``synthetic_mnist_dataset``,
                                  ``load_mnist_mesh_pickle``,
                                  ``load_mnist_idx``,
                                  ``build_mnist_mesh_dataset``)
``data/batching.py``              ``data/batching.py`` (buckets, RCM, BSR slot
                                  fit, Dirac packing, ``laplacian_batch``,
                                  ``dirac_batch``, ``correspondence_batch``,
                                  ``arap_batch``, ``mnist_batch``,
                                  ``vae_batch``)
``data/pipeline.py``              ``data/pipeline.py`` (``OperatorCache``
                                  with its host budget, pack-once samples
                                  through it, ``DeviceDataset`` keyed by
                                  object or value, ``IndexedBatch``,
                                  ``MetricAccumulator``, ``prefetch`` and
                                  ``prefetch_over`` with pinned,
                                  non-blocking uploads)
``sparse/ell.py``                 ``sparse/ell.py`` (``EllMatrix``, packing,
                                  ``DiracOperator``, ``dirac_from_coeffs``)
``sparse/bsr.py``                 ``sparse/bsr.py`` (``BsrMatrix``, RCM, packing)
``sparse/ops.py``                 ``sparse/ops.py`` + apply half of ``sparse/bsr.py``
                                  (autograd Functions: ``spmm``, ``bsr_spmm``,
                                  ``sddmm``, ``dirac_apply_vf``/``fv``)
``sparse/kernels.py``             ``sparse/pallas_kernels.py`` (``bsr_matmul``,
                                  ``ell_matmul``, ``sddmm``; fp32 and bf16
                                  variants; each a ``torch.library``
                                  custom op ``snx::...`` too)
``sparse/csrc/spmm.cu``           the Pallas kernels' bodies, as CUDA for sm_90a
``sparse/_build.py``              (new) nvcc build + ctypes binding
``nn/layers.py``                  ``nn/layers.py``
``nn/blocks.py``                  ``nn/blocks.py`` (Lap/Avg/Mlp/Dirac blocks)
``models/normal_models.py``       ``models/normal_models.py`` (``LapDeepModel``
                                  with ``remat``, ``DirDeepModel``,
                                  ``DirModelToFace``, the normal zoo)
``models/correspondence.py``      ``models/correspondence.py`` (Lap ``Model``,
                                  ``SiameseModel``)
``models/arap_models.py``         ``models/arap_models.py`` (``Model``,
                                  ``AvgModel``, ``MlpModel``, ``DirModel``,
                                  ``GCNModel``)
``models/mnist_models.py``        ``models/mnist_models.py`` (``Model``,
                                  ``AvgModel``, ``MlpModel``, ``DirModel``)
``models/vae.py``                 ``models/vae.py`` (``LapVAE``, ``DirVAE``
                                  and their encoders and decoders)
``train/losses.py``               ``train/losses.py`` (normal cosine loss and
                                  angle metric, dcel, streaming dcel,
                                  smoothness, FAUST metrics, ARAP
                                  ``smooth_l1_sum``, mesh-MNIST
                                  ``nll_loss``, ``accuracy``, VAE
                                  ``log_normal_diag``, ``vae_elbo_terms``)
``train/optim.py``                ``train/optim.py`` (``adam``, optax's
                                  AMSGrad, ``sgd``, ``epoch_halving_schedule``)
``train/checkpoint.py``           ``train/checkpoint.py`` + ``train/loop.py::
                                  check_finite`` (the port's ``torch.save``
                                  files and the JAX package's flax-msgpack
                                  files)
``train/loop.py``                 ``train/loop.py`` (``TrainState``,
                                  ``make_train_step``, ``make_eval_step``;
                                  ``update``, every trainer's step)
``parallel_context.py``           ``parallel_context.py`` (the sharded axes
                                  as process groups; ``psum``, ``total``,
                                  ``sum_gradients``)
``dist/mesh_setup.py``            ``dist/mesh_setup.py`` (the rank grid,
                                  ``launch``, ``initialize_multihost``)
``dist/data_parallel.py``         ``dist/data_parallel.py`` (``shard_batch``,
                                  ``replicate``, ``make_dp_train_step``)
``dist/edge_partition.py``        ``dist/edge_partition.py`` (row partitions,
                                  halo exchange, ``partitioned_spmm``)
``dist/graph_parallel.py``        ``dist/graph_parallel.py`` (the Laplacian
                                  half: ``prepartition_ell``, placement,
                                  ``GraphStore``)
``train/timing.py``               ``train/timing.py`` (``device_timer``,
                                  ``trace`` over ``torch.profiler``,
                                  ``ThroughputMeter``)
``config.py``                    ``config.py`` (``PRESETS``,
                                  ``--config``/``--preset``,
                                  ``dump_config``)
``cli/common.py``                 ``cli/common.py`` (log and metrics files,
                                  ``log_environment``, ``count_params``,
                                  ``MetricFetcher``, ``EpochSampler``,
                                  ``TieredSampler``, ``Throughput``)
``cli/preprocess.py``             ``cli/preprocess.py`` (``mnist``,
                                  ``normal``, ``arap``: the JAX package's
                                  files)
``cli/launch.py``                 ``cli/launch.py`` (the meta-launcher)
``cli/export_model.py``           ``cli/export_model.py`` (Lap and Dirac
                                  artifacts)
``cli/train_normal.py``           ``cli/train_normal.py`` (every
                                  single-device path, ``--jax-profile``,
                                  ``--data-parallel``, ``--graph-parallel``
                                  with ``lap``)
``cli/train_correspondence.py``   ``cli/train_correspondence.py`` (single-device
                                  paths, the host path past the budget)
``cli/train_arap.py``             ``cli/train_arap.py`` (five models, ELL and
                                  ``--dense``, ``--data-parallel``)
``cli/train_mnist.py``            ``cli/train_mnist.py`` (``lap avg mlp
                                  dirac``, ``--data-parallel``)
``cli/train_vae.py``              ``cli/train_vae.py`` (``lap dirac``,
                                  ``--dump-ply``, ``--data-parallel``)
``convert.py``                    (new) flax params -> ``state_dict``, optax
                                  state -> optimizer ``state_dict``
``serve.py``                      ``serve.py`` (``export_forward``,
                                  ``load``, ``export_info`` over
                                  ``torch.export``; ``NormalServer``)
================================  =================================================
"""
