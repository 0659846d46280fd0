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
                                  scipy pair, vertex normals, permutations,
                                  ``uniform_mesh_scale``)
``geometry/io.py``                ``geometry/io.py`` (OBJ and ascii PLY)
``data/datasets.py``              ``data/datasets.py`` (``random_blob_mesh``,
                                  ``synthetic_normal_dataset``,
                                  ``synthetic_correspondence_dataset``,
                                  ``synthetic_arap_sequences``,
                                  ``load_faust_npz``, ``load_normal_sample``,
                                  ``scan_mesh_tree``, ``load_normal_npz``
                                  with Dirac samples, ``load_arap_sequence``,
                                  ``height_field_mesh``,
                                  ``synthetic_mnist_dataset``,
                                  ``load_mnist_mesh_pickle``)
``data/batching.py``              ``data/batching.py`` (buckets, RCM, BSR slot
                                  fit, Dirac packing, ``laplacian_batch``,
                                  ``dirac_batch``, ``correspondence_batch``,
                                  ``arap_batch``, ``mnist_batch``,
                                  ``vae_batch``)
``data/pipeline.py``              ``data/pipeline.py`` (pack-once samples,
                                  ``DeviceDataset`` keyed by object or
                                  value, ``IndexedBatch``; a batch's
                                  ``aux`` carried through)
``sparse/ell.py``                 ``sparse/ell.py`` (``EllMatrix``, packing,
                                  ``DiracOperator``, ``dirac_from_coeffs``)
``sparse/bsr.py``                 ``sparse/bsr.py`` (``BsrMatrix``, RCM, packing)
``sparse/ops.py``                 ``sparse/ops.py`` + apply half of ``sparse/bsr.py``
                                  (autograd Functions: ``spmm``, ``bsr_spmm``,
                                  ``sddmm``, ``dirac_apply_vf``/``fv``)
``sparse/kernels.py``             ``sparse/pallas_kernels.py`` (``bsr_matmul``,
                                  ``ell_matmul``, ``sddmm``; fp32 and bf16
                                  variants)
``sparse/csrc/spmm.cu``           the Pallas kernels' bodies, as CUDA for sm_90a
``sparse/_build.py``              (new) nvcc build + ctypes binding
``nn/layers.py``                  ``nn/layers.py``
``nn/blocks.py``                  ``nn/blocks.py`` (Lap/Avg/Mlp/Dirac blocks)
``models/normal_models.py``       ``models/normal_models.py`` (``LapDeepModel``,
                                  ``DirDeepModel``, ``DirModelToFace``)
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
``cli/common.py``                 ``cli/common.py`` (log, metrics and config
                                  files, ``EpochSampler``, ``Throughput``)
``cli/train_normal.py``           ``cli/train_normal.py`` (single-device
                                  ``--model lap`` and ``dirac`` paths)
``cli/train_correspondence.py``   ``cli/train_correspondence.py`` (single-device
                                  Lap/dcel path)
``cli/train_arap.py``             ``cli/train_arap.py`` (single-device path,
                                  five models, ELL and ``--dense``)
``cli/train_mnist.py``            ``cli/train_mnist.py`` (single-device path,
                                  ``lap avg mlp dirac``)
``cli/train_vae.py``              ``cli/train_vae.py`` (single-device path,
                                  ``lap dirac``, ``--dump-ply``)
``convert.py``                    (new) flax params -> ``state_dict``, optax
                                  state -> optimizer ``state_dict``
``serve.py``                      ``serve.py`` + ``cli/export_model.py``
                                  (``NormalServer``)
================================  =================================================
"""
