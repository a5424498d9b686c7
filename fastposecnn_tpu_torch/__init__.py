"""PyTorch/CUDA port of `fastposecnn_tpu` for one NVIDIA H100.

The JAX package `fastposecnn_tpu` is the reference this package is held
against; nothing here imports it (or JAX). Modules mirror its layout:

  models/      ResNet18/34/50-FPN network in NCHW (torch state_dict layout)
  ops/         class compression, connected components, aggregation,
               RANSAC, soft and vanishing-point voting
  kernels/     hand-written CUDA C++ kernels (built by plain nvcc, bound
               with ctypes) that replace the two Pallas kernels
  pipeline.py  the post-network stages of the INFERENCE preset
  serve.py     `InferenceServer`, the counterpart of __graft_entry__.entry()

Entry points run on the GPU unless the caller passes `device="cpu"`.
"""
