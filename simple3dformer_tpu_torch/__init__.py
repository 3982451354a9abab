"""simple3dformer_tpu_torch — the PyTorch and CUDA port of simple3dformer_tpu.

The JAX package beside it is the reference: each module here has its
counterpart at the same path there, and the tests hold the two against each
other. This package imports torch and never jax.

Layout (mirrors simple3dformer_tpu):
  core/      rng (seed 9) and checkpointing over torch.save
  nn/        ViT layers, backbone tables, voxel tokenizers
  kernels/   hand-written CUDA kernels for Hopper, each beside its plain
             PyTorch version; build.py compiles csrc/ with nvcc at first use
  csrc/      CUDA C++ sources
  models/    VoxelViT, frozen_mask
  train/     Adam and LR schedules, train/eval steps, metrics, health check
  cli/       the trainer (train_cls_voxel)
  serve/     fixed-batch Predictor and the stdlib HTTP server
  utils/     JAX parameter trees -> the port's state dicts
  data/      synthetic inputs, binvox and voxel dataset readers, class maps,
             the device-resident dataset
"""
