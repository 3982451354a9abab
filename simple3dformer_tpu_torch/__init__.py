"""simple3dformer_tpu_torch — the PyTorch and CUDA port of simple3dformer_tpu.

The JAX package beside it is the reference: each module here has its
counterpart at the same path there, and the tests hold the two against each
other. This package imports torch and never jax.

Layout (mirrors simple3dformer_tpu):
  core/      rng (seed 9), checkpointing over torch.save, task configs; host_build.py
             compiles the host C++ libraries with g++ at first use
  nn/        ViT layers, BatchNorm, backbone tables, voxel tokenizers,
             set abstraction and feature propagation, vector attention
  kernels/   hand-written CUDA kernels for Hopper, each beside its plain
             PyTorch version; build.py compiles csrc/ with nvcc at first use
  csrc/      CUDA C++ sources
  ops/       point-cloud primitives (FPS, kNN, gathers, grouping)
  models/    VoxelViT, PointViT (3DViT family), the Hengshuang Point
             Transformer (cls and seg)
  train/     Adam, SGD and LR schedules, train/eval steps, metrics, health check
  cli/       the trainers (train_cls_voxel, train_partseg, train_s3dis_semseg,
             train_cls)
  serve/     fixed-batch Predictor and the stdlib HTTP server
  utils/     JAX parameter trees -> the port's state dicts
  data/      synthetic inputs, binvox, voxel, ModelNet40 point, ShapeNetPart and
             S3DIS readers, class maps, point augmentations, the
             device-resident dataset; native_ingest/, the C++ bulk binvox decode
  tools/     host data tools: mesh -> binvox voxelizer, voxel viewer, fixed-view
             renders, the S3DIS collector and block/sample/export helpers
"""
