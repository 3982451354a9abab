"""Offline data tools (port of simple3dformer_tpu/tools): host work only, no
device. Each runs as ``python -m simple3dformer_tpu_torch.tools.<name>``:
``voxelize`` (meshes to binvox), ``view_voxels`` (a binvox grid to an
image), ``save_render`` (fixed-view renders of a ShapeNet tree),
``collect_s3dis`` (S3DIS annotations to per-room arrays) and
``indoor3d_blocks`` (S3DIS rooms to blocks and samples, OBJ and bounding-box
exports; a library, no command line). The C++ voxelizer and viewer build
with g++ into build/host/ on first use (core/host_build.py)."""
