"""PyTorch + CUDA port of isaac_ros_nvblox_tpu (dense 3D mapping).

The JAX package `isaac_ros_nvblox_tpu` is the reference; this package
computes the same functions with PyTorch tensors and hand-written CUDA
kernels for Hopper (`csrc/`). It imports torch and numpy only.

Slice 1 covers the depth -> TSDF -> ESDF main path:

  core/     voxel layout, transforms, the WorldGrid block allocator
  models/   pinhole camera, analytic scenes + sphere-traced depth
  ops/      view test, TSDF fusion (kernel `tsdf_fuse`), ESDF sites and
            the exact banded EDT (kernels `edt_pass1`, `edt_pass`)
  mapper/   DeviceMapper (integrate_depth / update_esdf / replay_frames)
  kernels   nvcc build + ctypes binding of the CUDA sources

Entry points run on `cuda` unless the caller passes `device="cpu"`; kernel
wrappers follow the device of the tensors they are given and use their
plain PyTorch version only for CPU tensors.
"""

__version__ = "0.1.0"
