// Spherical (lidar) TSDF fusion of one range image into a batch of pool
// rows.
//
// Replaces the TPU path isaac_ros_nvblox_tpu/ops/lidar_pallas.py::
// integrate_tsdf_lidar_pallas, which feeds the TSDF fusion kernel
// (tsdf_pallas.py::_kernel) through a spherical footprint prepass with an
// azimuth wrap margin, so that its one-hot sampling of a decimation
// pyramid reaches the range image. Hopper gathers natively, so this kernel
// computes what the reference's XLA path (ops/tsdf.py::
// integrate_tsdf_lidar) computes, at full resolution:
//
//   per voxel: center -> sensor frame -> range r, azimuth and elevation
//   (projective.cuh::project_voxel_lidar) -> nearest range sample (the
//   column clamps at the last one, as the XLA path does at the +-pi seam)
//   -> sdf = measured - r -> weight (one of six modes, with r in place of
//   z) -> running average of min(sdf, truncation), weight capped.
//
// Layout: one CTA per batch entry (a 512-voxel block), one thread per voxel
// (projective.cuh). The pool rows distance/weight f32[cap, 512] are updated
// in place; entries with slot outside [0, cap) are padding and skip. A
// source of its own (not a mode of tsdf_fuse.cu) so that its launches are
// counted apart.
//
// Bound: device memory. Each in-view voxel reads 8 bytes of pool rows and
// each updated one writes them back; the range image (115 KB at 1800 x 16)
// stays in L2. Two atan2 and two square roots per voxel (~150 flops) stay
// below the byte bound.
//
// Rounding: built with -fmad=false; see projective.cuh.

#include "projective.cuh"

namespace {

using proj::LidarParams;
using proj::Params;

template <int MODE>
__global__ void __launch_bounds__(512)
tsdf_lidar_fuse_kernel(float* __restrict__ distance,
                       float* __restrict__ weight,
                       const int* __restrict__ slots,
                       const int* __restrict__ block_indices,
                       const float* __restrict__ range_image,
                       const float* __restrict__ T_L_S, Params p,
                       LidarParams l) {
  const int b = blockIdx.x;
  const int slot = slots[b];
  if (slot < 0 || slot >= p.cap) return;
  const int v = threadIdx.x;
  const proj::Pixel px =
      proj::project_voxel_lidar(block_indices, b, v, T_L_S, p, l);
  if (!px.in_view) return;
  const float measured =
      __ldg(range_image + (size_t)proj::nearest(px.v, p.H) * p.W
            + proj::nearest(px.u, p.W));
  float sdf;
  if (!proj::tsdf_updates(measured, px.z, p, &sdf)) return;
  const size_t off = (size_t)slot * 512 + v;
  float d = distance[off], w = weight[off];
  proj::tsdf_fuse_voxel<MODE>(px.z, sdf, d, w, p);
  distance[off] = d;
  weight[off] = w;
}

}  // namespace

extern "C" int tsdf_lidar_fuse(void* distance, void* weight,
                               const void* slots, const void* block_indices,
                               const void* range_image, const void* T_L_S,
                               const float* scalars, int n, int cap, int rows,
                               int cols, int mode, void* stream) {
  const Params p = proj::make_params(scalars, rows, cols, cap);
  const LidarParams l = proj::make_lidar_params(scalars + proj::N_SCALARS);
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  PROJ_DISPATCH_MODE(mode, M,
      tsdf_lidar_fuse_kernel<M><<<n, 512, 0, s>>>(
          (float*)distance, (float*)weight, (const int*)slots,
          (const int*)block_indices, (const float*)range_image,
          (const float*)T_L_S, p, l));
  return (int)cudaGetLastError();
}

extern "C" const char* tsdf_lidar_fuse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
