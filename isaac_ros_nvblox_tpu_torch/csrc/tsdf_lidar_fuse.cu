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
// Layout: as tsdf_fuse.cu: a persistent grid of 512-thread CTAs walks the
// batch (projective.cuh::for_each_entry), a CTA fuses one real block at a
// time, a voxel a thread, with the sensor pose staged once per CTA; the
// range sample and the pool rows distance/weight f32[cap, 512] of an
// in-view voxel are loaded together. A source of its own (not a mode of
// tsdf_fuse.cu) so that its launches are counted apart.
//
// Bound: instructions issued (PERF.md section 6, H100). Per voxel about 22
// float64 conversions (the plain version's single-rounding multiply-adds
// of the pose and the range, at an eighth of the float32 rate on sm_90:
// ~6 us of the lidar batch's ~29 us), three IEEE divisions, three square
// roots and two atan2. The bytes (8 read per in-view voxel, 8 written per
// updated one; the range image, 115 KB at 1800 x 16, from L2) come well
// below that.
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
                       const float* __restrict__ T_L_S, int n, Params p,
                       LidarParams l) {
  __shared__ proj::Pose pose;
  proj::stage_pose(T_L_S, pose);
  const int v = threadIdx.x;
  proj::for_each_entry(slots, block_indices, n, p.cap,
                       [&](int slot, int bx, int by, int bz) {
    const proj::Pixel px =
        proj::project_voxel_lidar(pose, bx, by, bz, v, p, l);
    if (!px.in_view) return;
    const size_t off = (size_t)slot * 512 + v;
    const float measured = __ldg(range_image +
                                 proj::nearest(px.v, p.H) * p.W +
                                 proj::nearest(px.u, p.W));
    float d = distance[off], w = weight[off];
    float sdf;
    if (!proj::tsdf_updates(measured, px.z, p, &sdf)) return;
    proj::tsdf_fuse_voxel<MODE>(px.z, sdf, d, w, p);
    distance[off] = d;
    weight[off] = w;
  });
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
      tsdf_lidar_fuse_kernel<M><<<
          proj::persistent_grid<tsdf_lidar_fuse_kernel<M>>(512, n), 512, 0,
          s>>>(
          (float*)distance, (float*)weight, (const int*)slots,
          (const int*)block_indices, (const float*)range_image,
          (const float*)T_L_S, n, p, l));
  return (int)cudaGetLastError();
}

extern "C" const char* tsdf_lidar_fuse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
