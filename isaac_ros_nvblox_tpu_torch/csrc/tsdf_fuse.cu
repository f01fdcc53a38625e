// Projective TSDF fusion of one depth frame into a batch of pool rows.
//
// Replaces the TPU kernel isaac_ros_nvblox_tpu/ops/tsdf_pallas.py::_kernel /
// _tsdf_body (launched by _run_fusion_kernel). The TPU version samples the
// depth image through one-hot matrix products over a decimation pyramid,
// because that chip has no element gather. Hopper gathers natively, so this
// kernel computes what the reference's XLA path (ops/tsdf.py::integrate_tsdf)
// computes, at full image resolution:
//
//   per voxel: center -> camera frame -> pinhole projection -> nearest depth
//   sample -> sdf = measured - z -> weight (one of six modes) -> running
//   average of min(sdf, truncation), weight capped at max_weight.
//
// Layout: a persistent grid (as many 512-thread CTAs as the card holds at
// once) walks the batch (projective.cuh::for_each_entry): a warp loads 32
// entries' slots and block indices at a time and votes, so that padding
// and dropped entries (slot outside [0, cap)) cost a lane's load each and
// no CTA. A CTA fuses one real block at a time, a voxel a thread, with the
// sensor pose staged once per CTA (projective.cuh::stage_pose), so that a
// voxel converts to float64 only what the plain version's single-rounding
// multiply-adds need (16 conversions, against 44 with the pose per voxel).
// For an in-view voxel the depth sample and the pool rows distance/weight
// f32[cap, 512] are loaded together, before either is used; an updated
// voxel is written back in place. (Two or four voxels a thread, and pool
// loads issued before the projection, measured no faster on the card.)
//
// Bound: instructions issued (PERF.md section 6, H100). At the main path's
// batch (~730 real entries in a bucket of 1024) a launch takes ~2.2 us
// with one block, plus ~4.7 ns a block: the plain version's own operations
// (two IEEE divisions in the projection, two in the fuse), of which the
// float64 conversions, at an eighth of the float32 rate on sm_90, hold
// ~0.9 us. The bytes (8 read per in-view voxel, 8 written per updated one;
// the depth image from L2) come well below that.
//
// Rounding: built with -fmad=false; see projective.cuh.

#include "projective.cuh"

namespace {

using proj::Params;

template <int MODE>
__global__ void __launch_bounds__(512)
tsdf_fuse_kernel(float* __restrict__ distance, float* __restrict__ weight,
                 const int* __restrict__ slots,
                 const int* __restrict__ block_indices,
                 const float* __restrict__ depth,
                 const float* __restrict__ T_L_C, int n, Params p) {
  __shared__ proj::Pose pose;
  proj::stage_pose(T_L_C, pose);
  const int v = threadIdx.x;
  proj::for_each_entry(slots, block_indices, n, p.cap,
                       [&](int slot, int bx, int by, int bz) {
    const proj::Pixel px = proj::project_voxel(pose, bx, by, bz, v, p);
    if (!px.in_view) return;
    const size_t off = (size_t)slot * 512 + v;
    const float measured = __ldg(depth + proj::nearest(px.v, p.H) * p.W +
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

extern "C" int tsdf_fuse(void* distance, void* weight, const void* slots,
                         const void* block_indices, const void* depth,
                         const void* T_L_C, const float* scalars, int n,
                         int cap, int H, int W, int mode, void* stream) {
  const Params p = proj::make_params(scalars, H, W, cap);
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  PROJ_DISPATCH_MODE(mode, M,
      tsdf_fuse_kernel<M><<<
          proj::persistent_grid<tsdf_fuse_kernel<M>>(512, n), 512, 0, s>>>(
          (float*)distance, (float*)weight, (const int*)slots,
          (const int*)block_indices, (const float*)depth,
          (const float*)T_L_C, n, p));
  return (int)cudaGetLastError();
}

extern "C" const char* tsdf_fuse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
