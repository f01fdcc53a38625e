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
// Layout: one CTA per batch entry (a 512-voxel block), one thread per voxel
// (projective.cuh). The pool rows distance/weight f32[cap, 512] are updated
// in place; entries with slot outside [0, cap) are padding and skip.
//
// Bound: device memory. Each updated voxel reads and writes 8 bytes of pool
// rows; the depth image (1.2 MB at VGA) stays in L2 and is read with __ldg.
// The arithmetic (~50 flops per voxel) is far below the byte bound.
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
                 const float* __restrict__ T_L_C, Params p) {
  const int b = blockIdx.x;
  const int slot = slots[b];
  if (slot < 0 || slot >= p.cap) return;
  const int v = threadIdx.x;
  const proj::Pixel px = proj::project_voxel(block_indices, b, v, T_L_C, p);
  if (!px.in_view) return;
  const float measured = __ldg(depth + (size_t)proj::nearest(px.v, p.H) * p.W
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

extern "C" int tsdf_fuse(void* distance, void* weight, const void* slots,
                         const void* block_indices, const void* depth,
                         const void* T_L_C, const float* scalars, int n,
                         int cap, int H, int W, int mode, void* stream) {
  const Params p = proj::make_params(scalars, H, W, cap);
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  PROJ_DISPATCH_MODE(mode, M,
      tsdf_fuse_kernel<M><<<n, 512, 0, s>>>(
          (float*)distance, (float*)weight, (const int*)slots,
          (const int*)block_indices, (const float*)depth,
          (const float*)T_L_C, p));
  return (int)cudaGetLastError();
}

extern "C" const char* tsdf_fuse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
