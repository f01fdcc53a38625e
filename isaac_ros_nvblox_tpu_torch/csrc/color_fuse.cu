// Projective color fusion of one color frame into a batch of pool rows.
//
// Replaces the TPU kernel isaac_ros_nvblox_tpu/ops/color_pallas.py::_kernel
// (launched by integrate_color_pallas). The TPU version samples r, g, b and
// the occlusion depth through one-hot matrix products over a decimation
// pyramid; Hopper gathers natively, so this kernel computes what the
// reference's XLA path (ops/color.py::integrate_color_planar) computes, at
// full image resolution:
//
//   per voxel: project -> skip unless observed near the surface
//   (w > 1e-6, |d| <= truncation), in range and in view -> when the depth
//   image holds any valid pixel, skip if occluded (depth sampled at
//   uv * Hd/H: measured > 0 and z <= measured + truncation) -> weight =
//   compute_weight at sdf = 0 -> running average of r, g, b, weight capped.
//
// Layout: one CTA per batch entry, one thread per voxel (projective.cuh).
// Planar channels r/g/b/weight f32[cap, 512] are updated in place; the TSDF
// rows are read only. Slots outside [0, cap) are padding and skip.
//
// Bound: device memory. Per voxel it reads 8 bytes of TSDF rows and, where
// it updates, reads and writes 16 bytes of color rows; the images stay in
// L2. `has_depth` (any depth > 0) is a device byte the wrapper computes, so
// no host sync decides the occlusion test.
//
// Rounding: built with -fmad=false; see projective.cuh.

#include "projective.cuh"

namespace {

using proj::Params;

template <int MODE, typename CT>
__global__ void __launch_bounds__(512)
color_fuse_kernel(float* __restrict__ cr, float* __restrict__ cg,
                  float* __restrict__ cb, float* __restrict__ cw,
                  const float* __restrict__ tsdf_d,
                  const float* __restrict__ tsdf_w,
                  const int* __restrict__ slots,
                  const int* __restrict__ block_indices,
                  const CT* __restrict__ color,
                  const float* __restrict__ depth,
                  const float* __restrict__ T_L_C,
                  const unsigned char* __restrict__ has_depth, Params p,
                  int Hd, int Wd, float scale) {
  const int b = blockIdx.x;
  const int slot = slots[b];
  if (slot < 0 || slot >= p.cap) return;
  const int v = threadIdx.x;
  const proj::Pixel px = proj::project_voxel(
      proj::load_pose(T_L_C), block_indices[3 * b], block_indices[3 * b + 1],
      block_indices[3 * b + 2], v, p);
  if (!px.in_view) return;
  const size_t off = (size_t)slot * 512 + v;
  const bool occl = *has_depth != 0;
  float measured = 0.0f;
  if (occl) {
    measured = __ldg(depth + (size_t)proj::nearest(px.v * scale, Hd) * Wd
                     + proj::nearest(px.u * scale, Wd));
  }
  if (!proj::color_updates(tsdf_d[off], tsdf_w[off], px.z, occl, measured, p))
    return;
  proj::color_fuse_voxel<MODE>(cr, cg, cb, cw, off, color,
                               proj::nearest(px.v, p.H),
                               proj::nearest(px.u, p.W), px.z, p);
}

template <typename CT>
int launch(void* const* ch, const void* tsdf_d, const void* tsdf_w,
           const void* slots, const void* bidx, const void* color,
           const void* depth, const void* T_L_C, const void* has_depth,
           const Params& p, int n, int Hd, int Wd, float scale, int mode,
           cudaStream_t s) {
  PROJ_DISPATCH_MODE(mode, M,
      color_fuse_kernel<M, CT><<<n, 512, 0, s>>>(
          (float*)ch[0], (float*)ch[1], (float*)ch[2], (float*)ch[3],
          (const float*)tsdf_d, (const float*)tsdf_w, (const int*)slots,
          (const int*)bidx, (const CT*)color, (const float*)depth,
          (const float*)T_L_C, (const unsigned char*)has_depth, p, Hd, Wd,
          scale));
  return (int)cudaGetLastError();
}

}  // namespace

// ch: the four planar channels r, g, b, weight. color: H x W x 3, uint8
// (color_u8 = 1) or float32. depth: Hd x Wd float32; scale = Hd / H.
extern "C" int color_fuse(void* const* ch, const void* tsdf_d,
                          const void* tsdf_w, const void* slots,
                          const void* block_indices, const void* color,
                          int color_u8, const void* depth,
                          const void* T_L_C, const void* has_depth,
                          const float* scalars, int n, int cap, int H, int W,
                          int Hd, int Wd, float scale, int mode,
                          void* stream) {
  const Params p = proj::make_params(scalars, H, W, cap);
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return color_u8
      ? launch<uint8_t>(ch, tsdf_d, tsdf_w, slots, block_indices, color,
                        depth, T_L_C, has_depth, p, n, Hd, Wd, scale, mode, s)
      : launch<float>(ch, tsdf_d, tsdf_w, slots, block_indices, color,
                      depth, T_L_C, has_depth, p, n, Hd, Wd, scale, mode, s);
}

extern "C" const char* color_fuse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
