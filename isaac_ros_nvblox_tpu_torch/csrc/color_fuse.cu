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
// Layout: occupancy_fuse.cu's. A persistent grid of 512-thread CTAs walks
// the batch (projective.cuh::for_each_entry), so that padding and dropped
// entries (slot outside [0, cap)) cost a lane's load each and no CTA. The
// pose's values and the `has_depth` byte (one thread's load) are loaded at
// the kernel's start and published in shared memory, with each block's
// shared transform rows, by projective.cuh::stage_block (~4.5 float64
// conversions a voxel, against ~44 with the pose built per thread). A
// color frame's batch is every allocated block in the color frustum, most
// of it free space: so the voxel's TSDF rows f32[cap, 512] (read only),
// which depend on the slot alone, are loaded before the block is staged,
// and the near-surface test runs before anything is sampled. Only a voxel
// in view and near the surface loads, together, the occlusion depth, the
// color pixel and its four planar color rows r, g, b, weight f32[cap, 512],
// and writes the rows back where it is not occluded. __launch_bounds__
// holds 40 registers (2 bytes spilled), 3 CTAs an SM: the chain of a
// colored voxel (its TSDF rows, then its samples and color rows) is
// latency that more warps hide (7.0-7.2 us at 46 registers, 2 CTAs).
//
// Bound: that latency and a one-block floor (PERF.md section 6;
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W). At the color
// path's batch (786 real blocks in 1024 entries, 36% of the in-view
// voxels colored) the kernel takes 6.4 us against 8.8 with one CTA per
// entry and the pose per thread, 2.1 us with one block. The bytes (8 read
// per in-view voxel, 32 per colored voxel; the images from L2) take 2.4
// us. Testing the TSDF rows before the projection, warp rows
// (stage_warp_block) and a cap of 32 registers measured no faster.
// `has_depth` (any depth > 0) is a device byte the wrapper computes, so no
// host sync decides the occlusion test.
//
// Rounding: built with -fmad=false; see projective.cuh.

#include "projective.cuh"

namespace {

using proj::Params;

template <int MODE, typename CT>
__global__ void __launch_bounds__(512, 3)
color_fuse_kernel(proj::ColorRows col, const float* __restrict__ tsdf_d,
                  const float* __restrict__ tsdf_w,
                  const int* __restrict__ slots,
                  const int* __restrict__ block_indices,
                  const CT* __restrict__ color,
                  const float* __restrict__ depth,
                  const float* __restrict__ T_L_C,
                  const unsigned char* __restrict__ has_depth, int n,
                  Params p, int Hd, int Wd, float scale) {
  __shared__ proj::Pose pose;
  __shared__ proj::BlockRows rows;
  __shared__ bool occlusion;
  // The pose and has_depth are staged at the CTA's first real block (a CTA
  // with none stages nothing); their loads are issued here.
  const proj::PoseShare share = proj::load_pose_share(T_L_C);
  const int v = threadIdx.x;
  const bool hd = v == 0 && __ldg(has_depth) != 0;
  bool staged = false;
  proj::for_each_entry(slots, block_indices, n, p.cap,
                       [&](int slot, int bx, int by, int bz) {
    const size_t off = (size_t)slot * 512 + v;
    const float d = __ldg(tsdf_d + off), w = __ldg(tsdf_w + off);
    if (!staged && v == 0) occlusion = hd;
    proj::stage_block(share, staged, pose, rows, bx, by, bz, p.voxel);
    const proj::Pixel px = proj::project_block_voxel(pose, rows, v, p);
    if (!px.in_view || !proj::color_near(d, w, px.z, p)) return;
    const bool occl = occlusion;
    float measured = 0.0f;
    if (occl) {
      measured = __ldg(depth + (size_t)proj::nearest(px.v * scale, Hd) * Wd
                       + proj::nearest(px.u * scale, Wd));
    }
    float rgb[3], c[4];
    proj::rgb_load(color, p.W, proj::nearest(px.v, p.H),
                   proj::nearest(px.u, p.W), rgb);
    col.load(off, c);
    if (occl && !proj::color_visible(px.z, measured, p)) return;
    proj::color_fuse_values<MODE>(c, rgb, px.z, p);
    col.store(off, c);
  });
}

template <typename CT>
int launch(void* const* ch, const void* tsdf_d, const void* tsdf_w,
           const void* slots, const void* bidx, const void* color,
           const void* depth, const void* T_L_C, const void* has_depth,
           const Params& p, int n, int Hd, int Wd, float scale, int mode,
           cudaStream_t s) {
  const proj::ColorRows col = {{(float*)ch[0], (float*)ch[1], (float*)ch[2],
                                (float*)ch[3]}};
  PROJ_DISPATCH_MODE(mode, M,
      color_fuse_kernel<M, CT><<<
          proj::persistent_grid<color_fuse_kernel<M, CT>>(512, n), 512, 0,
          s>>>(
          col, (const float*)tsdf_d, (const float*)tsdf_w, (const int*)slots,
          (const int*)bidx, (const CT*)color, (const float*)depth,
          (const float*)T_L_C, (const unsigned char*)has_depth, n, p, Hd, Wd,
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
