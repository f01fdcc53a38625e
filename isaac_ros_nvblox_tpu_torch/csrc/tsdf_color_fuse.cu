// Fused TSDF + color fusion of one aligned RGB-D frame into a batch of pool
// rows, in one pass.
//
// Replaces the TPU kernel isaac_ros_nvblox_tpu/ops/tsdf_color_pallas.py::
// _kernel / _body (launched by integrate_tsdf_color_pallas), which samples
// depth, r, g and b through one shared one-hot product per block. Here each
// thread samples the depth pixel and the color pixel at the same nearest
// index (full resolution), runs the TSDF update of tsdf_fuse.cu, then the
// color update of color_fuse.cu on the values it has just computed, with
// the occlusion test measured > 0 and z <= measured + truncation. The
// result is bit for bit that of tsdf_fuse followed by color_fuse on the
// same batch (ops/color.py::integrate_tsdf_color is the plain version).
//
// Layout: a persistent grid of 512-thread CTAs walks the batch
// (projective.cuh::for_each_entry), so that padding and dropped entries
// (slot outside [0, cap)) cost a lane's load each and no CTA. The pose's
// values are loaded at the kernel's start and staged at the CTA's first
// real block. Each warp stages the transform rows its 32 voxels share
// (projective.cuh::stage_warp_block, ~8 float64 conversions a voxel
// against ~44 with the pose built per thread), so that the warps of a CTA
// take their blocks without a CTA barrier (8.5 -> 8.0 us against the
// CTA's shared rows of occupancy_fuse.cu). For an in-view voxel the depth
// sample, the distance and weight rows, the three channels of the color
// pixel at the same (vi, ui) and the four color rows r, g, b, color weight
// f32[cap, 512] are loaded together, before any of them is used (the
// color rows loaded only once color_updates passes: 8.1 us); the TSDF
// rows are written back where the depth updates them, the color rows
// where color_updates passes.
//
// Bound: instructions issued (PERF.md section 6; chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700 W). At the pipeline's color-cadence batch
// (707 real blocks in 1024 entries) the kernel takes 8.0 us against 8.7
// with one CTA per entry and the pose per thread, 1.9 us with one block
// (the floor: a launch, the pose, one block's chain). Per colored voxel
// the plain version's roundings cost ~30 float64 conversions (an eighth
// of the float32 rate on sm_90) and six IEEE divisions (two in the
// projection, the inverse square of each weight, one in the TSDF fuse,
// one in the blend). 56 registers hold 2 CTAs an SM; a cap of 40 or 32
// spills and measured slower (8.3-11.6 us). The bytes (8 read per in-view
// voxel, 8 written per TSDF update, 32 per colored voxel; the images from
// L2) take 2.7 us.
//
// Rounding: built with -fmad=false; see projective.cuh.

#include "projective.cuh"

namespace {

using proj::Params;

template <int MODE, typename CT>
__global__ void __launch_bounds__(512)
tsdf_color_fuse_kernel(float* __restrict__ distance,
                       float* __restrict__ weight, proj::ColorRows col,
                       const int* __restrict__ slots,
                       const int* __restrict__ block_indices,
                       const float* __restrict__ depth,
                       const CT* __restrict__ color,
                       const float* __restrict__ T_L_C, int n, Params p) {
  __shared__ proj::Pose pose;
  __shared__ proj::WarpRows warp_rows[16];
  // The pose is staged at the CTA's first real block (a CTA with none
  // stages nothing); its loads are issued here, beside the walk's first.
  const proj::PoseShare share = proj::load_pose_share(T_L_C);
  bool staged = false;
  const int v = threadIdx.x;
  proj::for_each_entry(slots, block_indices, n, p.cap,
                       [&](int slot, int bx, int by, int bz) {
    proj::WarpRows& wr = warp_rows[v >> 5];
    proj::stage_warp_block(share, staged, pose, wr, bx, by, bz, p.voxel);
    const proj::Pixel px = proj::project_warp_voxel(pose, wr, p);
    if (!px.in_view) return;
    const size_t off = (size_t)slot * 512 + v;
    const int vi = proj::nearest(px.v, p.H), ui = proj::nearest(px.u, p.W);
    const float measured = __ldg(depth + (size_t)vi * p.W + ui);
    float rgb[3], c[4];
    proj::rgb_load(color, p.W, vi, ui, rgb);
    float d = distance[off], w = weight[off];
    col.load(off, c);
    float sdf;
    if (proj::tsdf_updates(measured, px.z, p, &sdf)) {
      proj::tsdf_fuse_voxel<MODE>(px.z, sdf, d, w, p);
      distance[off] = d;
      weight[off] = w;
    }
    if (!proj::color_updates(d, w, px.z, true, measured, p)) return;
    proj::color_fuse_values<MODE>(c, rgb, px.z, p);
    col.store(off, c);
  });
}

template <typename CT>
int launch(void* const* ch, const void* slots, const void* bidx,
           const void* depth, const void* color, const void* T_L_C,
           const Params& p, int n, int mode, cudaStream_t s) {
  const proj::ColorRows col = {{(float*)ch[2], (float*)ch[3], (float*)ch[4],
                                (float*)ch[5]}};
  PROJ_DISPATCH_MODE(mode, M,
      tsdf_color_fuse_kernel<M, CT><<<
          proj::persistent_grid<tsdf_color_fuse_kernel<M, CT>>(512, n), 512,
          0, s>>>(
          (float*)ch[0], (float*)ch[1], col, (const int*)slots,
          (const int*)bidx, (const float*)depth, (const CT*)color,
          (const float*)T_L_C, n, p));
  return (int)cudaGetLastError();
}

}  // namespace

// ch: the six channels distance, weight, r, g, b, color weight. depth:
// H x W float32; color: H x W x 3, uint8 (color_u8 = 1) or float32.
extern "C" int tsdf_color_fuse(void* const* ch, const void* slots,
                               const void* block_indices, const void* depth,
                               const void* color, int color_u8,
                               const void* T_L_C, const float* scalars, int n,
                               int cap, int H, int W, int mode,
                               void* stream) {
  const Params p = proj::make_params(scalars, H, W, cap);
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return color_u8
      ? launch<uint8_t>(ch, slots, block_indices, depth, color, T_L_C, p, n,
                        mode, s)
      : launch<float>(ch, slots, block_indices, depth, color, T_L_C, p, n,
                      mode, s);
}

extern "C" const char* tsdf_color_fuse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
