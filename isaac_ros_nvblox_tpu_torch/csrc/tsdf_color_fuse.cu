// Fused TSDF + color fusion of one aligned RGB-D frame into a batch of pool
// rows, in one pass.
//
// Replaces the TPU kernel isaac_ros_nvblox_tpu/ops/tsdf_color_pallas.py::
// _kernel / _body (launched by integrate_tsdf_color_pallas), which samples
// depth, r, g and b through one shared one-hot product per block. Here each
// thread samples the depth pixel and the color pixel at the same nearest
// index (full resolution), runs the TSDF update of tsdf_fuse.cu, then the
// color update of color_fuse.cu on the rows it has just written, with the
// occlusion test measured > 0 and z <= measured + truncation. The result is
// bit for bit that of tsdf_fuse followed by color_fuse on the same batch
// (ops/color.py::integrate_tsdf_color is the plain version).
//
// Layout: one CTA per batch entry, one thread per voxel (projective.cuh);
// the six channels distance, weight, r, g, b, color weight f32[cap, 512]
// are updated in place. Slots outside [0, cap) are padding and skip.
//
// Bound: device memory. An in-view voxel reads 8 bytes of TSDF rows and
// writes them where it updates; a colored voxel reads and writes 16 bytes
// of color rows. Depth and color images stay in L2.
//
// Rounding: built with -fmad=false; see projective.cuh.

#include "projective.cuh"

namespace {

using proj::Params;

template <int MODE, typename CT>
__global__ void __launch_bounds__(512)
tsdf_color_fuse_kernel(float* __restrict__ distance,
                       float* __restrict__ weight, float* __restrict__ cr,
                       float* __restrict__ cg, float* __restrict__ cb,
                       float* __restrict__ cw, const int* __restrict__ slots,
                       const int* __restrict__ block_indices,
                       const float* __restrict__ depth,
                       const CT* __restrict__ color,
                       const float* __restrict__ T_L_C, Params p) {
  const int b = blockIdx.x;
  const int slot = slots[b];
  if (slot < 0 || slot >= p.cap) return;
  const int v = threadIdx.x;
  const proj::Pixel px = proj::project_voxel(
      proj::load_pose(T_L_C), block_indices[3 * b], block_indices[3 * b + 1],
      block_indices[3 * b + 2], v, p);
  if (!px.in_view) return;
  const int ui = proj::nearest(px.u, p.W), vi = proj::nearest(px.v, p.H);
  const float measured = __ldg(depth + (size_t)vi * p.W + ui);
  const size_t off = (size_t)slot * 512 + v;
  float d = distance[off], w = weight[off];
  float sdf;
  if (proj::tsdf_updates(measured, px.z, p, &sdf)) {
    proj::tsdf_fuse_voxel<MODE>(px.z, sdf, d, w, p);
    distance[off] = d;
    weight[off] = w;
  }
  if (!proj::color_updates(d, w, px.z, true, measured, p)) return;
  proj::color_fuse_voxel<MODE>(cr, cg, cb, cw, off, color, vi, ui, px.z, p);
}

template <typename CT>
int launch(void* const* ch, const void* slots, const void* bidx,
           const void* depth, const void* color, const void* T_L_C,
           const Params& p, int n, int mode, cudaStream_t s) {
  PROJ_DISPATCH_MODE(mode, M,
      tsdf_color_fuse_kernel<M, CT><<<n, 512, 0, s>>>(
          (float*)ch[0], (float*)ch[1], (float*)ch[2], (float*)ch[3],
          (float*)ch[4], (float*)ch[5], (const int*)slots, (const int*)bidx,
          (const float*)depth, (const CT*)color, (const float*)T_L_C, p));
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
