// Projective occupancy (log-odds) fusion of one depth frame into a batch of
// pool rows.
//
// Replaces the TPU kernel isaac_ros_nvblox_tpu/ops/occupancy_pallas.py::
// _kernel / _occ_body. The TPU version samples the depth image through
// one-hot matrix products over a decimation pyramid, because that chip has
// no element gather. Hopper gathers natively, so this kernel computes what
// the reference's XLA path (ops/occupancy.py::integrate_occupancy)
// computes, at full image resolution:
//
//   per voxel: center -> camera frame -> pinhole projection -> nearest depth
//   sample d -> free (z < d - hw) or occupied (|z - d| <= hw) within range
//   -> log-odds += l_free or l_occupied, clamped; observed = 1.
//
// Layout: one CTA per batch entry (a 512-voxel block), one thread per voxel
// (projective.cuh). The pool rows log_odds f32[cap, 512] and observed
// u8[cap, 512] are updated in place; entries with slot outside [0, cap) are
// padding and skip.
//
// Bound: device memory. Each in-view voxel reads 5 bytes of pool rows and
// each updated one writes them back; the depth image stays in L2 and is
// read with __ldg. The arithmetic (~40 flops per voxel) is far below the
// byte bound.
//
// Rounding: built with -fmad=false; see projective.cuh.

#include "projective.cuh"

namespace {

using proj::Params;

// The fusion constants after the camera block of the scalars (ops/
// occupancy.py::occupancy_scalars).
struct Occ {
  float hw, l_free, l_occ, lo_min, lo_max;
};

__global__ void __launch_bounds__(512)
occupancy_fuse_kernel(float* __restrict__ log_odds,
                      uint8_t* __restrict__ observed,
                      const int* __restrict__ slots,
                      const int* __restrict__ block_indices,
                      const float* __restrict__ depth,
                      const float* __restrict__ T_L_C, Params p, Occ o) {
  const int b = blockIdx.x;
  const int slot = slots[b];
  if (slot < 0 || slot >= p.cap) return;
  const int v = threadIdx.x;
  const proj::Pixel px = proj::project_voxel(
      proj::load_pose(T_L_C), block_indices[3 * b], block_indices[3 * b + 1],
      block_indices[3 * b + 2], v, p);
  if (!px.in_view) return;
  const float measured = __ldg(depth + (size_t)proj::nearest(px.v, p.H) * p.W
                               + proj::nearest(px.u, p.W));
  if (!(measured > 0.0f) || !isfinite(measured) || !(px.z <= p.max_dist))
    return;
  const bool is_free = px.z < measured - o.hw;
  const bool is_occ = fabsf(px.z - measured) <= o.hw;
  if (!(is_free || is_occ)) return;
  const size_t off = (size_t)slot * 512 + v;
  const float lo = log_odds[off] + (is_occ ? o.l_occ : o.l_free);
  log_odds[off] = fminf(fmaxf(lo, o.lo_min), o.lo_max);
  observed[off] = 1;
}

}  // namespace

extern "C" int occupancy_fuse(void* log_odds, void* observed,
                              const void* slots, const void* block_indices,
                              const void* depth, const void* T_L_C,
                              const float* scalars, int n, int cap, int H,
                              int W, void* stream) {
  const Params p = proj::make_params(scalars, H, W, cap);
  const float* s = scalars + proj::N_SCALARS;
  const Occ o = {s[0], s[1], s[2], s[3], s[4]};
  if (n <= 0) return 0;
  occupancy_fuse_kernel<<<n, 512, 0, (cudaStream_t)stream>>>(
      (float*)log_odds, (uint8_t*)observed, (const int*)slots,
      (const int*)block_indices, (const float*)depth, (const float*)T_L_C, p,
      o);
  return (int)cudaGetLastError();
}

extern "C" const char* occupancy_fuse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
