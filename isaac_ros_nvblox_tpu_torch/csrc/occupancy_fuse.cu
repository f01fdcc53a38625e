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
// Layout: a persistent grid (as many 512-thread CTAs as the card holds at
// once, 4 per SM at 32 registers) walks the batch (projective.cuh::
// for_each_entry): a warp loads 32 entries' slots and block indices at a
// time and votes, so that padding and dropped entries (slot outside
// [0, cap)) cost a lane's load each and no CTA. A CTA fuses one real block
// at a time, a voxel a thread. The sensor pose is staged in shared memory
// at the CTA's first real block (projective.cuh::stage_pose_share), from
// values loaded at the kernel's start beside the walk's first loads; a CTA
// with no real block stages nothing. Per block, 200 threads stage the
// parts of the voxel transform that voxels share (the shared helper
// projective.cuh::stage_block / BlockRows: x*R and the multiply-add of y
// for each of the 64 (lx, ly), the z coordinate of each lz, held in
// float64), so that a voxel makes only its last multiply-add per row
// (project_block_voxel): 3 float64 conversions a voxel and ~780 a block
// (~4.5 a voxel in all, against 16 with the pose staged alone and ~44
// with the pose built per thread; on sm_90 a conversion issues at an
// eighth of the float32 rate). For an in-view voxel the depth sample and
// the voxel's log-odds f32[cap, 512] are loaded together (loading the
// log-odds only after the free / occupied test measured the same); an
// updated voxel writes its log-odds and its observed byte u8[cap, 512]
// back in place.
//
// Bound: the launch and the latency of each block's chain (PERF.md section
// 6, H100, chip_smoke.py). The bytes (5 read per in-view voxel, 5 written
// per updated one; the depth image from L2) take 1.09 us at the occupancy
// path's batch (708 real blocks in 1024 entries); the kernel takes 4.2 us
// there, 2.0 us with one real block (the floor: a launch, the pose, one
// block's loads), 2.3 us on the dynamic path's 512-entry batch of 12 real
// blocks. With 528 resident CTAs, a third of the CTAs take two blocks.
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
                      const float* __restrict__ T_L_C, int n, Params p,
                      Occ o) {
  __shared__ proj::Pose pose;
  __shared__ proj::BlockRows rows;
  // The pose is staged at the CTA's first real block (a CTA with none
  // stages nothing); its loads are issued here, beside the walk's first.
  const proj::PoseShare share = proj::load_pose_share(T_L_C);
  bool staged = false;
  const int v = threadIdx.x;
  proj::for_each_entry(slots, block_indices, n, p.cap,
                       [&](int slot, int bx, int by, int bz) {
    proj::stage_block(share, staged, pose, rows, bx, by, bz, p.voxel);
    const proj::Pixel px = proj::project_block_voxel(pose, rows, v, p);
    if (!px.in_view) return;
    const size_t off = (size_t)slot * 512 + v;
    const float measured = __ldg(depth + proj::nearest(px.v, p.H) * p.W +
                                 proj::nearest(px.u, p.W));
    const float lo_old = log_odds[off];
    if (!(measured > 0.0f) || !isfinite(measured) || !(px.z <= p.max_dist))
      return;
    const bool is_free = px.z < measured - o.hw;
    const bool is_occ = fabsf(px.z - measured) <= o.hw;
    if (!(is_free || is_occ)) return;
    const float lo = lo_old + (is_occ ? o.l_occ : o.l_free);
    log_odds[off] = fminf(fmaxf(lo, o.lo_min), o.lo_max);
    observed[off] = 1;
  });
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
  occupancy_fuse_kernel<<<
      proj::persistent_grid<occupancy_fuse_kernel>(512, n), 512, 0,
      (cudaStream_t)stream>>>(
      (float*)log_odds, (uint8_t*)observed, (const int*)slots,
      (const int*)block_indices, (const float*)depth, (const float*)T_L_C, n,
      p, o);
  return (int)cudaGetLastError();
}

extern "C" const char* occupancy_fuse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
