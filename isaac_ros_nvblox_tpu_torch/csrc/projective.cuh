// Projection (pinhole and spherical), nearest sampling, weighting and the
// TSDF and color updates shared by the projective kernels (tsdf_fuse.cu,
// color_fuse.cu, tsdf_color_fuse.cu, occupancy_fuse.cu,
// tsdf_lidar_fuse.cu), and the batch walk of the persistent ones (whose
// grid, persistent_grid, marching_cubes.cu shares with fma_emul;
// detect_dynamic.cu takes fma_d).
//
// Blocks are 512 voxels, lane v = lx*64 + ly*8 + lz. The arithmetic repeats
// the plain PyTorch versions step for step (ops/tsdf.py, ops/color.py,
// ops/occupancy.py, models/lidar.py), whose float32 roundings follow the
// reference's XLA path (core/types.py): every source that includes this
// header is built with -fmad=false, and the one contraction the plain
// versions perform, a multiply-add rounded once (fma_d, fma_emul), is
// spelled out here in float64, so kernels and plain versions agree bit
// for bit. On sm_90 a
// conversion to or from float64 issues at 16 per clock per SM, an eighth
// of the float32 rate, so the sensor pose (Pose: the rotation in float32
// and float64, the translation of the inverse) is computed once per CTA
// by every fusion kernel, each a persistent grid that walks the batch
// with for_each_entry. tsdf_fuse and tsdf_lidar_fuse stage it at the
// kernel's start (stage_pose) and transform each voxel alone (16
// conversions a voxel). occupancy_fuse, color_fuse and tsdf_color_fuse
// load it at the start and stage it at the CTA's first real block, with
// the parts of the transform that a block's voxels share: once per CTA
// (stage_block, BlockRows; ~4.5 conversions a voxel) or once per warp
// (stage_warp_block, WarpRows; ~8), so that a voxel converts only its
// last multiply-add per row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace proj {

enum Mode {
  CONSTANT = 0,
  CONSTANT_DROPOFF = 1,
  INVERSE_SQUARE = 2,
  INVERSE_SQUARE_DROPOFF = 3,
  INVERSE_SQUARE_TSDF_DISTANCE_PENALTY = 4,
  LINEAR_WITH_MAX = 5,
};

// The float32 constants of ops/tsdf.py::tsdf_scalars, in that order.
constexpr int N_SCALARS = 12;

struct Params {
  float fx, fy, cx, cy;
  float u_max, v_max;       // width - 1, height - 1
  float voxel;              // voxel size (m)
  float trunc;              // truncation (m)
  float max_dist;           // max integration distance (m)
  float max_weight;
  float r_drop, r_pen;      // float32 reciprocals of the weight denominators
  int H, W, cap;
};

inline Params make_params(const float* s, int H, int W, int cap) {
  Params p;
  p.fx = s[0];
  p.fy = s[1];
  p.cx = s[2];
  p.cy = s[3];
  p.u_max = s[4];
  p.v_max = s[5];
  p.voxel = s[6];
  p.trunc = s[7];
  p.max_dist = s[8];
  p.max_weight = s[9];
  p.r_drop = s[10];
  p.r_pen = s[11];
  p.H = H;
  p.W = W;
  p.cap = cap;
  return p;
}

// a*b + c with one rounding to float32, for float32 values a, b, c (held
// in float64): the product is exact in float64; the float64 sum is rounded
// to odd (toward zero, its last bit set where it is inexact), which the
// conversion then rounds to float32 correctly, as the plain version's
// fma (core/types.py) does. A sum rounded to nearest would round twice.
__device__ __forceinline__ float fma_d(double a, double b, double c) {
  const double lo = __fma_rd(a, b, c), hi = __fma_ru(a, b, c);
  long long bits = __double_as_longlong(hi <= 0.0 ? hi : lo);
  bits |= (long long)(lo != hi);
  return (float)__longlong_as_double(bits);
}

__device__ __forceinline__ float fma_emul(float a, float b, float c) {
  return fma_d((double)a, (double)b, c);
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// ops/tsdf.py::compute_weight for the voxel's camera depth z and its
// unclamped projective distance sdf.
template <int MODE>
__device__ __forceinline__ float weight_of(float z, float sdf,
                                           const Params& p) {
  if (MODE == CONSTANT) return 1.0f;
  if (MODE == LINEAR_WITH_MAX) return fminf(1.0f, 1.0f / fmaxf(z, 1e-4f));
  const float dropoff = clamp01((p.trunc + sdf) * p.r_drop);
  if (MODE == CONSTANT_DROPOFF) return dropoff;
  const float inv_sq = 1.0f / fmaxf(z * z, 1e-4f);
  if (MODE == INVERSE_SQUARE) return inv_sq;
  if (MODE == INVERSE_SQUARE_DROPOFF) return inv_sq * dropoff;
  // INVERSE_SQUARE_TSDF_DISTANCE_PENALTY
  return inv_sq * clamp01(fma_emul(-fabsf(sdf), p.r_pen, 1.0f));
}

// A voxel center projected into the camera.
struct Pixel {
  float z;        // camera-frame depth
  float u, v;     // pixel coordinates
  bool in_view;   // z > 0 and the pixel center inside the image
};

// The pose of a sensor at T_L_S (f32[4, 4], row-major) as the plain
// version inverts it (core/types.py Transform.inverse): T_S_L has rotation
// R^T and translation t' = -R^T t, accumulated by mat3_rows.
struct Pose {
  double Rd[9];   // R, row-major, in float64 (exact)
  float R[9];     // R in float32
  float t[3];     // t' = -R^T t
};

// Row r of t' = -R^T t, accumulated as mat3_rows does, from t = (t0, t1,
// t2) and column r of R (r0, r1, r2 = R[0][r], R[1][r], R[2][r]).
__device__ __forceinline__ float pose_t(float t0, float t1, float t2,
                                        float r0, float r1, float r2) {
  float ti = t0 * -r0;
  ti = fma_d(t1, -r1, ti);
  return fma_d(t2, -r2, ti);
}

// The values of T_L_S that thread threadIdx.x contributes to the staged
// pose: threads 0-8 an entry of R, threads 9-11 the six that a row of t'
// accumulates (pose_t's arguments). Loaded apart from stage_pose_share, so
// that a kernel can issue these loads beside its own first loads.
struct PoseShare {
  float v[6];
};

__device__ __forceinline__ PoseShare load_pose_share(
    const float* __restrict__ T_L_S) {
  PoseShare s;
  const int i = threadIdx.x;
  if (i < 9) {
    s.v[0] = __ldg(T_L_S + 4 * (i / 3) + i % 3);
  } else if (i < 12) {
    const int r = i - 9;
    s.v[0] = __ldg(T_L_S + 3);
    s.v[1] = __ldg(T_L_S + 7);
    s.v[2] = __ldg(T_L_S + 11);
    s.v[3] = __ldg(T_L_S + r);
    s.v[4] = __ldg(T_L_S + 4 + r);
    s.v[5] = __ldg(T_L_S + 8 + r);
  }
  return s;
}

// Stage the pose in shared memory `sp` from the threads' shares: threads
// 0-8 store an entry of R, threads 9-11 accumulate a row of t'. Every
// thread of the CTA must call it (it ends with a barrier); the CTA needs 12
// threads or more.
__device__ __forceinline__ void stage_pose_share(const PoseShare& s,
                                                 Pose& sp) {
  const int i = threadIdx.x;
  if (i < 9) {
    sp.R[i] = s.v[0];
    sp.Rd[i] = (double)s.v[0];
  } else if (i < 12) {
    sp.t[i - 9] = pose_t(s.v[0], s.v[1], s.v[2], s.v[3], s.v[4], s.v[5]);
  }
  __syncthreads();
}

// Stage the pose of T_L_S in shared memory `sp`, once per CTA (see
// stage_pose_share).
__device__ __forceinline__ void stage_pose(const float* __restrict__ T_L_S,
                                           Pose& sp) {
  stage_pose_share(load_pose_share(T_L_S), sp);
}

// Voxel center coordinate along one axis: block index bi, voxel l.
__device__ __forceinline__ float voxel_coord(int bi, int l, float voxel) {
  return ((float)(bi * 8 + l) + 0.5f) * voxel;
}

// The center (x, y, z) of voxel `lane` of block (bx, by, bz) in the frame
// of the sensor at pose P, p_S = R^T x + t', each row accumulated as
// mat3_rows does: x*R, then fused multiply-adds of y and z (converted to
// float64 once for the three rows), then t'.
__device__ __forceinline__ void voxel_in_sensor(const Pose& P, int bx, int by,
                                                int bz, int lane, float voxel,
                                                float pc[3]) {
  const float x = voxel_coord(bx, lane >> 6, voxel);
  const double yd = voxel_coord(by, (lane >> 3) & 7, voxel);
  const double zd = voxel_coord(bz, lane & 7, voxel);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float s = x * P.R[r];
    s = fma_d(yd, P.Rd[3 + r], s);
    s = fma_d(zd, P.Rd[6 + r], s);
    pc[r] = s + P.t[r];
  }
}

// The pinhole projection of pc, a point in the camera frame.
__device__ __forceinline__ Pixel pinhole(const float pc[3], const Params& p) {
  Pixel px;
  px.z = pc[2];
  const bool zpos = px.z > 1e-6f;
  const float zs = zpos ? px.z : 1.0f;
  px.u = p.fx * pc[0] / zs + p.cx;
  px.v = p.fy * pc[1] / zs + p.cy;
  px.in_view = zpos && px.u >= 0.0f && px.u <= p.u_max && px.v >= 0.0f &&
               px.v <= p.v_max;
  return px;
}

// Voxel `lane` of block (bx, by, bz) seen from the camera at pose P: the
// voxel in the camera frame, then the pinhole projection.
__device__ __forceinline__ Pixel project_voxel(const Pose& P, int bx, int by,
                                               int bz, int lane,
                                               const Params& p) {
  float pc[3];
  voxel_in_sensor(P, bx, by, bz, lane, p.voxel, pc);
  return pinhole(pc, p);
}

// The parts of a block's voxel transform (voxel_in_sensor) that several
// voxels share, computed once per block: row r of x*R then the
// multiply-add of y, for each (lx, ly), and the z coordinate of each lz,
// both held in float64 for the last multiply-add.
struct BlockRows {
  double xy[3][64];   // row r, lx * 8 + ly (a float32 value)
  double z[8];
};

// Called by every thread of a 512-thread CTA (occupancy_fuse, color_fuse)
// for each block (bx, by, bz) that for_each_entry hands it: at the CTA's
// first block (`staged` false) stages the pose `sp` from the threads'
// shares (stage_pose_share), at a later one waits until every voxel has
// read the previous block's rows; then 200 threads stage the block's
// rows, and a barrier publishes them. Shared values a kernel writes
// before its first call are published with the pose.
__device__ __forceinline__ void stage_block(const PoseShare& share,
                                            bool& staged, Pose& sp,
                                            BlockRows& rows, int bx, int by,
                                            int bz, float voxel) {
  // Every warp walks the same entries: `staged` is uniform in the CTA.
  if (!staged) {
    stage_pose_share(share, sp);
    staged = true;
  } else {
    __syncthreads();
  }
  const int v = threadIdx.x;
  if (v < 192) {
    const int r = v >> 6, i = v & 63;
    const float x = voxel_coord(bx, i >> 3, voxel);
    const double y = voxel_coord(by, i & 7, voxel);
    rows.xy[r][i] = fma_d(y, sp.Rd[3 + r], x * sp.R[r]);
  } else if (v < 200) {
    rows.z[v - 192] = voxel_coord(bz, v - 192, voxel);
  }
  __syncthreads();
}

// Voxel `lane` of the staged block seen from the camera at pose P: its
// last multiply-add per row from the block's rows (the same roundings as
// voxel_in_sensor), then the pinhole projection.
__device__ __forceinline__ Pixel project_block_voxel(const Pose& P,
                                                     const BlockRows& rows,
                                                     int lane,
                                                     const Params& p) {
  float pc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    pc[r] = fma_d(rows.z[lane & 7], P.Rd[6 + r], rows.xy[r][lane >> 3]) +
            P.t[r];
  return pinhole(pc, p);
}

// The rows of BlockRows that one warp's 32 voxels use: voxel v = 32 w + l
// (warp w, lane l) lies at lx = w >> 1, ly = 4 (w & 1) + (l >> 3),
// lz = l & 7, so the warp needs 4 (lx, ly) of each row and every z.
struct WarpRows {
  double xy[3][4];   // row r, ly & 3
  double z[8];
};

// stage_block for one warp (tsdf_color_fuse), called by every thread of a
// 512-thread CTA for each block (bx, by, bz) that for_each_entry hands it:
// at the CTA's first block stages the pose `sp` (stage_pose_share, a CTA
// barrier), then 20 lanes of each warp stage the warp's rows `wr` between
// two warp barriers, so that the warps of a CTA go on from block to block
// without waiting for each other. It costs ~5 conversions a voxel where
// stage_block costs ~1.6: it pays where a voxel's work is long enough for
// the CTA barriers to idle the SM (tsdf_color_fuse, 8.5 -> 8.0 us on an
// H100), and not where it is short (occupancy_fuse 4.3 -> 5.0 us,
// color_fuse; PERF.md section 6).
__device__ __forceinline__ void stage_warp_block(const PoseShare& share,
                                                 bool& staged, Pose& sp,
                                                 WarpRows& wr, int bx, int by,
                                                 int bz, float voxel) {
  if (!staged) {
    stage_pose_share(share, sp);
    staged = true;
  }
  const int v = threadIdx.x, l = v & 31;
  __syncwarp();   // every lane has read the previous block's rows
  if (l < 12) {
    const int r = l >> 2;
    const float x = voxel_coord(bx, v >> 6, voxel);
    const double y = voxel_coord(by, ((v >> 3) & 4) | (l & 3), voxel);
    wr.xy[r][l & 3] = fma_d(y, sp.Rd[3 + r], x * sp.R[r]);
  } else if (l < 20) {
    wr.z[l - 12] = voxel_coord(bz, l - 12, voxel);
  }
  __syncwarp();
}

// This thread's voxel of the staged block seen from the camera at pose
// P, from its warp's rows (project_block_voxel's roundings).
__device__ __forceinline__ Pixel project_warp_voxel(const Pose& P,
                                                    const WarpRows& wr,
                                                    const Params& p) {
  const int l = threadIdx.x & 31;
  float pc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    pc[r] = fma_d(wr.z[l & 7], P.Rd[6 + r], wr.xy[r][l >> 3]) + P.t[r];
  return pinhole(pc, p);
}

// Walks the batch entries of this CTA, b = blockIdx.x + k * gridDim.x for
// k = 0, 1, ..., and calls body(slot, bx, by, bz) for each real one (slot
// in [0, cap); block index bidx[3b..3b+2]). Each warp loads the slots and
// block indices of 32 entries at once, a lane each, and votes, so that a
// padding or dropped entry costs a lane's load and no pass of the CTA.
// Every warp walks the same entries in the same order, so the body may use
// the whole CTA.
template <typename Body>
__device__ __forceinline__ void for_each_entry(const int* __restrict__ slots,
                                               const int* __restrict__ bidx,
                                               int n, int cap, Body&& body) {
  const int lane = threadIdx.x & 31;
  const int G = gridDim.x;
  for (int b0 = blockIdx.x; b0 < n; b0 += 32 * G) {
    const int b = b0 + lane * G;
    int slot = -1, bx = 0, by = 0, bz = 0;
    if (b < n) {
      slot = __ldg(slots + b);
      bx = __ldg(bidx + 3 * b);
      by = __ldg(bidx + 3 * b + 1);
      bz = __ldg(bidx + 3 * b + 2);
    }
    unsigned live = __ballot_sync(0xffffffffu, slot >= 0 && slot < cap);
    while (live) {
      const int j = __ffs(live) - 1;
      live &= live - 1;
      body(__shfl_sync(0xffffffffu, slot, j),
           __shfl_sync(0xffffffffu, bx, j), __shfl_sync(0xffffffffu, by, j),
           __shfl_sync(0xffffffffu, bz, j));
    }
  }
}

// The persistent grid of a kernel that walks a batch of n entries (b =
// blockIdx.x + k * gridDim.x, as for_each_entry does): as many CTAs of
// `threads` as the card holds at once (SM count times resident CTAs per
// SM, asked once per kernel instantiation and device, kept in an atomic so
// that launches from several host threads may race on it), and no more
// than n. Host calls only: nothing waits on the card.
template <auto Kernel>
inline int persistent_grid(int threads, int n) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> grid[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  int g = dev < kMaxDevices ? grid[dev].load(std::memory_order_relaxed) : 0;
  if (g == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads,
                                                  0);
    g = sms * per_sm > 0 ? sms * per_sm : 1;
    if (dev < kMaxDevices) grid[dev].store(g, std::memory_order_relaxed);
  }
  return n < g ? n : g;
}

// The float32 constants of models/lidar.py::Lidar.scalars, in that order.
constexpr int N_LIDAR_SCALARS = 8;

struct LidarParams {
  float u_scale;            // A / (2 pi) as the reference's XLA folds it
  float pi;                 // float32(pi)
  float max_el;             // top elevation (rad)
  float r_per_row;          // float32 reciprocal of rad per row
  float el_lo, el_hi;       // valid elevation band (rad)
  float min_range, max_range;
};

inline LidarParams make_lidar_params(const float* s) {
  LidarParams l;
  l.u_scale = s[0];
  l.pi = s[1];
  l.max_el = s[2];
  l.r_per_row = s[3];
  l.el_lo = s[4];
  l.el_hi = s[5];
  l.min_range = s[6];
  l.max_range = s[7];
  return l;
}

// Voxel `lane` of block (bx, by, bz) seen from the lidar at pose P: the
// spherical projection of models/lidar.py::Lidar.project. The Pixel's z is
// the range r = sqrt(x^2 + y^2 + z^2) (accumulated as fma(z, z, fma(x, x,
// y*y)), correctly rounded); u = (atan2(y, x) + pi) * A/(2 pi); the
// elevation is arcsin(clip(z / max(r, 1e-9), -1, 1)) in XLA's expansion
// 2 atan2(q, 1 + sqrt((1 - q)(1 + q))); v = (max_el - el) / rad per row;
// in_view is the lidar's range and elevation test. (Computing the azimuth
// only in view saved nothing measurable on the card: nearly every voxel of
// a lidar batch is in view.)
__device__ __forceinline__ Pixel project_voxel_lidar(const Pose& P, int bx,
                                                     int by, int bz, int lane,
                                                     const Params& p,
                                                     const LidarParams& l) {
  float pc[3];
  voxel_in_sensor(P, bx, by, bz, lane, p.voxel, pc);
  const float r = sqrtf(fma_emul(pc[2], pc[2],
                                 fma_emul(pc[0], pc[0], pc[1] * pc[1])));
  const float az = atan2f(pc[1], pc[0]);
  const float q = fminf(fmaxf(pc[2] / fmaxf(r, 1e-9f), -1.0f), 1.0f);
  const float el = 2.0f * atan2f(q, 1.0f + sqrtf((1.0f - q) * (1.0f + q)));
  Pixel px;
  px.z = r;
  px.u = (az + l.pi) * l.u_scale;
  px.v = (l.max_el - el) * l.r_per_row;
  px.in_view = r >= l.min_range && r <= l.max_range && el >= l.el_lo &&
               el <= l.el_hi;
  return px;
}

// Nearest pixel index along one axis: round half to even, clamped to
// [0, n - 1] (models/camera.py::sample_image_nearest).
__device__ __forceinline__ int nearest(float x, int n) {
  return min(max(__float2int_rn(x), 0), n - 1);
}

// Whether a depth sample updates the voxel's TSDF (ops/tsdf.py
// integrate_tsdf's `update`, given in_view); sets the projective distance.
__device__ __forceinline__ bool tsdf_updates(float measured, float z,
                                             const Params& p, float* sdf) {
  if (!(measured > 0.0f) || !isfinite(measured)) return false;
  *sdf = measured - z;
  return (z <= p.max_dist) && (*sdf >= -p.trunc);
}

// The TSDF running average (ops/tsdf.py::fuse) of one updated voxel, in
// place: the distance folds in min(sdf, truncation), the weight is capped.
template <int MODE>
__device__ __forceinline__ void tsdf_fuse_voxel(float z, float sdf, float& d,
                                                float& w, const Params& p) {
  const float w_new = weight_of<MODE>(z, sdf, p);
  const float sdf_c = fminf(sdf, p.trunc);
  const float w_sum = w + w_new;
  d = w_sum > 1e-6f ? fma_emul(d, w, sdf_c * w_new) / fmaxf(w_sum, 1e-6f) : d;
  w = fminf(w_sum, p.max_weight);
}

// Whether a voxel is observed near the surface and in range, the first
// half of color_updates: a test of its TSDF rows and depth alone.
__device__ __forceinline__ bool color_near(float d, float w, float z,
                                           const Params& p) {
  return (w > 1e-6f) && (fabsf(d) <= p.trunc) && (z <= p.max_dist);
}

// Whether a depth sample leaves the voxel unoccluded, the second half.
__device__ __forceinline__ bool color_visible(float z, float measured,
                                              const Params& p) {
  return (measured > 0.0f) && (z <= measured + p.trunc);
}

// Whether a voxel takes color (ops/color.py::_fuse_color's `update`, given
// in_view): observed near the surface, in range, and not occluded by the
// depth sample when occlusion is checked.
__device__ __forceinline__ bool color_updates(float d, float w, float z,
                                              bool check_occlusion,
                                              float measured,
                                              const Params& p) {
  return color_near(d, w, z, p) &&
         (!check_occlusion || color_visible(z, measured, p));
}

// Running average of one color channel (ops/color.py::_fuse_color):
// blend_ok ? (c_old*w_old + rgb*w_new) * inv : c_old, with XLA's
// contraction of the sum of products.
__device__ __forceinline__ float blend(float c_old, float w_old, float rgb,
                                       float w_new, float inv, bool blend_ok) {
  return blend_ok ? fma_emul(c_old, w_old, rgb * w_new) * inv : c_old;
}

// The four planar color channels r, g, b, weight f32[cap, 512].
struct ColorRows {
  float* __restrict__ c[4];

  // Voxel `off`'s four values.
  __device__ __forceinline__ void load(size_t off, float out[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = c[i][off];
  }

  __device__ __forceinline__ void store(size_t off, const float in[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i][off] = in[i];
  }
};

// The three channels of pixel (row vi, column ui) of an interleaved
// H x W x 3 image, as float.
template <typename CT>
__device__ __forceinline__ void rgb_load(const CT* __restrict__ img, int W,
                                         int vi, int ui, float rgb[3]) {
  const CT* px = img + ((size_t)vi * W + ui) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) rgb[ch] = (float)__ldg(px + ch);
}

// The color update of one voxel's values c = (r, g, b, weight)
// (ops/color.py::_fuse_color, given that the voxel takes color): weight
// compute_weight at sdf = 0, running average of r, g, b with the pixel
// `rgb`, weight capped at max_weight.
template <int MODE>
__device__ __forceinline__ void color_fuse_values(float c[4],
                                                  const float rgb[3],
                                                  float z, const Params& p) {
  const float w_new = weight_of<MODE>(z, 0.0f, p);
  const float w_old = c[3];
  const float w_sum = w_old + w_new;
  const float inv = 1.0f / fmaxf(w_sum, 1e-6f);
  const bool ok = w_sum > 1e-6f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    c[ch] = blend(c[ch], w_old, rgb[ch], w_new, inv, ok);
  c[3] = fminf(w_sum, p.max_weight);
}

}  // namespace proj

// Expands to a switch over the six weighting modes that runs STMT with the
// compile-time constant M set to the mode; unknown modes return
// cudaErrorInvalidValue from the enclosing function.
#define PROJ_DISPATCH_MODE(mode, M, ...)                                     \
  switch (mode) {                                                            \
    case proj::CONSTANT: {                                                   \
      constexpr int M = proj::CONSTANT;                                      \
      __VA_ARGS__;                                                           \
    } break;                                                                 \
    case proj::CONSTANT_DROPOFF: {                                           \
      constexpr int M = proj::CONSTANT_DROPOFF;                              \
      __VA_ARGS__;                                                           \
    } break;                                                                 \
    case proj::INVERSE_SQUARE: {                                             \
      constexpr int M = proj::INVERSE_SQUARE;                                \
      __VA_ARGS__;                                                           \
    } break;                                                                 \
    case proj::INVERSE_SQUARE_DROPOFF: {                                     \
      constexpr int M = proj::INVERSE_SQUARE_DROPOFF;                        \
      __VA_ARGS__;                                                           \
    } break;                                                                 \
    case proj::INVERSE_SQUARE_TSDF_DISTANCE_PENALTY: {                       \
      constexpr int M = proj::INVERSE_SQUARE_TSDF_DISTANCE_PENALTY;          \
      __VA_ARGS__;                                                           \
    } break;                                                                 \
    case proj::LINEAR_WITH_MAX: {                                            \
      constexpr int M = proj::LINEAR_WITH_MAX;                               \
      __VA_ARGS__;                                                           \
    } break;                                                                 \
    default:                                                                 \
      return (int)cudaErrorInvalidValue;                                     \
  }
