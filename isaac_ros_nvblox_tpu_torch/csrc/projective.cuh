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
// versions perform, fma_emul, is spelled out here in the same float64
// form, so kernels and plain versions agree bit for bit. On sm_90 a
// conversion to or from float64 issues at 16 per clock per SM, an eighth
// of the float32 rate, so the sensor pose (Pose: the rotation in float32
// and float64, the translation of the inverse) is computed once, and a
// voxel converts only its own coordinates and the roundings the plain
// version makes. The persistent kernels (tsdf_fuse, tsdf_lidar_fuse,
// occupancy_fuse) stage it once per CTA (stage_pose) and walk the batch
// with for_each_entry; color_fuse and tsdf_color_fuse, one CTA per batch
// entry, build it per thread (load_pose).

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

// a*b + c with one rounding to float32 (the product is exact in float64,
// so the float64 fma rounds only the sum, as the plain version's float64
// product-sum does).
__device__ __forceinline__ float fma_d(double a, double b, float c) {
  return (float)__fma_rn(a, b, (double)c);
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
// t2) and column r of R: r0 = R[0][r], and r1, r2 = R[1][r], R[2][r] in
// float64 (shared with the voxels' rows where the caller holds them, so
// that each is converted once).
__device__ __forceinline__ float pose_t(float t0, float t1, float t2,
                                        float r0, double r1, double r2) {
  float ti = t0 * -r0;
  ti = fma_d(t1, -r1, ti);
  return fma_d(t2, -r2, ti);
}

// The pose of T_L_S in the registers of one thread (kernels that run one
// CTA per batch entry and return early on padding).
__device__ __forceinline__ Pose load_pose(const float* __restrict__ T_L_S) {
  Pose P;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    P.R[i] = __ldg(T_L_S + 4 * (i / 3) + i % 3);
    P.Rd[i] = (double)P.R[i];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    P.t[r] = pose_t(__ldg(T_L_S + 3), __ldg(T_L_S + 7), __ldg(T_L_S + 11),
                    P.R[r], P.Rd[3 + r], P.Rd[6 + r]);
  return P;
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

// Pixel (row vi, column ui) of an interleaved H x W x 3 image as float.
template <typename CT>
__device__ __forceinline__ float rgb_at(const CT* __restrict__ img, int W,
                                        int vi, int ui, int ch) {
  return (float)__ldg(img + ((size_t)vi * W + ui) * 3 + ch);
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

// Whether a voxel takes color (ops/color.py::_fuse_color's `update`, given
// in_view): observed near the surface, in range, and not occluded by the
// depth sample when occlusion is checked.
__device__ __forceinline__ bool color_updates(float d, float w, float z,
                                              bool check_occlusion,
                                              float measured,
                                              const Params& p) {
  const bool near = (w > 1e-6f) && (fabsf(d) <= p.trunc) && (z <= p.max_dist);
  return near && (!check_occlusion ||
                  ((measured > 0.0f) && (z <= measured + p.trunc)));
}

// Running average of one color channel (ops/color.py::_fuse_color):
// blend_ok ? (c_old*w_old + rgb*w_new) * inv : c_old, with XLA's
// contraction of the sum of products.
__device__ __forceinline__ float blend(float c_old, float w_old, float rgb,
                                       float w_new, float inv, bool blend_ok) {
  return blend_ok ? fma_emul(c_old, w_old, rgb * w_new) * inv : c_old;
}

// The color update of one voxel at pool offset `off` (ops/color.py::
// _fuse_color, given that the voxel takes color): weight compute_weight at
// sdf = 0, running average of r, g, b from pixel (vi, ui) of the H x W x 3
// image, weight capped at max_weight.
template <int MODE, typename CT>
__device__ __forceinline__ void color_fuse_voxel(
    float* __restrict__ cr, float* __restrict__ cg, float* __restrict__ cb,
    float* __restrict__ cw, size_t off, const CT* __restrict__ color, int vi,
    int ui, float z, const Params& p) {
  const float w_new = weight_of<MODE>(z, 0.0f, p);
  const float w_old = cw[off];
  const float w_sum = w_old + w_new;
  const float inv = 1.0f / fmaxf(w_sum, 1e-6f);
  const bool ok = w_sum > 1e-6f;
  cr[off] = blend(cr[off], w_old, rgb_at(color, p.W, vi, ui, 0), w_new, inv,
                  ok);
  cg[off] = blend(cg[off], w_old, rgb_at(color, p.W, vi, ui, 1), w_new, inv,
                  ok);
  cb[off] = blend(cb[off], w_old, rgb_at(color, p.W, vi, ui, 2), w_new, inv,
                  ok);
  cw[off] = fminf(w_sum, p.max_weight);
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
