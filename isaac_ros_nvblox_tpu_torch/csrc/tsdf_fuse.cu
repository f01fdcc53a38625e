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
// Layout: one CTA per batch entry (a 512-voxel block), one thread per voxel,
// lane v = lx*64 + ly*8 + lz. The pool rows distance/weight f32[cap, 512] are
// updated in place; entries with slot outside [0, cap) are padding and skip.
//
// Bound: device memory. Each updated voxel reads and writes 8 bytes of pool
// rows; the depth image (1.2 MB at VGA) stays in L2 and is read with __ldg.
// The arithmetic (~50 flops per voxel) is far below the byte bound.
//
// Rounding: the file is built with -fmad=false and spells out the one
// contraction the plain PyTorch version (ops/tsdf.py) performs, fma_emul, in
// the same float64 form, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode {
  CONSTANT = 0,
  CONSTANT_DROPOFF = 1,
  INVERSE_SQUARE = 2,
  INVERSE_SQUARE_DROPOFF = 3,
  INVERSE_SQUARE_TSDF_DISTANCE_PENALTY = 4,
  LINEAR_WITH_MAX = 5,
};

struct TsdfParams {
  float fx, fy, cx, cy;
  float u_max, v_max;       // width - 1, height - 1
  float voxel;              // voxel size (m)
  float trunc;              // truncation (m)
  float max_dist;           // max integration distance (m)
  float max_weight;
  float r_drop, r_pen;      // float32 reciprocals of the weight denominators
  int H, W, cap;
};

// a*b + c with one rounding to float32 (the product is exact in float64).
__device__ __forceinline__ float fma_emul(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

template <int MODE>
__device__ __forceinline__ float weight_of(float z, float sdf,
                                           const TsdfParams& p) {
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

template <int MODE>
__global__ void __launch_bounds__(512)
tsdf_fuse_kernel(float* __restrict__ distance, float* __restrict__ weight,
                 const int* __restrict__ slots,
                 const int* __restrict__ block_indices,
                 const float* __restrict__ depth,
                 const float* __restrict__ T_L_C, TsdfParams p) {
  const int b = blockIdx.x;
  const int slot = slots[b];
  if (slot < 0 || slot >= p.cap) return;
  const int v = threadIdx.x;
  const int lx = v >> 6, ly = (v >> 3) & 7, lz = v & 7;

  const float x = ((float)(block_indices[3 * b + 0] * 8 + lx) + 0.5f) * p.voxel;
  const float y = ((float)(block_indices[3 * b + 1] * 8 + ly) + 0.5f) * p.voxel;
  const float z = ((float)(block_indices[3 * b + 2] * 8 + lz) + 0.5f) * p.voxel;

  // T_C_L = inverse(T_L_C): R^T and -R^T t, then p_C = R^T x + t', each
  // accumulated as the plain version (core/types.py Transform) does.
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[3 * i + j] = __ldg(T_L_C + 4 * i + j);
    t[i] = __ldg(T_L_C + 4 * i + 3);
  }
  float pc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float ti = t[0] * -R[r];
    ti = fma_emul(t[1], -R[3 + r], ti);
    ti = fma_emul(t[2], -R[6 + r], ti);
    float s = x * R[r];
    s = fma_emul(y, R[3 + r], s);
    s = fma_emul(z, R[6 + r], s);
    pc[r] = s + ti;
  }
  const float pz = pc[2];
  const bool zpos = pz > 1e-6f;
  const float zs = zpos ? pz : 1.0f;
  const float u = p.fx * pc[0] / zs + p.cx;
  const float vv = p.fy * pc[1] / zs + p.cy;
  if (!(zpos && u >= 0.0f && u <= p.u_max && vv >= 0.0f && vv <= p.v_max))
    return;

  // Nearest sample, rounding half to even.
  const int ui = min(max(__float2int_rn(u), 0), p.W - 1);
  const int vi = min(max(__float2int_rn(vv), 0), p.H - 1);
  const float measured = __ldg(depth + (size_t)vi * p.W + ui);
  if (!(measured > 0.0f) || !isfinite(measured)) return;
  const float sdf = measured - pz;
  if (!(pz <= p.max_dist) || !(sdf >= -p.trunc)) return;

  const float w_new = weight_of<MODE>(pz, sdf, p);
  const size_t off = (size_t)slot * 512 + v;
  const float d_old = distance[off];
  const float w_old = weight[off];
  const float sdf_c = fminf(sdf, p.trunc);
  const float w_sum = w_old + w_new;
  const float d_fused =
      w_sum > 1e-6f ? fma_emul(d_old, w_old, sdf_c * w_new) / fmaxf(w_sum, 1e-6f)
                    : d_old;
  distance[off] = d_fused;
  weight[off] = fminf(w_sum, p.max_weight);
}

}  // namespace

extern "C" int tsdf_fuse(void* distance, void* weight, const void* slots,
                         const void* block_indices, const void* depth,
                         const void* T_L_C, const float* scalars, int n,
                         int cap, int H, int W, int mode, void* stream) {
  TsdfParams p;
  p.fx = scalars[0];
  p.fy = scalars[1];
  p.cx = scalars[2];
  p.cy = scalars[3];
  p.u_max = scalars[4];
  p.v_max = scalars[5];
  p.voxel = scalars[6];
  p.trunc = scalars[7];
  p.max_dist = scalars[8];
  p.max_weight = scalars[9];
  p.r_drop = scalars[10];
  p.r_pen = scalars[11];
  p.H = H;
  p.W = W;
  p.cap = cap;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* d = (float*)distance;
  float* w = (float*)weight;
  const int* sl = (const int*)slots;
  const int* bi = (const int*)block_indices;
  const float* dp = (const float*)depth;
  const float* T = (const float*)T_L_C;
  switch (mode) {
    case CONSTANT:
      tsdf_fuse_kernel<CONSTANT><<<n, 512, 0, s>>>(d, w, sl, bi, dp, T, p);
      break;
    case CONSTANT_DROPOFF:
      tsdf_fuse_kernel<CONSTANT_DROPOFF><<<n, 512, 0, s>>>(d, w, sl, bi, dp, T, p);
      break;
    case INVERSE_SQUARE:
      tsdf_fuse_kernel<INVERSE_SQUARE><<<n, 512, 0, s>>>(d, w, sl, bi, dp, T, p);
      break;
    case INVERSE_SQUARE_DROPOFF:
      tsdf_fuse_kernel<INVERSE_SQUARE_DROPOFF><<<n, 512, 0, s>>>(d, w, sl, bi, dp, T, p);
      break;
    case INVERSE_SQUARE_TSDF_DISTANCE_PENALTY:
      tsdf_fuse_kernel<INVERSE_SQUARE_TSDF_DISTANCE_PENALTY>
          <<<n, 512, 0, s>>>(d, w, sl, bi, dp, T, p);
      break;
    case LINEAR_WITH_MAX:
      tsdf_fuse_kernel<LINEAR_WITH_MAX><<<n, 512, 0, s>>>(d, w, sl, bi, dp, T, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tsdf_fuse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
