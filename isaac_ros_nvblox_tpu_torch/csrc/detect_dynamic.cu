// Dynamic-pixel detection: a depth endpoint inside high-confidence
// freespace.
//
// Replaces the TPU kernel isaac_ros_nvblox_tpu/ops/detect_pallas.py::
// _kernel (launched by detect_dynamic_pallas / detect_dynamic_fused_pallas).
// That kernel marks pixels voxel by voxel through one-hot matrix products
// over a decimation pyramid, because the TPU has no element gather. Hopper
// gathers natively, so this kernel computes what the reference's exact
// per-pixel lookup (mapper/multi_mapper.py::_detect_dynamic_fused, here
// ops/detect.py::detect_dynamic_plain) computes:
//
//   per evaluated pixel (vs, us), vs and us multiples of the subsample s:
//   its depth z; back-projection x = (us - cx) * (1/fx) * z, y likewise;
//   the endpoint p = T_L_C [x y z 1]; voxel g = floor(p * (1/voxel)); block
//   g >> 3, slot_grid at the block's cell; the voxel's high_confidence
//   byte. Dynamic iff the cell is inside the grid, the block allocated,
//   0 < z <= max depth and the byte set; the result covers the s x s tile
//   of output pixels from (vs, us).
//
// Layout: a 2-D grid of 32 x 8-thread CTAs over the evaluated pixels, a
// thread owning PIX = 2 consecutive evaluated pixels of one row (its row
// and columns come from the CTA and thread indices: no division by the
// width). At s = 1 with W even and the depth on an 8-byte boundary (640 x
// 480 is) a thread loads its depths with one 8-byte load and stores its
// mask bytes with one 16-bit store; any other shape takes the scalar path
// (4-byte loads, byte stores of each s x s tile), which the C entry picks
// from the shape and the pointers. The depth loads are issued first; then
// the pose is staged once per CTA in shared memory, the rotation's y and z
// columns in float64, so that a pixel converts only y, z and the plain
// version's roundings (14 conversions, against 24 with the pose converted
// per pixel). A pixel's slot_grid load is issued as soon as its cell is
// known.
//
// Bound: the latency of each pixel's chain (PERF.md section 6, H100,
// chip_smoke.py): the depth load, the float64 multiply-adds, then the
// slot_grid and high_confidence loads, each waiting on the one before. The
// bytes (depth 4 B and mask 1 B a pixel, a few hundred slot_grid cells and
// a few thousand high_confidence bytes) take 0.46 us at 640 x 480; the
// kernel takes 3.5 us there and 1.9 us on an all-zero image, where every
// pixel stops at the depth test (the floor: a launch, the depth loads, the
// pose, the stores). 4 pixels a thread (16-byte loads, 32-bit stores; 18
// warps an SM) took 4.1 us, 1 pixel a thread 3.6.
//
// Rounding: built with -fmad=false; the transform's multiply-adds round
// once, as the plain version's (projective.cuh fma_d).

#include <climits>

#include "projective.cuh"

namespace {

using proj::fma_d;

constexpr int TX = 32, TY = 8;   // CTA: 32 threads along a row x 8 rows
constexpr int PIX = 2;           // evaluated pixels a thread

struct Det {
  float fx, fy, cx, cy, rfx, rfy, rvox, max_depth;
};

// T_L_C (f32[4, 4], row-major) as the pixels use it, and the grid origin.
struct DetPose {
  double Ryz[3][2];   // T[r][1], T[r][2] in float64 (exact)
  float Rx[3];        // T[r][0]
  float t[3];         // T[r][3]
  int origin[3];
};

// (int) clamp(floor(q), -2^30, 2^30) in one rounding conversion: the
// conversion saturates beyond the int range, NaN takes the clamp's lower
// bound as fmaxf(NaN, -2^30) does.
__device__ __forceinline__ int voxel_index(float q) {
  constexpr int kBig = 1 << 30;
  return isnan(q) ? -kBig : min(max(__float2int_rd(q), -kBig), kBig);
}

template <bool VEC>
__global__ void __launch_bounds__(TX * TY)
detect_dynamic_kernel(uint8_t* __restrict__ out,
                      const float* __restrict__ depth,
                      const float* __restrict__ T,
                      const int* __restrict__ slot_grid,
                      const int* __restrict__ origin,
                      const uint8_t* __restrict__ hc, Det c, int H, int W,
                      int s, int Ws, int D0, int D1, int D2, int cap) {
  __shared__ DetPose P;
  const int j0 = (blockIdx.x * TX + threadIdx.x) * PIX;
  const int vs = (blockIdx.y * TY + threadIdx.y) * s;
  const bool live = j0 < Ws && vs < H;
  // The depth loads are issued before the pose is staged, so that the two
  // loads' latencies overlap.
  float z[PIX] = {};
  const float* row = depth + (size_t)vs * W;
  if (live && VEC) {
    const float2 d = __ldg(reinterpret_cast<const float2*>(row + j0));
    z[0] = d.x;
    z[1] = d.y;
  } else if (live) {
#pragma unroll
    for (int k = 0; k < PIX; ++k)
      if (j0 + k < Ws) z[k] = __ldg(row + (size_t)(j0 + k) * s);
  }
  const int tid = threadIdx.y * TX + threadIdx.x;
  if (tid < 3) {
    P.Rx[tid] = __ldg(T + 4 * tid);
    P.t[tid] = __ldg(T + 4 * tid + 3);
    P.origin[tid] = __ldg(origin + tid);
  } else if (tid < 9) {
    const int r = (tid - 3) >> 1, k = (tid - 3) & 1;
    P.Ryz[r][k] = (double)__ldg(T + 4 * r + 1 + k);
  }
  __syncthreads();
  if (!live) return;
  const float yr = ((float)vs - c.cy) * c.rfy;
  // Each pixel's slot_grid load is issued as soon as its cell is known,
  // while the next pixel's endpoint is computed.
  int slot[PIX], vox[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    slot[k] = -1;
    vox[k] = 0;
    if (!(z[k] > 0.0f && z[k] <= c.max_depth)) continue;
    const float x = ((float)((j0 + k) * s) - c.cx) * c.rfx * z[k];
    const float y = yr * z[k];
    const double yd = y, zd = z[k];
    int g[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float p = x * P.Rx[a];
      p = fma_d(yd, P.Ryz[a][0], p);
      p = fma_d(zd, P.Ryz[a][1], p);
      p = p + P.t[a];
      g[a] = voxel_index(p * c.rvox);
    }
    const int c0 = (g[0] >> 3) - P.origin[0];
    const int c1 = (g[1] >> 3) - P.origin[1];
    const int c2 = (g[2] >> 3) - P.origin[2];
    if (c0 >= 0 && c0 < D0 && c1 >= 0 && c1 < D1 && c2 >= 0 && c2 < D2) {
      slot[k] = __ldg(slot_grid + (c0 * D1 + c1) * D2 + c2);
      vox[k] = ((g[0] & 7) * 8 + (g[1] & 7)) * 8 + (g[2] & 7);
    }
  }
  uint8_t m[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k)
    m[k] = slot[k] >= 0 &&
           __ldg(hc + (size_t)min(slot[k], cap - 1) * 512 + vox[k]);
  if (VEC) {
    *reinterpret_cast<uint16_t*>(out + (size_t)vs * W + j0) =
        (uint16_t)(m[0] | (m[1] << 8));
  } else {
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      if (j0 + k >= Ws) break;
      const int u0 = (j0 + k) * s;
      for (int v = vs; v < min(vs + s, H); ++v)
        for (int u = u0; u < min(u0 + s, W); ++u)
          out[(size_t)v * W + u] = m[k];
    }
  }
}

}  // namespace

extern "C" int detect_dynamic(void* out, const void* depth, const void* T_L_C,
                              const void* slot_grid, const void* origin,
                              const void* high_confidence,
                              const float* scalars, int H, int W,
                              int subsample, int D0, int D1, int D2, int cap,
                              void* stream) {
  const Det c = {scalars[0], scalars[1], scalars[2], scalars[3],
                 scalars[4], scalars[5], scalars[6], scalars[7]};
  if (H <= 0 || W <= 0) return 0;
  if ((long long)H * W > INT_MAX || (long long)D0 * D1 * D2 > INT_MAX ||
      subsample < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  const int s = subsample;
  const int Hs = (H + s - 1) / s, Ws = (W + s - 1) / s;
  const int quads = (Ws + PIX - 1) / PIX;
  const dim3 grid((quads + TX - 1) / TX, (Hs + TY - 1) / TY);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(TX, TY);
  const bool vec = s == 1 && W % PIX == 0 &&
                   (uintptr_t)depth % (4 * PIX) == 0 &&
                   (uintptr_t)out % PIX == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    detect_dynamic_kernel<true><<<grid, block, 0, st>>>(
        (uint8_t*)out, (const float*)depth, (const float*)T_L_C,
        (const int*)slot_grid, (const int*)origin,
        (const uint8_t*)high_confidence, c, H, W, s, Ws, D0, D1, D2, cap);
  else
    detect_dynamic_kernel<false><<<grid, block, 0, st>>>(
        (uint8_t*)out, (const float*)depth, (const float*)T_L_C,
        (const int*)slot_grid, (const int*)origin,
        (const uint8_t*)high_confidence, c, H, W, s, Ws, D0, D1, D2, cap);
  return (int)cudaGetLastError();
}

extern "C" const char* detect_dynamic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
