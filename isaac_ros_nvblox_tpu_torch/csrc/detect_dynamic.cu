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
//   per output pixel (v, u): the evaluated pixel (v - v % s, u - u % s) for
//   subsample s; its depth z; back-projection x = (u - cx) * (1/fx) * z,
//   y likewise; the endpoint p = T_L_C [x y z 1]; voxel g = floor(p *
//   (1/voxel)); block g >> 3, slot_grid at the block's cell; the voxel's
//   high_confidence byte. Dynamic iff the cell is inside the grid, the
//   block allocated, 0 < z <= max depth and the byte set.
//
// Layout: one thread per output pixel, writing the u8 mask directly.
//
// Bound: device memory. Each evaluated pixel reads its depth (4 B); each
// pixel writes one byte; pixels whose endpoint lands in an allocated block
// read one slot_grid entry and one high_confidence byte (a scattered
// sector, mostly L2 hits: neighbouring pixels land in the same voxels).
// About 30 flops per pixel.
//
// Rounding: built with -fmad=false; the transform's multiply-adds are the
// plain version's float64 form (projective.cuh fma_emul).

#include "projective.cuh"

namespace {

using proj::fma_emul;

struct Det {
  float fx, fy, cx, cy, rfx, rfy, rvox, max_depth;
};

__global__ void detect_dynamic_kernel(uint8_t* __restrict__ out,
                                      const float* __restrict__ depth,
                                      const float* __restrict__ T,
                                      const int* __restrict__ slot_grid,
                                      const int* __restrict__ origin,
                                      const uint8_t* __restrict__ hc, Det c,
                                      int H, int W, int s, int D0, int D1,
                                      int D2, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int v = i / W, u = i % W;
  const int vs = v - v % s, us = u - u % s;
  const float z = __ldg(depth + (size_t)vs * W + us);
  uint8_t dyn = 0;
  if (z > 0.0f && z <= c.max_depth) {
    const float x = ((float)us - c.cx) * c.rfx * z;
    const float y = ((float)vs - c.cy) * c.rfy * z;
    int g[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float p = x * __ldg(T + 4 * r);
      p = fma_emul(y, __ldg(T + 4 * r + 1), p);
      p = fma_emul(z, __ldg(T + 4 * r + 2), p);
      p = p + __ldg(T + 4 * r + 3);
      const float f = floorf(p * c.rvox);
      g[r] = (int)fminf(fmaxf(f, -1073741824.0f), 1073741824.0f);
    }
    const int c0 = (g[0] >> 3) - __ldg(origin + 0);
    const int c1 = (g[1] >> 3) - __ldg(origin + 1);
    const int c2 = (g[2] >> 3) - __ldg(origin + 2);
    if (c0 >= 0 && c0 < D0 && c1 >= 0 && c1 < D1 && c2 >= 0 && c2 < D2) {
      const int slot = __ldg(slot_grid + ((size_t)c0 * D1 + c1) * D2 + c2);
      if (slot >= 0) {
        const int vox = ((g[0] & 7) * 8 + (g[1] & 7)) * 8 + (g[2] & 7);
        dyn = __ldg(hc + (size_t)min(slot, cap - 1) * 512 + vox) ? 1 : 0;
      }
    }
  }
  out[i] = dyn;
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
  const long long n = (long long)H * W;
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL || subsample < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  detect_dynamic_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                          (cudaStream_t)stream>>>(
      (uint8_t*)out, (const float*)depth, (const float*)T_L_C,
      (const int*)slot_grid, (const int*)origin,
      (const uint8_t*)high_confidence, c, H, W, subsample, D0, D1, D2, cap);
  return (int)cudaGetLastError();
}

extern "C" const char* detect_dynamic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
