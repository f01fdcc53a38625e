// 3x3x3 voxel max-dilation of a dense block grid.
//
// Replaces the TPU kernel isaac_ros_nvblox_tpu/ops/halo.py::_dilate_kernel
// (launched by dilate_dense_grid_pallas). It computes what that kernel and
// the reference's separable axis_max chain compute: for every voxel of a
// dense grid f32[Cx, Cy, Cz, 512] (cell-major, lane = (lx*8 + ly)*8 + lz
// inside a cell), the maximum over its 27-neighbourhood, where neighbours
// outside the grid read `fill` (0 for the freespace neighbourhood check).
// The maximum is exact, so the result equals the chain bit for bit for any
// input that holds no NaN (values >= 0 in the mapper: an occupancy
// indicator).
//
// Layout: one CTA per cell, one thread per voxel. The CTA stages the cell
// and its one-voxel halo (10x10x10 values, gathered from up to 27 cells,
// out-of-grid entries set to `fill`) in shared memory, then each thread
// reduces its 27 neighbours there. The TPU version's slab BlockSpecs, row
// padding and lane rolls have no counterpart: a CTA computes its own
// offsets and reads the neighbours directly.
//
// Bound: device memory. The grid is read once and written once (the halo
// re-reads of neighbouring cells hit L2); 26 comparisons per voxel are far
// below the byte bound.

#include <cuda_runtime.h>

namespace {

constexpr int P = 10;  // cell + one-voxel halo per axis

__global__ void __launch_bounds__(512)
dilate_dense_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int Cx, int Cy, int Cz, float fill) {
  __shared__ float s[P * P * P];
  const int cell = blockIdx.x;
  const int cz = cell % Cz;
  const int cy = (cell / Cz) % Cy;
  const int cx = cell / (Cz * Cy);
  const int NX = Cx * 8, NY = Cy * 8, NZ = Cz * 8;
  for (int i = threadIdx.x; i < P * P * P; i += blockDim.x) {
    const int hx = i / (P * P), hy = (i / P) % P, hz = i % P;
    const int gx = cx * 8 + hx - 1, gy = cy * 8 + hy - 1, gz = cz * 8 + hz - 1;
    float v = fill;
    if (gx >= 0 && gx < NX && gy >= 0 && gy < NY && gz >= 0 && gz < NZ) {
      const size_t c = ((size_t)(gx >> 3) * Cy + (gy >> 3)) * Cz + (gz >> 3);
      v = __ldg(in + c * 512 + (((gx & 7) * 8 + (gy & 7)) * 8 + (gz & 7)));
    }
    s[i] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x;
  const int lx = lane >> 6, ly = (lane >> 3) & 7, lz = lane & 7;
  float m = s[((lx + 1) * P + (ly + 1)) * P + (lz + 1)];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dz = 0; dz < 3; ++dz)
        m = fmaxf(m, s[((lx + dx) * P + (ly + dy)) * P + (lz + dz)]);
  out[(size_t)cell * 512 + lane] = m;
}

}  // namespace

extern "C" int dilate_dense(const void* in, void* out, int Cx, int Cy, int Cz,
                            float fill, void* stream) {
  const long long n_cells = (long long)Cx * Cy * Cz;
  if (n_cells <= 0) return 0;
  if (n_cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dilate_dense_kernel<<<(unsigned)n_cells, 512, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, Cx, Cy, Cz, fill);
  return (int)cudaGetLastError();
}

extern "C" const char* dilate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
