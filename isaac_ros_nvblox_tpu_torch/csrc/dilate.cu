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
// What bounds it on the H100: the grid read once and written once (11.8 MB
// on the dynamic path's 20x16x9-cell region, a 3.52 us byte bound; a
// clone of it takes 1.2-2.9 us, the less where the grid is still in L2). The one-CTA-per-cell kernel this replaces
// gathered a 10^3 halo with 1 000 scalar loads a cell (32-byte runs at
// best, index arithmetic for each) and took 27 shared-memory reads an
// output: 18.6 us, latency-bound at 4 CTAs of 512 per SM.
//
// Design: a CTA of 128 threads walks a segment of at most 4 cells of one
// (cx, cy) line along z. Its 100 loading threads each own one z-column of
// the cell's 10x10 (x, y) tile (the cell and a one-voxel x/y halo from the
// 8 neighbouring lines): 8 consecutive floats, two 16-byte loads. Walking
// z, a column's z halo is the last value of the previous cell's column and
// the first of the next one, both already in registers, so nothing is
// read twice along z; the column two cells ahead is loaded while the
// current one is reduced. The z maximum is taken in registers, written to
// a double-buffered 10x10x8 tile in shared memory (one barrier a cell),
// and each thread then takes the y and x maxima of 4 outputs there (nine
// 16-byte shared reads) and writes them with one 16-byte store. Each cell
// is read from device memory once for its own output and for its x/y
// neighbours' halos (1.56x the bytes, L2 hits).

#include <cuda_runtime.h>

namespace {

constexpr int T = 128;       // threads per CTA: 4 outputs each
constexpr int P = 10;        // tile side in x and y: cell + one-voxel halo
constexpr int COLS = P * P;  // loading threads: one z-column each
constexpr int SEG = 4;       // most cells a CTA walks along z

struct Column {
  float v[8];
};

__device__ __forceinline__ Column load_column(const float* p, bool in,
                                              float fill) {
  Column c;
  if (in) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    c.v[0] = a.x, c.v[1] = a.y, c.v[2] = a.z, c.v[3] = a.w;
    c.v[4] = b.x, c.v[5] = b.y, c.v[6] = b.z, c.v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) c.v[i] = fill;
  }
  return c;
}

__global__ void __launch_bounds__(T)
dilate_dense_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int Cx, int Cy, int Cz, int n_seg, int seg_len,
                    float fill) {
  __shared__ __align__(16) float s[2][COLS][8];
  const int item = blockIdx.x;
  const int seg = item % n_seg;
  const int cy = (item / n_seg) % Cy;
  const int cx = item / (n_seg * Cy);
  const int z0 = seg * seg_len;
  const int z1 = min(Cz, z0 + seg_len);
  const int tid = threadIdx.x;

  // This thread's column of the tile: voxel (x, y) of the cell, -1 and 8
  // reaching into the neighbouring lines.
  const int x = tid / P - 1, y = tid % P - 1;
  const int ccx = cx + (x < 0 ? -1 : (x > 7 ? 1 : 0));
  const int ccy = cy + (y < 0 ? -1 : (y > 7 ? 1 : 0));
  const bool loads = tid < COLS;
  const bool in_xy = loads && ccx >= 0 && ccx < Cx && ccy >= 0 && ccy < Cy;
  const float* line = in + ((size_t)min(max(ccx, 0), Cx - 1) * Cy +
                            min(max(ccy, 0), Cy - 1)) * Cz * 512 +
                      ((x & 7) * 8 + (y & 7)) * 8;
  float prev = fill;  // the previous cell's last value of this column
  if (in_xy && z0 > 0) prev = __ldg(line + (size_t)(z0 - 1) * 512 + 7);
  Column cur = load_column(line + (size_t)z0 * 512, in_xy, fill);
  Column nxt = load_column(line + (size_t)(z0 + 1) * 512,
                           in_xy && z0 + 1 < Cz, fill);

  // This thread's 4 outputs: voxels (ox, oy, 4h .. 4h+3).
  const int ox = tid >> 4, oy = (tid >> 1) & 7, h = tid & 1;
  for (int cz = z0, buf = 0; cz < z1; ++cz, buf ^= 1) {
    const Column ahead = load_column(line + (size_t)(cz + 2) * 512,
                                     in_xy && cz + 2 < Cz && cz + 1 < z1,
                                     fill);
    if (loads) {
      float m[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float lo = i == 0 ? prev : cur.v[i - 1];
        const float hi = i == 7 ? nxt.v[0] : cur.v[i + 1];
        m[i] = fmaxf(fmaxf(lo, cur.v[i]), hi);
      }
      float4* dst = reinterpret_cast<float4*>(s[buf][tid]);
      dst[0] = make_float4(m[0], m[1], m[2], m[3]);
      dst[1] = make_float4(m[4], m[5], m[6], m[7]);
    }
    __syncthreads();
    float4 r =
        reinterpret_cast<const float4*>(s[buf][(ox + 1) * P + oy + 1])[h];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float4 q = reinterpret_cast<const float4*>(
            s[buf][(ox + dx) * P + oy + dy])[h];
        r.x = fmaxf(r.x, q.x);
        r.y = fmaxf(r.y, q.y);
        r.z = fmaxf(r.z, q.z);
        r.w = fmaxf(r.w, q.w);
      }
    }
    const size_t cell = ((size_t)cx * Cy + cy) * Cz + cz;
    reinterpret_cast<float4*>(out + cell * 512)[tid] = r;
    prev = cur.v[7];
    cur = nxt;
    nxt = ahead;
  }
}

}  // namespace

// in, out: f32[Cx, Cy, Cz, 512], 16-byte aligned.
extern "C" int dilate_dense(const void* in, void* out, int Cx, int Cy, int Cz,
                            float fill, void* stream) {
  const long long n_cells = (long long)Cx * Cy * Cz;
  if (n_cells <= 0) return 0;
  if (n_cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_seg = (Cz + SEG - 1) / SEG;
  const int seg_len = (Cz + n_seg - 1) / n_seg;
  const long long items = (long long)Cx * Cy * n_seg;
  dilate_dense_kernel<<<(unsigned)items, T, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, Cx, Cy, Cz, n_seg, seg_len, fill);
  return (int)cudaGetLastError();
}

extern "C" const char* dilate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
