// Marching cubes over a batch of pool rows with the +1 halo read in place.
//
// Replaces the TPU kernel isaac_ros_nvblox_tpu/ops/mesh_pallas.py::
// _make_kernel -> kernel / _mc_body (launched by marching_cubes_fused).
// The TPU version gathers the 8 halo rows of each block into dense
// (N, 8, 512) arrays, assembles cube corners with lane rolls and looks the
// 256-case table up with one-hot matrix products over 8 blocks at a time.
// Here each block reads its own row and its 7 positive-octant neighbour
// rows through nbr8 directly, and each thread handles one cube:
//
//   block: live = valid && the 8 halo rows hold both a negative and a
//     non-negative TSDF value among voxels with weight >= min_weight
//     (an absent neighbour, nbr8 = -1, has weight 0 and reads row 0's
//     values, as the reference's clamped gather does); a block that is
//     not live writes sentinel -1 vertices, zero colors, a zero table.
//   cube (lx, ly, lz): corner c = (c&1, c>>1&1, c>>2&1) reads voxel
//     (lx+cx, ly+cy, lz+cz) of the block or of the neighbour it carries
//     into; cube_ok = min corner weight >= min_weight; config = sum over
//     corners of (d < 0) << c, 0 where not cube_ok; table row of config:
//     count (times cube_ok) and 15 edge ids.
//   edge e (corners a, b): t = clip(da / (|da-db| > 1e-12 ? da-db : 1e-12),
//     0, 1); vertex = pa + t (pb - pa) + cube base + 0.5 (block-local voxel
//     units); color = ca + t (cb - ca).
//
// Outputs, bfloat16 rounded to nearest even: verts [N, 3, 16, 512] (rows
// 0..11 one vertex per cube edge, rows 12..15 sentinel -1), colors
// [N, 3, 16, 512] (rows 12..15 zero), table [N, 16, 512]. The per-slot
// triangle soup is laid out later at publish cadence (ops/mesh_cuda.py
// resolve_edge_soup).
//
// Layout: one CTA per batch block, one thread per cube. The 256 x 16 table
// (count + edge ids) and the 12 edges' corner pairs sit in shared memory
// (4 KB), loaded from a device array the wrapper builds from
// ops/mesh_tables.py.
//
// Bound: device memory, dominated by the 112 KB of bf16 outputs a live
// block writes (48 KB verts, 48 KB colors, 16 KB table) against the 10 to
// 40 KB of halo rows it reads; ~40 flops per edge.
//
// Rounding: built with -fmad=false and IEEE division, so each operation
// rounds as in the plain version (ops/mesh_cuda.py::marching_cubes_plain);
// the color interpolation spells out its contraction (fma_emul).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 512;
constexpr int KP = 16;              // table / vertex rows per cube
constexpr int LUT = 256 * KP + 24;  // table + edge corner pairs

__device__ __forceinline__ float fma_emul(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// Index of the octant direction (kx, ky, kz) in nbr8's order:
// (0,0,0) (1,0,0) (0,1,0) (0,0,1) (1,1,0) (1,0,1) (0,1,1) (1,1,1).
__device__ __forceinline__ int octant(int kx, int ky, int kz) {
  const int s = kx + ky + kz;
  if (s == 0) return 0;
  if (s == 3) return 7;
  if (s == 1) return kx ? 1 : (ky ? 2 : 3);
  return !kz ? 4 : (!ky ? 5 : 6);
}

template <bool COLOR>
__global__ void __launch_bounds__(512)
marching_cubes_kernel(const float* __restrict__ D, const float* __restrict__ W,
                      const float* __restrict__ CR,
                      const float* __restrict__ CG,
                      const float* __restrict__ CB,
                      const int* __restrict__ nbr8,
                      const int* __restrict__ valid,
                      const int8_t* __restrict__ lut,
                      __nv_bfloat16* __restrict__ vout,
                      __nv_bfloat16* __restrict__ cout,
                      __nv_bfloat16* __restrict__ tout, int cap,
                      float min_weight) {
  __shared__ int8_t s_lut[LUT];
  __shared__ int s_nbr[8];
  const int b = blockIdx.x;
  const int v = threadIdx.x;
  for (int i = v; i < LUT; i += V) s_lut[i] = lut[i];
  if (v < 8) s_nbr[v] = nbr8[8 * b + v];
  __syncthreads();

  // Row base offsets of the 8 halo rows; absent rows read row 0.
  size_t row[8];
  bool present[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int s = s_nbr[r];
    present[r] = s >= 0;
    row[r] = (size_t)min(max(s, 0), cap - 1) * V;
  }

  // Halo pre-filter: a sign crossing among observed voxels of the 8 rows.
  bool neg = false, pos = false;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float w = present[r] ? W[row[r] + v] : 0.0f;
    const float d = D[row[r] + v];
    if (w >= min_weight) {
      neg |= d < 0.0f;
      pos |= d >= 0.0f;
    }
  }
  const bool any_neg = __syncthreads_or(neg);
  const bool any_pos = __syncthreads_or(pos);
  const bool live = valid[b] != 0 && any_neg && any_pos;

  __nv_bfloat16* vo = vout + (size_t)b * 3 * KP * V + v;
  __nv_bfloat16* co = COLOR ? cout + (size_t)b * 3 * KP * V + v : nullptr;
  __nv_bfloat16* to = tout + (size_t)b * KP * V + v;
  const __nv_bfloat16 minus_one = __float2bfloat16_rn(-1.0f);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if (!live) {
    for (int k = 0; k < 3 * KP; ++k) vo[k * V] = minus_one;
    if (COLOR)
      for (int k = 0; k < 3 * KP; ++k) co[k * V] = zero;
    for (int k = 0; k < KP; ++k) to[k * V] = zero;
    return;
  }

  const int lx = v >> 6, ly = (v >> 3) & 7, lz = v & 7;
  float cd[8], cwt[8], cc[3][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int px = lx + (c & 1), py = ly + ((c >> 1) & 1),
              pz = lz + ((c >> 2) & 1);
    const int r = octant(px >> 3, py >> 3, pz >> 3);
    const size_t off = row[r] + (size_t)((px & 7) * 64 + (py & 7) * 8 + (pz & 7));
    cd[c] = D[off];
    cwt[c] = present[r] ? W[off] : 0.0f;
    if (COLOR) {
      cc[0][c] = CR[off];
      cc[1][c] = CG[off];
      cc[2][c] = CB[off];
    }
  }
  float wmin = cwt[0];
#pragma unroll
  for (int c = 1; c < 8; ++c) wmin = fminf(wmin, cwt[c]);
  const bool cube_ok = wmin >= min_weight;
  int config = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) config |= (cd[c] < 0.0f ? 1 : 0) << c;
  if (!cube_ok) config = 0;

  const int8_t* tri = s_lut + config * KP;
  to[0] = __float2bfloat16_rn(cube_ok ? (float)tri[0] : 0.0f);
#pragma unroll
  for (int k = 1; k < KP; ++k) to[k * V] = __float2bfloat16_rn((float)tri[k]);

  const float base[3] = {(float)lx, (float)ly, (float)lz};
  const int8_t* ea = s_lut + 256 * KP;
  const int8_t* eb = ea + 12;
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    const int a = ea[e], bb = eb[e];
    const float da = cd[a], db = cd[bb];
    const float denom = da - db;
    float t = da / (fabsf(denom) > 1e-12f ? denom : 1e-12f);
    t = fminf(fmaxf(t, 0.0f), 1.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float pa = (float)((a >> k) & 1), pb = (float)((bb >> k) & 1);
      const float comp = pa + t * (pb - pa);
      vo[(k * KP + e) * V] = __float2bfloat16_rn(comp + base[k] + 0.5f);
      if (COLOR) {
        const float ca = cc[k][a], cb = cc[k][bb];
        co[(k * KP + e) * V] = __float2bfloat16_rn(fma_emul(t, cb - ca, ca));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int e = 12; e < KP; ++e) {
      vo[(k * KP + e) * V] = minus_one;
      if (COLOR) co[(k * KP + e) * V] = zero;
    }
  }
}

}  // namespace

// tsdf/weight: f32[cap, 512]; color: three f32[cap, 512] planes or null
// (with_color = 0); nbr8: i32[n, 8]; valid: i32[n]; lut: int8[256*16 + 24]
// (per config: count then 15 edge ids, -1 padded; then the 12 edges' first
// and second corners). Outputs bf16 as described above.
extern "C" int marching_cubes(const void* tsdf, const void* weight,
                              const void* cr, const void* cg, const void* cb,
                              const void* nbr8, const void* valid,
                              const void* lut, void* verts, void* colors,
                              void* table, int n, int cap, float min_weight,
                              int with_color, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* D = (const float*)tsdf;
  const float* Wt = (const float*)weight;
  if (with_color) {
    marching_cubes_kernel<true><<<n, V, 0, s>>>(
        D, Wt, (const float*)cr, (const float*)cg, (const float*)cb,
        (const int*)nbr8, (const int*)valid, (const int8_t*)lut,
        (__nv_bfloat16*)verts, (__nv_bfloat16*)colors,
        (__nv_bfloat16*)table, cap, min_weight);
  } else {
    marching_cubes_kernel<false><<<n, V, 0, s>>>(
        D, Wt, nullptr, nullptr, nullptr, (const int*)nbr8,
        (const int*)valid, (const int8_t*)lut, (__nv_bfloat16*)verts,
        nullptr, (__nv_bfloat16*)table, cap, min_weight);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* marching_cubes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
