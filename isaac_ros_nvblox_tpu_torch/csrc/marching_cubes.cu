// Marching cubes over a batch of pool rows with the +1 halo staged in
// shared memory.
//
// Replaces the TPU kernel isaac_ros_nvblox_tpu/ops/mesh_pallas.py::
// _make_kernel -> kernel / _mc_body (launched by marching_cubes_fused).
// The TPU version gathers the 8 halo rows of each block into dense
// (N, 8, 512) arrays, assembles cube corners with lane rolls and looks the
// 256-case table up with one-hot matrix products over 8 blocks at a time.
// What each block computes:
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
// What bounds it on the H100: the 112 KB of bf16 a row writes (57 MB for
// the mesh step's 512-row batch: a 17 us byte bound; three torch fills of
// the outputs take about 20 us), then the float64 conversions of the color
// interpolation (16 a clock per SM, ~120 a cube) and the 32 KB of halo
// rows a row reads (mostly L2 hits). The one-CTA-per-row kernel this
// replaces ran 512 threads, 2 CTAs per SM (57 registers and 208 bytes of
// stack: corners indexed by runtime edge ids lived in local memory) and
// 2-byte stores: 62 us a batch, 31 us for its sentinel fill alone.
//
// Design:
//   * a persistent grid of 256-thread CTAs (4 per SM: 64 registers with
//     color, 60 without) walks the batch; at the mesh step's 512 rows
//     every CTA takes one row, so the halo copy is not double-buffered:
//     the 4 CTAs of an SM overlap one another's loads and stores;
//   * the 4 KB table is staged once per CTA with 16-byte loads;
//   * a row's 8 halo rows of TSDF and weight are read whole with 16-byte
//     loads: they feed the sign pre-filter and the 9x9x9 tile of corners
//     in shared memory; the colors' tile takes the own row with 16-byte
//     loads and the 217 face, edge and corner voxels one at a time;
//   * a thread owns the 8 cubes of a z-column (lx, ly) and 3 of the 12
//     edges (and 4 of the 16 table rows), so each output row it writes is
//     8 consecutive bf16, one 16-byte store; corner reads index the tile
//     with runtime offsets, never a local array;
//   * dead and padding rows, and rows 12..15, are 16-byte stores of -1 / 0.
//
// Rounding: built with -fmad=false and IEEE division, so each operation
// rounds as in the plain version (ops/mesh_cuda.py::marching_cubes_plain);
// the color interpolation spells out its contraction (fma_emul).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "projective.cuh"

namespace {

constexpr int V = 512;
constexpr int KP = 16;              // table / vertex rows per cube
// The table (count + 15 edge ids per config) and the 12 edges' corner
// pairs, 4 120 bytes, in whole 16-byte words.
constexpr int LUT_PAD = (256 * KP + 24 + 15) / 16 * 16;
constexpr int T = 256;              // threads per CTA
constexpr int S = 9;                // tile side: the block + 1 halo voxel
constexpr int TILE = S * S * S;
constexpr int HALO = S * S + (S - 1) * S + (S - 1) * (S - 1);  // 217
constexpr unsigned BF16_MINUS_ONE2 = 0xBF80BF80u;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ int tile_index(int x, int y, int z) {
  return (x * S + y) * S + z;
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

// The direction of octant r, bits x | y << 1 | z << 2.
__device__ __forceinline__ int octant_bits(int r) {
  return (int)((0x76534210u >> (4 * r)) & 7);
}

// The first n 16-byte words of `out` set to `word` x4.
__device__ __forceinline__ void fill_words(__nv_bfloat16* out, int n,
                                           unsigned word) {
  uint4* o = reinterpret_cast<uint4*>(out);
  const uint4 w = make_uint4(word, word, word, word);
  for (int i = threadIdx.x; i < n; i += T) o[i] = w;
}

template <bool COLOR>
__global__ void __launch_bounds__(T, 4)
marching_cubes_kernel(const float* __restrict__ D, const float* __restrict__ W,
                      const float* __restrict__ CR,
                      const float* __restrict__ CG,
                      const float* __restrict__ CB,
                      const int* __restrict__ nbr8,
                      const int* __restrict__ valid,
                      const int8_t* __restrict__ lut,
                      __nv_bfloat16* __restrict__ vout,
                      __nv_bfloat16* __restrict__ cout,
                      __nv_bfloat16* __restrict__ tout, int n, int cap,
                      float min_weight) {
  __shared__ __align__(16) int8_t s_lut[LUT_PAD];
  __shared__ float s_d[TILE], s_w[TILE];
  __shared__ float s_c[COLOR ? 3 : 1][COLOR ? TILE : 1];
  // Per row, by the parity of the CTA's step: clamped slots, presence bits
  // and the valid flag (a step's barrier orders the writes of the next).
  __shared__ int s_slot[2][8];
  __shared__ int s_meta[2][2];
  const int tid = threadIdx.x;
  for (int i = tid; i < LUT_PAD / 16; i += T)
    reinterpret_cast<int4*>(s_lut)[i] =
        __ldg(reinterpret_cast<const int4*>(lut) + i);

  const int col = tid & 63, g = tid >> 6;
  const int lx = col >> 3, ly = col & 7;
  const float mw = min_weight;
  int step = 0;
  for (int b = blockIdx.x; b < n; b += gridDim.x, ++step) {
    const int p = step & 1;
    if (tid < 8) {
      const int s = __ldg(nbr8 + 8 * (size_t)b + tid);
      s_slot[p][tid] = min(max(s, 0), cap - 1);
      const unsigned pres = __ballot_sync(0xffu, s >= 0);
      if (tid == 0) {
        s_meta[p][0] = (int)pres;
        s_meta[p][1] = __ldg(valid + b);
      }
    }
    __syncthreads();
    __nv_bfloat16* vo = vout + (size_t)b * 3 * KP * V;
    __nv_bfloat16* co = COLOR ? cout + (size_t)b * 3 * KP * V : nullptr;
    __nv_bfloat16* to = tout + (size_t)b * KP * V;
    bool live = s_meta[p][1] != 0;
    if (live) {
      // The 8 halo rows of TSDF and weight, whole: the pre-filter, and
      // the tile voxels each row holds.
      const unsigned pres = (unsigned)s_meta[p][0];
      bool neg = false, pos = false;
      for (int i = tid; i < 8 * (V / 4); i += T) {
        const int r = i >> 7, lane = (i & 127) * 4;
        const size_t off = (size_t)s_slot[p][r] * V + lane;
        const float4 d = __ldg(reinterpret_cast<const float4*>(D + off));
        float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if ((pres >> r) & 1)
          w = __ldg(reinterpret_cast<const float4*>(W + off));
        const float dv[4] = {d.x, d.y, d.z, d.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
        const int k = octant_bits(r);
        const int x = (k & 1) * 8 + (lane >> 6);
        const int y = ((k >> 1) & 1) * 8 + ((lane >> 3) & 7);
        const int z0 = ((k >> 2) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (wv[q] >= mw) {
            neg |= dv[q] < 0.0f;
            pos |= dv[q] >= 0.0f;
          }
          if (x < S && y < S && z0 + q < S) {
            s_d[tile_index(x, y, z0 + q)] = dv[q];
            s_w[tile_index(x, y, z0 + q)] = wv[q];
          }
        }
      }
      if (COLOR) {
        const size_t own = (size_t)s_slot[p][0] * V;
        for (int i = tid; i < 3 * (V / 4); i += T) {
          const int ch = i >> 7, lane = (i & 127) * 4;
          const float* plane = ch == 0 ? CR : (ch == 1 ? CG : CB);
          const float4 c =
              __ldg(reinterpret_cast<const float4*>(plane + own + lane));
          float* dst = s_c[ch] + tile_index(lane >> 6, (lane >> 3) & 7,
                                            lane & 7);
          dst[0] = c.x;
          dst[1] = c.y;
          dst[2] = c.z;
          dst[3] = c.w;
        }
        for (int i = tid; i < 3 * HALO; i += T) {
          const int ch = i / HALO, h = i - ch * HALO;
          int x, y, z;
          if (h < S * S) {
            x = S - 1, y = h / S, z = h % S;
          } else if (h < S * S + (S - 1) * S) {
            const int j = h - S * S;
            x = j / S, y = S - 1, z = j % S;
          } else {
            const int j = h - S * S - (S - 1) * S;
            x = j / (S - 1), y = j % (S - 1), z = S - 1;
          }
          const int r = octant(x >> 3, y >> 3, z >> 3);
          const float* plane = ch == 0 ? CR : (ch == 1 ? CG : CB);
          s_c[ch][tile_index(x, y, z)] =
              __ldg(plane + (size_t)s_slot[p][r] * V +
                    ((x & 7) * 64 + (y & 7) * 8 + (z & 7)));
        }
      }
      const bool any_neg = __syncthreads_or(neg);
      const bool any_pos = __syncthreads_or(pos);
      live = any_neg && any_pos;
    }
    if (!live) {
      fill_words(vo, 3 * KP * V / 8, BF16_MINUS_ONE2);
      if (COLOR) fill_words(co, 3 * KP * V / 8, 0u);
      fill_words(to, KP * V / 8, 0u);
      continue;
    }

    // Configs of the column's 8 cubes, the tile read one z level at a time.
    int cfg[8];
    unsigned ok_bits = 0;
    {
      float d0[4], w0[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = tile_index(lx + (c & 1), ly + (c >> 1), 0);
        d0[c] = s_d[i];
        w0[c] = s_w[i];
      }
#pragma unroll
      for (int z = 0; z < 8; ++z) {
        float d1[4], w1[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = tile_index(lx + (c & 1), ly + (c >> 1), z + 1);
          d1[c] = s_d[i];
          w1[c] = s_w[i];
        }
        int config = 0;
        float wmin = w0[0];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          config |= (d0[c] < 0.0f ? 1 : 0) << c;
          config |= (d1[c] < 0.0f ? 1 : 0) << (c + 4);
          wmin = fminf(wmin, fminf(w0[c], w1[c]));
        }
        const bool ok = wmin >= mw;
        cfg[z] = ok ? config : 0;
        ok_bits |= (ok ? 1u : 0u) << z;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          d0[c] = d1[c];
          w0[c] = w1[c];
        }
      }
    }

    // Table rows 4g .. 4g+3.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * g + kk;
      unsigned word[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int z = 2 * h + u;
          const bool zero = k == 0 && !((ok_bits >> z) & 1);
          v[u] = zero ? 0.0f : (float)s_lut[cfg[z] * KP + k];
        }
        word[h] = pack_bf16(v[0], v[1]);
      }
      reinterpret_cast<uint4*>(to + k * V)[col] =
          make_uint4(word[0], word[1], word[2], word[3]);
    }

    // Edges 3g .. 3g+2: vertex and color planes, 8 cubes a store.
    const int8_t* ea = s_lut + 256 * KP;
    for (int ee = 0; ee < 3; ++ee) {
      const int e = 3 * g + ee;
      const int a = ea[e], bb = ea[12 + e];
      const int off_a = tile_index(lx + (a & 1), ly + ((a >> 1) & 1),
                                   (a >> 2) & 1);
      const int off_b = tile_index(lx + (bb & 1), ly + ((bb >> 1) & 1),
                                   (bb >> 2) & 1);
      float pa[3], pb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pa[k] = (float)((a >> k) & 1);
        pb[k] = (float)((bb >> k) & 1);
      }
      float t[8];
#pragma unroll
      for (int z = 0; z < 8; ++z) {
        const float da = s_d[off_a + z], db = s_d[off_b + z];
        const float denom = da - db;
        t[z] = fminf(fmaxf(da / (fabsf(denom) > 1e-12f ? denom : 1e-12f),
                           0.0f), 1.0f);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        unsigned vw[4], cw[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float vert[2], color[2] = {0.0f, 0.0f};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int z = 2 * h + u;
            const float base = k == 0 ? (float)lx : (k == 1 ? (float)ly
                                                            : (float)z);
            const float comp = pa[k] + t[z] * (pb[k] - pa[k]);
            vert[u] = comp + base + 0.5f;
            if (COLOR) {
              const float ca = s_c[k][off_a + z], cb = s_c[k][off_b + z];
              color[u] = proj::fma_emul(t[z], cb - ca, ca);
            }
          }
          vw[h] = pack_bf16(vert[0], vert[1]);
          cw[h] = pack_bf16(color[0], color[1]);
        }
        reinterpret_cast<uint4*>(vo + (k * KP + e) * V)[col] =
            make_uint4(vw[0], vw[1], vw[2], vw[3]);
        if (COLOR)
          reinterpret_cast<uint4*>(co + (k * KP + e) * V)[col] =
              make_uint4(cw[0], cw[1], cw[2], cw[3]);
      }
    }
    // Rows 12 + g: sentinel vertices, zero colors.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 m1 = make_uint4(BF16_MINUS_ONE2, BF16_MINUS_ONE2,
                                  BF16_MINUS_ONE2, BF16_MINUS_ONE2);
      reinterpret_cast<uint4*>(vo + (k * KP + 12 + g) * V)[col] = m1;
      if (COLOR)
        reinterpret_cast<uint4*>(co + (k * KP + 12 + g) * V)[col] =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <bool COLOR>
cudaError_t launch(const float* D, const float* Wt, const float* cr,
                   const float* cg, const float* cb, const int* nbr8,
                   const int* valid, const int8_t* lut, __nv_bfloat16* verts,
                   __nv_bfloat16* colors, __nv_bfloat16* table, int n,
                   int cap, float min_weight, cudaStream_t s) {
  const int grid = proj::persistent_grid<marching_cubes_kernel<COLOR>>(T, n);
  marching_cubes_kernel<COLOR><<<grid, T, 0, s>>>(
      D, Wt, cr, cg, cb, nbr8, valid, lut, verts, colors, table, n, cap,
      min_weight);
  return cudaGetLastError();
}

}  // namespace

// tsdf/weight: f32[cap, 512]; color: three f32[cap, 512] planes or null
// (with_color = 0); nbr8: i32[n, 8]; valid: i32[n]; lut: int8[4128] (per
// config: count then 15 edge ids, -1 padded; then the 12 edges' first and
// second corners; zero padded to whole 16-byte words). Every pointer
// 16-byte aligned. Outputs bf16 as described above.
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
  if (with_color)
    return (int)launch<true>(
        D, Wt, (const float*)cr, (const float*)cg, (const float*)cb,
        (const int*)nbr8, (const int*)valid, (const int8_t*)lut,
        (__nv_bfloat16*)verts, (__nv_bfloat16*)colors,
        (__nv_bfloat16*)table, n, cap, min_weight, s);
  return (int)launch<false>(D, Wt, nullptr, nullptr, nullptr,
                            (const int*)nbr8, (const int*)valid,
                            (const int8_t*)lut, (__nv_bfloat16*)verts,
                            nullptr, (__nv_bfloat16*)table, n, cap,
                            min_weight, s);
}

extern "C" const char* marching_cubes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
