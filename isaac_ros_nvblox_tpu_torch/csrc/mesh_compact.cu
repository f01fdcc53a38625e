// Per-block CSR compaction of the mesh soup on the card, before the
// readback.
//
// Replaces no TPU kernel. It replaces the host's half of the mesh publish:
// the copy of each live batch row's whole padded soup (f32 world
// vertices, mask and colors, ~205 KB a block) and the native CSR pass
// over it (native/mesh_native.cc mesh_block_offsets / mesh_block_compact,
// reached through native.compact_mesh_blocks). With it only the live
// vertices cross to the host, already in meters and in the order that pass
// gives (ops/mesh_cuda.py::mesh_compact_plain is its plain version):
//
//   row i, lane v (cube), slot k (0..15): live where the x plane's vertex
//     verts[i, 0, k, v] >= 0 (empty slots hold the sentinel -1);
//   offsets[i]: the live slots of rows 0..i-1, an exclusive scan over
//     every row of the batch (rows past the live ones are all sentinel
//     and count 0);
//   block i's vertices at [offsets[i], offsets[i+1]) in v-major, then
//     slot, order; each is (v + b * 8) * voxel in float32 for the block
//     index b, rounded at the add and at the multiply (-fmad=false and
//     the _rn intrinsics: no contraction), as local_to_world_verts
//     computes it; colors are the bf16 values widened to float32.
//
// Inputs: the resolved soup of update_mesh_dirty_device, bf16 verts and
// colors [N, 3, 16, 512] and i32 block indices [N, 3]. Outputs: offsets
// i64[N + 1]; for the first n_live rows the CSR ints i64[n_live + 1 +
// 3 n_live] (offsets, then the block indices), f32 vertices [total, 3]
// and colors [total, 3].
//
// What bounds it on the H100: bytes. Each row's x plane (16 KB) is read
// twice, once to count and once to place; the y and z planes and the
// colors only in live slots (~180 of 8 192 a block a surface crosses);
// 24 bytes written a live vertex. A mesh step's 512-row batch with 90 522
// live vertices needs 11.5 MB, 3.4 us at 3.35 TB/s; the three launches
// took 15.6 us of device time together on an H100 80GB HBM3 (700 W), so
// launches, not bytes, set their pace. The readback they shorten went
// from 44 ms (105 MB through pageable memory) to 0.62 ms (2.2 MB).
//
// Design:
//   * mesh_count_kernel: one 512-thread CTA a row, a thread a cube lane;
//     each thread counts its lane's live slots (16 two-byte loads,
//     coalesced across the warp), a CTA reduction gives the row's count;
//   * mesh_scan_kernel: one 1024-thread CTA scans the counts into
//     offsets, 1024 rows a step with a carry;
//   * mesh_compact_kernel: one CTA a live row again; the lanes' counts
//     are scanned across the CTA (warp shuffles, then the 16 warp sums),
//     so each thread knows where its lane's vertices start and writes
//     them in slot order, reading y, z and the colors of live slots only.
//     The CTA also copies its row's offset and block index into the CSR
//     ints, so that one read brings both to the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 512;               // cube lanes a block
constexpr int K = 16;                // slots a lane (15 + 1 padding)
constexpr int T = V;                 // threads a CTA: one a lane
constexpr int WARPS = T / 32;
constexpr int SCAN_T = 1024;

__device__ __forceinline__ float bf16_to_float(uint16_t b) {
  return __uint_as_float((unsigned)b << 16);
}

// Bit k set where slot k of the lane's x plane (`x` = the row's plane 0)
// holds a vertex (>= 0; NaN is no vertex, as in the plain version).
__device__ __forceinline__ unsigned live_bits(const uint16_t* __restrict__ x,
                                              int lane) {
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    bits |= (unsigned)(bf16_to_float(__ldg(x + k * V + lane)) >= 0.f) << k;
  return bits;
}

// Exclusive prefix of `v` over the CTA's T threads; `*total` gets the sum.
__device__ __forceinline__ int cta_exclusive_scan(int v, int* total) {
  __shared__ int s_warp[WARPS];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < WARPS ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < WARPS) s_warp[lane] = wi - w;
    if (lane == WARPS - 1) s_total = wi;
  }
  __syncthreads();
  *total = s_total;
  return s_warp[warp] + inc - v;
}

__global__ void __launch_bounds__(T)
mesh_count_kernel(const uint16_t* __restrict__ verts,
                  long long* __restrict__ offsets) {
  const int row = blockIdx.x;
  const uint16_t* x = verts + (size_t)row * 3 * K * V;
  int total;
  cta_exclusive_scan(__popc(live_bits(x, threadIdx.x)), &total);
  if (threadIdx.x == 0) offsets[row + 1] = total;
}

// offsets[1..n] hold the rows' counts on entry, their inclusive sums on
// exit; offsets[0] = 0.
__global__ void __launch_bounds__(SCAN_T)
mesh_scan_kernel(long long* __restrict__ offsets, int n) {
  __shared__ long long s_warp[SCAN_T / 32];
  __shared__ long long s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_carry = 0;
    offsets[0] = 0;
  }
  for (int base = 0; base < n; base += SCAN_T) {
    const int i = base + threadIdx.x;
    const long long v = i < n ? offsets[i + 1] : 0;
    long long inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const long long w = s_warp[lane];
      long long wi = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, wi, d);
        if (lane >= d) wi += y;
      }
      s_warp[lane] = wi - w;
    }
    __syncthreads();
    const long long carry = s_carry;
    const long long out = carry + s_warp[warp] + inc;
    if (i < n) offsets[i + 1] = out;
    __syncthreads();                 // every thread has read s_carry
    if (threadIdx.x == SCAN_T - 1) s_carry = out;
    __syncthreads();
  }
}

template <bool COLOR>
__global__ void __launch_bounds__(T)
mesh_compact_kernel(const uint16_t* __restrict__ verts,
                    const uint16_t* __restrict__ colors,
                    const int* __restrict__ bidx,
                    const long long* __restrict__ offsets, int n_live,
                    float voxel, float* __restrict__ out_v,
                    float* __restrict__ out_c, long long* __restrict__ csr) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const size_t plane = (size_t)K * V;
  const uint16_t* vr = verts + (size_t)row * 3 * plane;
  const unsigned bits = live_bits(vr, lane);
  int total;
  const int pos = cta_exclusive_scan(__popc(bits), &total);
  const long long start = __ldg(offsets + row);
  if (lane < 3)
    csr[n_live + 1 + 3 * row + lane] = __ldg(bidx + 3 * row + lane);
  if (lane == 3) csr[row] = start;
  if (lane == 4 && row == n_live - 1) csr[n_live] = __ldg(offsets + n_live);
  if (!bits) return;
  float origin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    origin[c] = __fmul_rn(__int2float_rn(__ldg(bidx + 3 * row + c)), 8.f);
  const uint16_t* cr = COLOR ? colors + (size_t)row * 3 * plane : nullptr;
  size_t at = (size_t)(start + pos) * 3;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!(bits >> k & 1u)) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t src = c * plane + (size_t)k * V + lane;
      out_v[at + c] =
          __fmul_rn(__fadd_rn(bf16_to_float(__ldg(vr + src)), origin[c]),
                    voxel);
      if (COLOR) out_c[at + c] = bf16_to_float(__ldg(cr + src));
    }
    at += 3;
  }
}

}  // namespace

// verts: bf16[n, 3, 16, 512]; offsets: i64[n + 1] (out).
extern "C" int mesh_compact_offsets(const void* verts, void* offsets, int n,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long* off = (long long*)offsets;
  if (n > 0)
    mesh_count_kernel<<<n, T, 0, s>>>((const uint16_t*)verts, off);
  mesh_scan_kernel<<<1, SCAN_T, 0, s>>>(off, n);
  return (int)cudaGetLastError();
}

// verts, colors (null without color): bf16[n, 3, 16, 512], rows 0..n_live-1
// read; bidx: i32[n, 3]; offsets: i64[n + 1] from mesh_compact_offsets;
// out_v, out_c: f32[offsets[n_live], 3]; csr: i64[n_live + 1 + 3 n_live].
extern "C" int mesh_compact(const void* verts, const void* colors,
                            const void* bidx, const void* offsets, int n_live,
                            float voxel, void* out_v, void* out_c, void* csr,
                            void* stream) {
  if (n_live <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (colors)
    mesh_compact_kernel<true><<<n_live, T, 0, s>>>(
        (const uint16_t*)verts, (const uint16_t*)colors, (const int*)bidx,
        (const long long*)offsets, n_live, voxel, (float*)out_v,
        (float*)out_c, (long long*)csr);
  else
    mesh_compact_kernel<false><<<n_live, T, 0, s>>>(
        (const uint16_t*)verts, nullptr, (const int*)bidx,
        (const long long*)offsets, n_live, voxel, (float*)out_v, nullptr,
        (long long*)csr);
  return (int)cudaGetLastError();
}

extern "C" const char* mesh_compact_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
