// 1-D passes of the exact banded squared Euclidean distance transform.
//
// Replace the TPU kernels isaac_ros_nvblox_tpu/ops/esdf_dense.py::
//   _pass1_kernel / _pass1_body  (edt_pass1: first pass, kernels edt_sweep_*)
//   _pass_kernel / _pass_body    (edt_pass: second and third passes,
//                                 kernel edt_minplus_kernel)
// both launched by edt_pass_blockmajor. The region is a dense grid
// f32[X, Y, Z]; a pass runs along one axis, viewed as [A, S, B] (S = scan
// axis, stride B; a line is a pair (a, b)):
//
//   edt_pass1: out[i] = d*d where d = min_{|k| <= band} in[i+k] + |k|, if
//              d <= band, else INF
//   edt_pass:  out[i] = min_{|k| <= band} in[i+k] + k*k
//
// Inputs are INF (1e12f) or non-negative integers below 2^24. Candidates
// outside the line read INF, and INF + k*k rounds back to INF for
// band <= 181, so every result is exact and independent of the order of
// evaluation.
//
// Output pruning (the reference's needed_rows): with a mask u8[ceil(X/8),
// ceil(Y/8), ceil(Z/8)] a pass writes INF at every voxel of a block whose
// mask byte is 0 and skips its work; it still writes every output.
//
// edt_pass1 (edt_sweep_*): for non-negative input the banded L1 minimum
// equals the unbanded one wherever that is <= band (its argmin lies within
// d <= band of i), and both map to INF beyond. The unbanded transform is
// min(forward, backward) with forward[i] = min_{j<=i} (in[j] - j) + i and
// backward[i] = min_{j>=i} (in[j] + j) - i: O(1) work per voxel instead of
// a scan over the band.
//   B == 1 (contiguous lines; the first pass of every path, along Z): a
//   lane owns whole 8-voxel blocks of a line, a warp one or more lines,
//   staged with coalesced loads; a segmented warp scan (shuffles) carries
//   each lane's minima to the lanes after (and before) it.
//   B > 1: one thread per line, a warp's lanes on 32 adjacent lines, so
//   each step is one coalesced 128-byte row; the forward sweep is written
//   to the output and read back by the backward sweep.
//   A line with no needed block writes INF without reading its input.
//
// edt_pass (edt_minplus_kernel): a CTA stages TL whole lines in shared
// memory, each with PADL = 8*floor(band/8)+8 INF cells at both ends (no
// bounds tests in the candidate loop) and an odd row stride (the lanes of
// a warp sit on different lines: no bank conflicts). Each thread computes
// the 8 outputs of one block of one line. For the offsets k = 8q..8q+7 it
// holds the 16 values in[i0+8q .. i0+8q+15] and in[i0-8q-8 .. i0-8q+7] in
// registers: one 8-value load per side per 8 offsets, and 8 independent
// accumulators, 3 operations (min, add, min) per output per offset.
//   Early exit: once (8q+8)^2 >= max_r acc_r no later candidate (>= k^2)
//   can lower any accumulator.
//   All-INF skip: a thread whose candidate window [i0-band, i0+7+band]
//   touches no 8-voxel chunk with a finite value (flags set while
//   staging) writes INF without looping; a tile with no needed block is
//   not staged at all.
//   One item per thread where the line allows (up to 512 a CTA, at least
//   8 lines a CTA); while staging a B > 1 tile each thread stays on one
//   line. B > 1 outputs go straight to global memory (a warp's lanes
//   write adjacent b); B == 1 outputs are gathered in a second shared
//   tile and written line by line.
//
// Bound: 4 bytes read per input voxel a needed block depends on and 4
// written per output voxel; the work left after the sweep, the window and
// the early exit is a few operations per voxel (edt_pass1) or 3 per
// offset actually examined (edt_pass), below the byte time. On whole-map
// grids the passes run at about twice the byte bound; on the main path's
// small grid they are bound by the instructions issued to stage the tile,
// not by bytes. The EDT has no matrix product: min-plus is not a product the
// tensor cores compute, so they have nothing to do here. Hopper's DPX
// instruction __viaddmin_s32 (min(a + b, c)) does fit the min-plus; an
// integer version of edt_minplus_kernel built on it ran up to a fifth
// slower than this float one on the lidar region and no faster on the main
// path's (PERF.md, the EDT findings).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e12f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxThreads = 512;  // edt_minplus_kernel: one thread per item
constexpr int kBatch = 8;         // staging loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// A pass's lines and its mask's geometry.
struct Lines {
  int A, S, B;
  int Y, Z, axis;
  int My, Mz;
  int mstride;  // mask stride between consecutive blocks of a line
};

// Mask offset of the block holding voxel 0 of line (a, b). Grids hold
// fewer than 2^31 voxels, so 32-bit arithmetic suffices.
__device__ __forceinline__ int mask_base(const Lines& g, int a, int b) {
  int x = 0, y = 0, z = 0;
  if (g.axis == 0) {
    y = b / g.Z;
    z = b - y * g.Z;
  } else if (g.axis == 1) {
    x = a;
    z = b;
  } else {
    x = a / g.Y;
    y = a - x * g.Y;
  }
  return ((x >> 3) * g.My + (y >> 3)) * g.Mz + (z >> 3);
}

__device__ __forceinline__ float square_in_band(float d, float band) {
  return d <= band ? d * d : kInf;
}

// Shared-memory index of element e of a warp's staged lines: one pad
// cell after every 8, so the lanes of a line, 8*K elements apart, read
// distinct banks.
__device__ __forceinline__ int padded(int e) { return e + (e >> 3); }

// edt_pass1 on contiguous lines (B == 1). A lane owns K consecutive
// 8-voxel blocks of a line (W = 8K voxels), nl = ceil(nb / K) lanes a line,
// 32 / nl lines a warp. The warp stages its lines in shared memory with
// coalesced loads (one round trip at the paths' shapes); each lane takes
// the minima of in[j] - j and in[j] + j over its voxels, a segmented warp
// scan (shuffles) carries them across the lanes of a line, and two short
// serial walks over the lane's own voxels give the backward and forward
// minima. Lines are written back coalesced.
__global__ void __launch_bounds__(kThreads)
edt_sweep_contig(const float* __restrict__ in, float* __restrict__ out,
                 const uint8_t* __restrict__ mask, Lines g, int band, int K) {
  extern __shared__ float sweep_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int S = g.S, nb = (S + 7) >> 3, W = 8 * K;
  const int nl = (nb + K - 1) / K, lpw = 32 / nl;
  const int cells = padded(lpw * S) + 1;
  float* val = sweep_all + (size_t)warp * 2 * cells;  // the input
  float* res = val + cells;                           // backward, output
  const int jl = lane / nl, p = lane - jl * nl;
  const int i_lo = p * W, i_hi = min(S, i_lo + W), base = jl * S;
  const float fband = (float)band;
  for (long long l0 = ((long long)blockIdx.x * warps + warp) * lpw; l0 < g.A;
       l0 += (long long)gridDim.x * warps * lpw) {
    const int n = (int)min((long long)lpw * S, (g.A - l0) * S);
    const bool active = jl < lpw && base < n;
    // Bit t: block p*K + t of my line is needed.
    unsigned nbits = 0;
    if (active) {
      const int mb = mask ? mask_base(g, (int)(l0 + jl), 0) : 0;
      for (int t = 0; t < K && p * K + t < nb; ++t)
        if (!mask || mask[mb + (p * K + t) * g.mstride]) nbits |= 1u << t;
    }
    const float* src = in + l0 * S;
    float* dst = out + l0 * S;
    if (!__any_sync(kFull, nbits != 0)) {
      for (int e = lane; e < n; e += 32) dst[e] = kInf;
      continue;
    }
    for (int e0 = lane; e0 < n; e0 += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = e0 + 32 * u < n ? __ldg(src + e0 + 32 * u) : kInf;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (e0 + 32 * u < n) val[padded(e0 + 32 * u)] = v[u];
    }
    __syncwarp();
    float hf = kInf, hb = kInf;
    if (active) {
      for (int i = i_lo; i < i_hi; ++i) {
        const float v = val[padded(base + i)];
        hf = fminf(hf, v - (float)i);
        hb = fminf(hb, v + (float)i);
      }
    }
    // Inclusive scans over the lanes of a line: forward from the left,
    // backward from the right; then exclusive by one lane.
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float nf = __shfl_up_sync(kFull, hf, o);
      const float nbk = __shfl_down_sync(kFull, hb, o);
      if (p >= o) hf = fminf(hf, nf);
      if (p + o < nl) hb = fminf(hb, nbk);
    }
    float cf = __shfl_up_sync(kFull, hf, 1);
    float cb = __shfl_down_sync(kFull, hb, 1);
    if (p == 0) cf = kInf;
    if (p == nl - 1) cb = kInf;
    if (active) {
      for (int i = i_hi - 1; i >= i_lo; --i) {
        cb = fminf(cb, val[padded(base + i)] + (float)i);
        res[padded(base + i)] = cb - (float)i;
      }
      for (int i = i_lo; i < i_hi; ++i) {
        const int e = padded(base + i);
        cf = fminf(cf, val[e] - (float)i);
        float v = square_in_band(fminf(cf + (float)i, res[e]), fband);
        if (!((nbits >> ((i - i_lo) >> 3)) & 1u)) v = kInf;
        res[e] = v;
      }
    }
    __syncwarp();
    for (int e = lane; e < n; e += 32) dst[e] = res[padded(e)];
    __syncwarp();
  }
}

// edt_pass1 on strided lines (B > 1): one thread per line.
__global__ void __launch_bounds__(kThreads)
edt_sweep_strided(const float* __restrict__ in, float* __restrict__ out,
                  const uint8_t* __restrict__ mask, Lines g, int band) {
  const long long L = (long long)g.A * g.B, B = g.B;
  const int S = g.S, nb = (S + 7) >> 3;
  const float fband = (float)band;
  for (long long l = (long long)blockIdx.x * kThreads + threadIdx.x; l < L;
       l += (long long)gridDim.x * kThreads) {
    const long long a = l / B, b = l - a * B;
    const float* src = in + a * S * B + b;
    float* dst = out + a * S * B + b;
    int mb = 0;
    if (mask) {
      mb = mask_base(g, (int)a, (int)b);
      bool any = false;
      for (int c = 0; c < nb && !any; ++c)
        any = mask[mb + c * g.mstride] != 0;
      if (!any) {
        for (int i = 0; i < S; ++i) dst[i * B] = kInf;
        continue;
      }
    }
    float f = kInf;
    for (int i = 0; i < S; ++i) {
      f = fminf(__ldg(src + i * B), f + 1.0f);
      dst[i * B] = f;
    }
    f = kInf;
    for (int i = S - 1; i >= 0; --i) {
      f = fminf(__ldg(src + i * B), f + 1.0f);
      float v = square_in_band(fminf(dst[i * B], f), fband);
      if (mask && !mask[mb + (i >> 3) * g.mstride]) v = kInf;
      dst[i * B] = v;
    }
  }
}

// Shared-memory tile of edt_minplus_kernel.
struct Tile {
  int lgTL;  // log2 of the lines per CTA
  int PADL;  // INF cells before (and after) each staged line
  int LS;    // staged row stride (odd)
  int OS;    // row stride of the output tile (B == 1), else 0
  int nb;    // 8-voxel blocks per line
};

__host__ __device__ inline size_t tile_bytes(const Tile& t) {
  const size_t TL = (size_t)1 << t.lgTL;
  return TL * 2 * sizeof(long long) + TL * (t.LS + t.OS) * sizeof(float) +
         TL * (2 * t.nb + 1);
}

template <int BAND>
__global__ void __launch_bounds__(kMaxThreads)
edt_minplus_kernel(const float* __restrict__ in, float* __restrict__ out,
                   const uint8_t* __restrict__ mask, Lines g, Tile t,
                   int band_rt) {
  const int band = BAND > 0 ? BAND : band_rt;
  extern __shared__ long long smem_ll[];
  const int lgTL = t.lgTL, TL = 1 << lgTL, S = g.S, nb = t.nb, LS = t.LS;
  const int nt = blockDim.x, tid = threadIdx.x;
  long long* line_off = smem_ll;          // [TL] global offset of voxel 0
  long long* line_mask = line_off + TL;   // [TL] mask offset of block 0
  float* tile = (float*)(line_mask + TL);
  float* otile = tile + (size_t)TL * LS;
  uint8_t* need = (uint8_t*)(otile + (size_t)TL * t.OS);  // [TL][nb]
  uint8_t* fin = need + TL * nb;                          // [TL][nb]
  uint8_t* line_need = fin + TL * nb;                     // [TL]
  const long long L = (long long)g.A * g.B, B = g.B;
  const long long l0 = (long long)blockIdx.x * TL;
  const bool contig = g.B == 1;
  // Tile element e -> (line j, voxel i): along the line when B == 1 (the
  // line is contiguous), across lines otherwise (adjacent b).
  auto split = [&](int e, int* j, int* i) {
    if (contig) {
      *j = e / S;
      *i = e - *j * S;
    } else {
      *j = e & (TL - 1);
      *i = e >> lgTL;
    }
  };

  for (int j = tid; j < TL; j += nt) {
    const int l = (int)min(l0 + j, L - 1), a = l / g.B, b = l - a * g.B;
    line_off[j] = ((long long)a * S) * B + b;
    line_mask[j] = mask ? mask_base(g, a, b) : 0;
    line_need[j] = 0;
  }
  __syncthreads();
  bool any = false;
  for (int e = tid; e < TL * nb; e += nt) {
    const int j = e & (TL - 1), c = e >> lgTL;
    uint8_t nd = 0;
    if (l0 + j < L) nd = mask ? mask[line_mask[j] + c * g.mstride] != 0 : 1;
    need[j * nb + c] = nd;
    fin[j * nb + c] = 0;
    if (nd) {
      line_need[j] = 1;
      any = true;
    }
  }
  if (!__syncthreads_or(any)) {
    // No needed block in the tile: INF everywhere, nothing staged.
    for (int e = tid; e < TL * S; e += nt) {
      int j, i;
      split(e, &j, &i);
      if (l0 + j < L) out[line_off[j] + i * B] = kInf;
    }
    return;
  }

  // Stage the needed lines (kBatch loads in flight per thread) and flag
  // the 8-voxel chunks holding a finite value.
  const int PADL = t.PADL, LP = LS - 1, npad = LP - S, n = TL * S;
  if (contig) {
    for (int e0 = tid; e0 < n; e0 += kBatch * nt) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        int j, i;
        split(e0 + u * nt, &j, &i);
        v[u] = e0 + u * nt < n && line_need[j]
                   ? __ldg(in + line_off[j] + i) : kInf;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        int j, i;
        split(e0 + u * nt, &j, &i);
        if (e0 + u * nt < n && line_need[j]) {
          tile[j * LS + PADL + i] = v[u];
          if (v[u] < kInf) fin[j * nb + (i >> 3)] = 1;
        }
      }
    }
  } else {
    // nt is a multiple of TL: each thread stays on one line j, every
    // (nt / TL)-th voxel of it.
    const int j = tid & (TL - 1), step = nt >> lgTL;
    if (line_need[j]) {
      const float* src = in + line_off[j];
      float* row = tile + j * LS + PADL;
      uint8_t* fin_j = fin + j * nb;
      for (int i0 = tid >> lgTL; i0 < S; i0 += kBatch * step) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * step;
          v[u] = i < S ? __ldg(src + (long long)i * B) : kInf;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * step;
          if (i < S) {
            row[i] = v[u];
            if (v[u] < kInf) fin_j[i >> 3] = 1;
          }
        }
      }
    }
  }
  // INF pads at both ends: a warp per line, lanes along the pads.
  for (int j = tid >> 5; j < TL; j += nt >> 5) {
    if (!line_need[j]) continue;
    float* row = tile + j * LS;
    for (int q = tid & 31; q < npad; q += 32)
      row[q < PADL ? q : S + q] = kInf;
  }
  __syncthreads();

  const int Hb = (band + 7) >> 3, qmax = band >> 3;
  for (int w = tid; w < TL * nb; w += nt) {
    const int j = w & (TL - 1), s = w >> lgTL, i0 = s * 8;
    if (l0 + j >= L) continue;
    float acc[8];
    bool live = need[j * nb + s];
    if (live) {
      live = false;
      const int lo = max(0, s - Hb), hi = min(nb - 1, s + Hb);
      for (int c = lo; c <= hi; ++c) live |= fin[j * nb + c] != 0;
    }
    if (!live) {
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = kInf;
    } else {
      const float* x = tile + j * LS + PADL + i0;
      float P[16], M[16];  // x[8q .. 8q+15] and x[-8q-8 .. -8q+7]
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        P[r] = x[r];
        M[r] = x[r - 8];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = P[r];
#pragma unroll
      for (int q = 0; q <= qmax; ++q) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int k = 8 * q + m;
          if (k == 0) continue;
          if (k > band) break;
          const float kk = (float)(k * k);
#pragma unroll
          for (int r = 0; r < 8; ++r)
            acc[r] = fminf(acc[r], fminf(P[r + m], M[8 + r - m]) + kk);
        }
        if (q == qmax) break;
        float mx = acc[0];
#pragma unroll
        for (int r = 1; r < 8; ++r) mx = fmaxf(mx, acc[r]);
        const int kn = 8 * q + 8;
        if ((float)(kn * kn) >= mx) break;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          P[r] = P[r + 8];
          P[r + 8] = x[8 * q + 16 + r];
          M[r + 8] = M[r];
          M[r] = x[-8 * q - 16 + r];
        }
      }
    }
    const int nr = min(8, S - i0);
    if (contig) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < nr) otile[j * t.OS + i0 + r] = acc[r];
    } else {
      float* o = out + line_off[j] + i0 * B;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < nr) o[r * B] = acc[r];
    }
  }
  if (contig) {
    __syncthreads();
    for (int e = tid; e < n; e += nt) {
      int j, i;
      split(e, &j, &i);
      if (l0 + j < L) out[line_off[j] + i] = otile[j * t.OS + i];
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= kDefaultSmem) return 0;
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// One pass along `axis` of the dense grid f32[X, Y, Z] `in` into `out`
// (first != 0: edt_pass1, else edt_pass). `mask` is u8[ceil(X/8),
// ceil(Y/8), ceil(Z/8)] (0 = the block's outputs are not needed) or null.
extern "C" int edt_pass_launch(const void* in, void* out, const void* mask,
                               int X, int Y, int Z, int axis, int band,
                               int first, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return 0;
  if (axis < 0 || axis > 2 || band < 0 || band > 181)
    return (int)cudaErrorInvalidValue;
  const int dims[3] = {X, Y, Z};
  Lines g;
  g.A = axis == 0 ? 1 : axis == 1 ? X : X * Y;
  g.S = dims[axis];
  g.B = axis == 0 ? Y * Z : axis == 1 ? Z : 1;
  g.Y = Y;
  g.Z = Z;
  g.axis = axis;
  g.My = (Y + 7) / 8;
  g.Mz = (Z + 7) / 8;
  g.mstride = axis == 0 ? g.My * g.Mz : axis == 1 ? g.Mz : 1;
  const float* src = (const float*)in;
  float* dst = (float*)out;
  const uint8_t* m = (const uint8_t*)mask;
  const long long L = (long long)g.A * g.B;
  cudaStream_t s = (cudaStream_t)stream;
  int err;

  const int nb = (g.S + 7) / 8;
  if (first && g.B == 1 && nb <= 32 * 32) {
    // K blocks a lane; warps a CTA within 48 KB of shared memory where the
    // lines allow.
    const int K = (nb + 31) / 32, nl = (nb + K - 1) / K;
    const size_t per_warp =
        2 * ((size_t)(32 / nl) * g.S * 9 / 8 + 2) * sizeof(float);
    int warps = kWarps;
    while (warps > 1 && warps * per_warp > kDefaultSmem) warps /= 2;
    const size_t smem = warps * per_warp;
    if ((err = set_smem((const void*)edt_sweep_contig, smem))) return err;
    const long long per_cta = (long long)warps * (32 / nl);
    const unsigned grid = (unsigned)((L + per_cta - 1) / per_cta);
    edt_sweep_contig<<<grid, warps * 32, smem, s>>>(src, dst, m, g, band, K);
  } else if (first) {
    const unsigned grid = (unsigned)((L + kThreads - 1) / kThreads);
    edt_sweep_strided<<<grid, kThreads, 0, s>>>(src, dst, m, g, band);
  } else {
    // Lines per CTA: enough for one 8-output item per thread (at most
    // kMaxThreads), at least 8 (32-byte rows when staging B > 1 lines),
    // within 48 KB of shared memory where the line allows.
    Tile t;
    t.nb = (g.S + 7) / 8;
    t.PADL = (band / 8 + 1) * 8;
    t.LS = 2 * t.PADL + 8 * t.nb + 1;
    t.OS = g.B == 1 ? (g.S | 1) : 0;
    t.lgTL = 6;
    while (t.lgTL > 3 && (t.nb << t.lgTL) > kMaxThreads) --t.lgTL;
    while (t.lgTL > 0 && tile_bytes(t) > kDefaultSmem) --t.lgTL;
    const int items = t.nb << t.lgTL;
    const int threads = items >= kMaxThreads ? kMaxThreads
                                             : (items + 31) / 32 * 32;
    const size_t smem = tile_bytes(t);
    const unsigned grid = (unsigned)((L + (1 << t.lgTL) - 1) >> t.lgTL);
    if (band == 40) {
      if ((err = set_smem((const void*)edt_minplus_kernel<40>, smem)))
        return err;
      edt_minplus_kernel<40><<<grid, threads, smem, s>>>(src, dst, m, g, t,
                                                         band);
    } else {
      if ((err = set_smem((const void*)edt_minplus_kernel<0>, smem)))
        return err;
      edt_minplus_kernel<0><<<grid, threads, smem, s>>>(src, dst, m, g, t,
                                                        band);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* edt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
