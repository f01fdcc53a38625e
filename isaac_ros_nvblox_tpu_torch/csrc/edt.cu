// 1-D passes of the exact banded squared Euclidean distance transform.
//
// Replace the TPU kernels isaac_ros_nvblox_tpu/ops/esdf_dense.py::
//   _pass1_kernel / _pass1_body  (edt_pass1: first pass, {0, INF} site seeds)
//   _pass_kernel / _pass_body    (edt_pass: second and third passes)
// both launched by edt_pass_blockmajor. The TPU versions work on block-major
// pool rows with lane rolls, carry buffers, INF gap rows and skip flags
// because that chip has no cheap transposes or element gathers. Here the
// region is a dense grid f32[X, Y, Z] and a pass runs along one axis:
//
//   edt_pass1: out[i] = d*d where d = min_{|k| <= band} in[i+k] + |k|, if
//              d <= band, else INF (for {0, INF} input: squared distance to
//              the nearest site on the line, or INF beyond the band)
//   edt_pass:  out[i] = min_{|k| <= band} in[i+k] + k*k
//
// Candidates outside the line read INF (INF + k*k rounds back to INF in
// float32). Every finite value is an integer below 2^24, so results are
// exact and independent of evaluation order.
//
// Layout: the grid is viewed as [A, S, B] (S = scan axis, stride B); a line
// is a pair (a, b). One CTA stages TL lines in shared memory, tile[i][j]
// with a padded row stride TL + 1 (no bank conflicts either way the tile is
// walked); threads then loop over the band for each output voxel. Loads and
// stores walk global memory contiguously: along b when B > 1, along the line
// when B == 1.
//
// Bound: edt_pass does 2 ops (add, min) per candidate, 2*(2*band+1) per
// voxel, against 8 bytes moved per voxel: operation-bound at band 40.
// edt_pass1 stops scanning once no nearer site can exist, so it is usually
// bound by its 8 bytes per voxel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e12f;
constexpr int kThreads = 256;

__device__ __forceinline__ void coords(int e, int S, int TL, int B, int* i,
                                       int* j) {
  if (B == 1) {
    *j = e / S;
    *i = e - *j * S;
  } else {
    *i = e / TL;
    *j = e - *i * TL;
  }
}

template <bool FIRST>
__global__ void __launch_bounds__(kThreads)
edt_kernel(const float* __restrict__ in, float* __restrict__ out, int A,
           int S, int B, int TL, int band) {
  extern __shared__ float tile[];
  const int TS = TL + 1;
  const long long L = (long long)A * B;
  const long long l0 = (long long)blockIdx.x * TL;
  const int n = S * TL;

  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int i, j;
    coords(e, S, TL, B, &i, &j);
    const long long l = l0 + j;
    float val = kInf;
    if (l < L) {
      const long long a = l / B, b = l - a * B;
      val = __ldg(in + (a * S + i) * B + b);
    }
    tile[i * TS + j] = val;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int i, j;
    coords(e, S, TL, B, &i, &j);
    const long long l = l0 + j;
    if (l >= L) continue;
    const float* col = tile + j;
    float acc = col[i * TS];
    if (FIRST) {
      // L1 distance to the nearest zero: candidates at offset d are >= d,
      // so the scan stops once d reaches the best value found.
      for (int d = 1; d <= band && (float)d < acc; ++d) {
        const float fd = (float)d;
        if (i + d < S) acc = fminf(acc, col[(i + d) * TS] + fd);
        if (i - d >= 0) acc = fminf(acc, col[(i - d) * TS] + fd);
      }
      acc = acc <= (float)band ? acc * acc : kInf;
    } else {
      for (int k = 1; k <= band; ++k) {
        const float kk = (float)(k * k);
        if (i + k < S) acc = fminf(acc, col[(i + k) * TS] + kk);
        if (i - k >= 0) acc = fminf(acc, col[(i - k) * TS] + kk);
      }
    }
    const long long a = l / B, b = l - a * B;
    out[(a * S + i) * B + b] = acc;
  }
}

}  // namespace

// Lines staged per CTA for scan length S: the widest power of two up to 32
// whose tile fits the default 48 KB of shared memory.
extern "C" int edt_lines_per_cta(int S) {
  int tl = 32;
  while (tl > 1 && (long long)S * (tl + 1) * 4 > 48 * 1024) tl /= 2;
  return tl;
}

extern "C" int edt_pass_launch(const void* in, void* out, int A, int S, int B,
                               int band, int first, void* stream) {
  if (A <= 0 || S <= 0 || B <= 0) return 0;
  const int TL = edt_lines_per_cta(S);
  const size_t smem = (size_t)S * (TL + 1) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long L = (long long)A * B;
  const unsigned grid = (unsigned)((L + TL - 1) / TL);
  cudaStream_t s = (cudaStream_t)stream;
  if (first) {
    edt_kernel<true><<<grid, kThreads, smem, s>>>(
        (const float*)in, (float*)out, A, S, B, TL, band);
  } else {
    edt_kernel<false><<<grid, kThreads, smem, s>>>(
        (const float*)in, (float*)out, A, S, B, TL, band);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* edt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
