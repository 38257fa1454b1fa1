// The scene build's pixel steps for Hopper (sm_90a): grey conversion,
// area-resampled pyramid, Sobel edge planes, window-variance maps, and the
// pack into the bf16 mip-atlases.
//
// Replaces: no Pallas kernel. The JAX package builds its scene in float64
// numpy on the host (pais_mvs_tpu/models/camera.py:190-227 over
// pais_mvs_tpu/ops/pyramid.py): rgb_to_gray (:25-32), the level-0
// antiderivative (:35-45), the area resample (:48-74, quantized at :146),
// sobel_magnitude (:77-88), window_variance_map (:91-118) and the packs
// (:178-217). Plain twins: the CPU branches of
// pais_mvs_tpu_torch/ops/pyramid.py, which also holds each wrapper.
//
// Contract: bit for bit the numpy build. Every kernel computes in float64
// with numpy's order of operations (the build uses --fmad=false, so no
// multiply-add is fused): the grey weights (0.299 r + 0.587 g) + 0.114 b;
// the resample F[e0] + (frac * f) * mask, (Fe[k+1] - Fe[k]) / width; the
// box sums ((A - B) - C) + D; the variance s2/n - (s1/n)(s1/n); rounding
// by rint (half to even, as np.round), then the clip; sqrt and division
// correctly rounded (CUDA's double sqrt and '/' are IEEE). Every running
// sum runs sequentially in index order along its line, one thread a line,
// as numpy's cumsum does (a parallel prefix sum would reorder the float64
// additions of the resample's row pass). The level's Sobel min and max are
// exact in any order (atomics on the bit patterns of non-negative
// doubles). The atlases are written as float64 -> float32 -> bf16, each to
// nearest even, as the JAX package casts its float32 atlases.
//
// What bounds it on this card: bytes. The 4K scene (8 cameras at
// 4096x3072, 9 levels) writes three bf16 atlases of 8 x 13,328 x 4096 (2.62
// GB) and the colour plane (0.30 GB) from 0.30 GB of RGB: about 0.96 ms at
// 3.35 TB/s; its float64 intermediates (the integrals, the resample's
// passes) are several times that again. The float64 arithmetic (about
// 10^9 operations a scene) is far below the card's rate. The sequential
// scans are latency-bound instead: 3072-4096 dependent float64 additions a
// thread, over a few thousand lines, in a few dozen blocks. Design, right
// and simple first: one thread a pixel for the pointwise steps (grey, the
// resample's gathers, the Sobel range, the pack, which recomputes the
// Sobel magnitude and box sums of its pixel rather than store them); the
// column scan (one thread a column, coalesced across threads) issues
// kBatch loads before it adds them; the row scan stages [32 rows x 32
// columns] tiles through shared memory so its loads and stores coalesce,
// and each thread then scans its row of the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanRows = 32;   // rows of one row-scan block (one a thread)
constexpr int kScanCols = 32;   // columns a row-scan tile stages
constexpr int kBatch = 8;       // loads a column scan issues before adding
constexpr int kRangeBlocks = 1056;  // 8 blocks an SM for the Sobel range

inline unsigned blocks_for(long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

__global__ void pyramid_gray_kernel(
    const uint8_t* __restrict__ img, int h, int w, int ch,
    uint8_t* __restrict__ rgb_out, int wm, double* __restrict__ gray) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)h * w) return;
  const long y = i / w, x = i % w;
  const uint8_t* p = img + i * ch;
  const uint8_t r = p[0], g = ch == 3 ? p[1] : r, b = ch == 3 ? p[2] : r;
  uint8_t* q = rgb_out + (y * wm + x) * 3;
  q[0] = r;
  q[1] = g;
  q[2] = b;
  if (ch == 1) {
    gray[i] = (double)r;
    return;
  }
  double t = 0.299 * (double)r + 0.587 * (double)g;
  t = t + 0.114 * (double)b;
  gray[i] = fmin(fmax(rint(t), 0.0), 255.0);
}

// out[0] = 0, out[i + 1] = out[i] + in[i] down each column of in [n, w];
// out_sq (may be null) the same of in * in
__global__ void pyramid_col_scan_kernel(
    const double* __restrict__ in, int n, int w, double* __restrict__ out,
    double* __restrict__ out_sq) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  out[x] = 0.0;
  if (out_sq) out_sq[x] = 0.0;
  // -0.0 + v == v for every v, so the first sum is in[0] itself, as in
  // numpy's cumsum
  double s = -0.0, s2 = -0.0;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    const int m = min(kBatch, n - i0);
    double v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < m) v[j] = in[(long)(i0 + j) * w + x];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j < m) {
        const long o = (long)(i0 + j + 1) * w + x;
        s += v[j];
        out[o] = s;
        if (out_sq) {
          s2 += v[j] * v[j];
          out_sq[o] = s2;
        }
      }
    }
  }
}

// out[r][0] = 0, out[r][j + 1] = out[r][j] + in[r][j] along each row of
// in [rows, n]: tiles staged through shared memory
__global__ void pyramid_row_scan_kernel(
    const double* __restrict__ in, int rows, int n, double* __restrict__ out) {
  __shared__ double tile[kScanRows][kScanCols + 1];  // +1: fewer conflicts
  const int t = threadIdx.x;
  const long r0 = (long)blockIdx.x * kScanRows;
  const long n1 = (long)n + 1;
  if (r0 + t < rows) out[(r0 + t) * n1] = 0.0;
  double s = -0.0;
  for (int c0 = 0; c0 < n; c0 += kScanCols) {
    const int m = min(kScanCols, n - c0);
    for (int rr = 0; rr < kScanRows; ++rr)    // thread t takes column t
      if (r0 + rr < rows && t < m)
        tile[rr][t] = in[(r0 + rr) * n + c0 + t];
    __syncthreads();
    if (r0 + t < rows)
      for (int j = 0; j < m; ++j) {
        s += tile[t][j];
        tile[t][j] = s;
      }
    __syncthreads();
    for (int rr = 0; rr < kScanRows; ++rr)
      if (r0 + rr < rows && t < m)
        out[(r0 + rr) * n1 + c0 + t + 1] = tile[rr][t];
    __syncthreads();
  }
}

// F at output edge k of a line of n_in samples (f, F strided by step):
// numpy's F[e0] + frac * f[min(e0, n_in - 1)] * (e0 < n_in)
__device__ __forceinline__ double edge_value(const double* __restrict__ f,
                                             const double* __restrict__ F,
                                             long step, int k, double scale,
                                             int n_in) {
  const double e = (double)k * scale;
  long e0 = (long)floor(e);
  e0 = e0 < 0 ? 0 : (e0 > n_in ? n_in : e0);
  const double frac = e - (double)e0;
  const long ef = e0 < n_in - 1 ? e0 : n_in - 1;
  const double mask = e0 < n_in ? 1.0 : 0.0;
  return F[e0 * step] + frac * f[ef * step] * mask;
}

// the mean of the line over output cell k: (Fe[k+1] - Fe[k]) / width
__device__ __forceinline__ double cell_mean(const double* __restrict__ f,
                                            const double* __restrict__ F,
                                            long step, int k, int n_in,
                                            int n_out) {
  const double scale = (double)n_in / (double)n_out;
  const double box = edge_value(f, F, step, k + 1, scale, n_in) -
                     edge_value(f, F, step, k, scale, n_in);
  return box / ((double)(k + 1) * scale - (double)k * scale);
}

// the axis-0 pass: f [n_in, w], F [n_in + 1, w] -> out [n_out, w]
__global__ void pyramid_resample_rows_kernel(
    const double* __restrict__ f, const double* __restrict__ F, int n_in,
    int w, int n_out, double* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)n_out * w) return;
  const int k = (int)(i / w), x = (int)(i % w);
  out[i] = cell_mean(f + x, F + x, w, k, n_in, n_out);
}

// the axis-1 pass and the level's quantization: tmp [h, n_in], G [h,
// n_in + 1] -> out [h, n_out] in 0..255
__global__ void pyramid_resample_cols_kernel(
    const double* __restrict__ tmp, const double* __restrict__ G, int h,
    int n_in, int n_out, double* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)h * n_out) return;
  const long y = i / n_out;
  const int k = (int)(i % n_out);
  const double v = cell_mean(tmp + y * n_in, G + y * (n_in + 1), 1, k, n_in,
                             n_out);
  out[i] = fmin(fmax(rint(v), 0.0), 255.0);
}

// numpy's 'reflect' (OpenCV reflect-101) one step outside [0, n)
__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ double sobel_at(const double* __restrict__ g,
                                           int h, int w, int y, int x) {
  const double* row = g + (long)y * w;
  const double gx = row[reflect(x + 1, w)] - row[reflect(x - 1, w)];
  const double gy =
      g[(long)reflect(y + 1, h) * w + x] - g[(long)reflect(y - 1, h) * w + x];
  return sqrt(gx * gx + gy * gy);
}

// the Sobel magnitude's min and max over the level, as the bit patterns of
// non-negative doubles (ordered as the values are)
__global__ void pyramid_edge_range_kernel(
    const double* __restrict__ g, int h, int w,
    unsigned long long* __restrict__ lohi) {
  unsigned long long lo = ~0ull, hi = 0ull;
  const long n = (long)h * w;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const unsigned long long b = (unsigned long long)__double_as_longlong(
        sobel_at(g, h, w, (int)(i / w), (int)(i % w)));
    lo = b < lo ? b : lo;
    hi = b > hi ? b : hi;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long l2 = __shfl_down_sync(0xffffffffu, lo, o);
    const unsigned long long h2 = __shfl_down_sync(0xffffffffu, hi, o);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(lohi, lo);
    atomicMax(lohi + 1, hi);
  }
}

__device__ __forceinline__ uint16_t bf16_bits(double v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(__double2float_rn(v)));
}

// one level into its band of the three atlas planes: the image, the edge
// plane normalized by lohi, the window variance from I [2, h+1, w+1] (the
// integrals of g and g * g, zero first row and column), -1 outside the
// window or on a level smaller than the window
__global__ void pyramid_pack_kernel(const double* __restrict__ g, int h, int w,
                                    const double* __restrict__ lohi,
                                    const double* __restrict__ I, int r,
                                    uint16_t* __restrict__ images,
                                    uint16_t* __restrict__ edges,
                                    uint16_t* __restrict__ var, int Wa) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)h * w) return;
  const int y = (int)(i / w), x = (int)(i % w);
  const long o = (long)y * Wa + x;
  images[o] = bf16_bits(g[i]);
  const double lo = lohi[0], hi = lohi[1];
  edges[o] = bf16_bits(hi > lo ? (sobel_at(g, h, w, y, x) - lo) / (hi - lo)
                               : 0.0);
  const int k = 2 * r + 1;
  double v = -1.0;
  if (h >= k && w >= k && y >= r && y < h - r && x >= r && x < w - r) {
    const long w1 = (long)w + 1;
    const long a = (long)(y + r + 1) * w1 + x + r + 1;
    const long b = (long)(y - r) * w1 + x + r + 1;
    const long c = (long)(y + r + 1) * w1 + x - r;
    const long d = (long)(y - r) * w1 + x - r;
    const double* I2 = I + (long)(h + 1) * w1;
    const double s1 = ((I[a] - I[b]) - I[c]) + I[d];
    const double s2 = ((I2[a] - I2[b]) - I2[c]) + I2[d];
    const double n = (double)(k * k);
    const double m = s1 / n;
    const double vv = s2 / n - m * m;
    v = vv >= 0.0 ? vv : 0.0;      // np.maximum(var, 0.0)
  }
  var[o] = bf16_bits(v);
}

}  // namespace

// C entries, bound with ctypes. Each returns cudaGetLastError() after its
// launch.
extern "C" int pais_pyramid_gray(const uint8_t* img, int h, int w, int ch,
                                 uint8_t* rgb_out, int wm, double* gray,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  pyramid_gray_kernel<<<blocks_for((long)h * w), kThreads, 0, s>>>(
      img, h, w, ch, rgb_out, wm, gray);
  return (int)cudaGetLastError();
}

extern "C" int pais_pyramid_col_scan(const double* in, int n, int w,
                                     double* out, double* out_sq,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  pyramid_col_scan_kernel<<<blocks_for(w), kThreads, 0, s>>>(in, n, w, out,
                                                             out_sq);
  return (int)cudaGetLastError();
}

extern "C" int pais_pyramid_row_scan(const double* in, int rows, int n,
                                     double* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((rows + kScanRows - 1) / kScanRows);
  pyramid_row_scan_kernel<<<blocks, kScanRows, 0, s>>>(in, rows, n, out);
  return (int)cudaGetLastError();
}

extern "C" int pais_pyramid_resample_rows(const double* f, const double* F,
                                          int n_in, int w, int n_out,
                                          double* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  pyramid_resample_rows_kernel<<<blocks_for((long)n_out * w), kThreads, 0,
                                 s>>>(f, F, n_in, w, n_out, out);
  return (int)cudaGetLastError();
}

extern "C" int pais_pyramid_resample_cols(const double* tmp, const double* G,
                                          int h, int n_in, int n_out,
                                          double* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  pyramid_resample_cols_kernel<<<blocks_for((long)h * n_out), kThreads, 0,
                                 s>>>(tmp, G, h, n_in, n_out, out);
  return (int)cudaGetLastError();
}

extern "C" int pais_pyramid_edge_range(const double* g, int h, int w,
                                       double* lohi, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  // lo starts at all ones (above every non-negative double's bits), hi 0
  cudaError_t e = cudaMemsetAsync(lohi, 0xff, sizeof(double), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(lohi + 1, 0, sizeof(double), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = blocks_for((long)h * w);
  pyramid_edge_range_kernel<<<blocks < kRangeBlocks ? blocks : kRangeBlocks,
                              kThreads, 0, s>>>(
      g, h, w, (unsigned long long*)lohi);
  return (int)cudaGetLastError();
}

extern "C" int pais_pyramid_pack(const double* g, int h, int w,
                                 const double* lohi, const double* I,
                                 int radius, int y0, void* images,
                                 void* edges, void* var, int Wa,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long band = (long)y0 * Wa;     // the level's first atlas row
  pyramid_pack_kernel<<<blocks_for((long)h * w), kThreads, 0, s>>>(
      g, h, w, lohi, I, radius, (uint16_t*)images + band,
      (uint16_t*)edges + band, (uint16_t*)var + band, Wa);
  return (int)cudaGetLastError();
}

extern "C" const char* pais_pyramid_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
