// Warped-window sampler (K2) for Hopper (sm_90a), in its NCC mode.
//
// Replaces: the Pallas kernel `_sample_kernel` (+ `_cell_body`) in
// pais_mvs_tpu/ops/pallas_fitness.py:67/:344, launched by
// `_run_sampler_raw` (:421), with one particle per patch and the NCC
// path's margins (0, 1), as `warped_patch_vectors_pallas` (:867) and
// `warped_vectors_view` (pais_mvs_tpu/ops/view_fitness.py:399) call it.
// Contract: the sampling half of the jnp reference
// pais_mvs_tpu/ops/fitness.py::warped_patch_vectors (:248-298); plain twin
// pais_mvs_tpu_torch/ops/fitness.py::warped_samples. Output [B, C, W2].
// (The same Pallas kernel's view mode and its reference-window reads are
// ported with the view fitness's camera sums in csrc/view_fitness.cu.)
//
// For every sample: warp the reference window pixel through H,
// bilinear-sample the camera's LOD band of the bf16 mip-atlas, and write
// the f32 sample, or INVALID (-1e9) where the warp leaves [0, dim-1),
// where the homography's w is 0, or where the mask switches the (patch,
// camera) off. The L2 normalisation and the NCC table stay in PyTorch, as
// the JAX package also leaves them outside Pallas.
//
// What bounds it on this card: the output write. It writes one f32 per
// sample (19.7 MB per launch at B=1024, C=5, r=15) and reads at most four
// 2-byte taps per sample from an atlas that L2 holds, so HBM bytes (the
// output) set the roofline bound.
//
// Design: one warp per (patch, camera) window, 8 windows a block, no block
// barrier. Lanes take the window's x offsets (32 lanes at r >= 8, W > 32
// looping over chunks of 32; 16 or 8 lanes, two or four y offsets a warp
// step, for smaller windows) and the warp steps over its y offsets, so row
// and column come from the thread index with no per-pixel integer
// division, and a warp's four taps of one y offset fall on neighbouring
// atlas elements of two image rows (a few 32-byte sectors per load, where
// lanes along y, the output's contiguous axis, touched 32). A lane
// computes the coordinates of kRowBatch = 4 y offsets and issues all their
// taps before any of the blend arithmetic. The samples go to the warp's
// slice of shared memory ([warp][W2]) and leave in the output's x-major
// order, so the stores stay coalesced. H, the window centre and the LOD
// band sit in registers, loaded once per window. A masked (patch, camera)
// row is written INVALID without touching the atlas. The two IEEE
// divisions of each sample stay: a reciprocal would round otherwise than
// the jnp contract. ptxas -v: 64 registers, no spills. On the H100 at the
// bench shape (B=1024, C=5, r=15) it takes 0.030 ms, 4.5x its byte bound
// and under grid_sample's 0.072 ms on the same coordinates (PERF.md);
// what is left is each warp's chain of dependent loads (mask, LOD, band,
// taps) over 5,120 windows in about one wave.
//
// Built with --fmad=false so each sample rounds as the plain version does
// on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvalid = -1e9f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBatch = 4;     // NCC mode: y offsets a lane gathers at once
constexpr long kMaxSmem = 232448;  // the shared memory one block can take

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Band {
  float hgt, wid;  // the camera's LOD level, (h, w)
  int yo;          // the level's atlas row offset
  long cam_base;   // the camera's first atlas element
};

__device__ __forceinline__ Band band_of(const int* __restrict__ dims,
                                        const int* __restrict__ yoff, int c,
                                        int L, int l, int Ha, int Wa) {
  Band bd;
  bd.hgt = (float)dims[(c * L + l) * 2 + 0];
  bd.wid = (float)dims[(c * L + l) * 2 + 1];
  bd.yo = yoff[l];
  bd.cam_base = (long)c * Ha * Wa;
  return bd;
}

__device__ __forceinline__ float tap16(const uint16_t* __restrict__ a,
                                       long i) {
  // bf16 -> f32 is the bits shifted into the high half
  return __uint_as_float((unsigned)__ldg(a + i) << 16);
}

// NCC mode: one warp per (patch, camera) window, up to kWarps windows per
// block. Lanes take the window's x offsets (lpr = 2^lpr_shift lanes; W > 32
// loops over chunks of 32), so a warp's taps fall on neighbouring atlas
// elements of one image row; a warp step covers 32 / lpr y offsets, and
// the warp takes kRowBatch steps at a time: all their taps are issued
// before any of the blend arithmetic. The samples go to the warp's slice
// of shared memory and leave in the output's x-major order, coalesced.
__global__ void __launch_bounds__(kThreads) sampler_kernel(
    const uint16_t* __restrict__ images, const int* __restrict__ dims,
    const int* __restrict__ yoff, int C, int L, int Ha, int Wa,
    const float* __restrict__ H, const float* __restrict__ pt,
    const int* __restrict__ lod, const uint8_t* __restrict__ cam_mask,
    long BC, int radius, int lpr_shift, float* __restrict__ out) {
  extern __shared__ float s_win[];                     // [warps][W2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long bc = (long)blockIdx.x * (blockDim.x >> 5) + warp;  // b*C + c
  if (bc >= BC) return;
  const int W = 2 * radius + 1;
  const int W2 = W * W;
  float* __restrict__ row = out + bc * W2;
  if (!cam_mask[bc]) {                                 // no atlas reads
    for (int k = lane; k < W2; k += 32) row[k] = kInvalid;
    return;
  }
  float* win = s_win + warp * W2;
  const int lpr = 1 << lpr_shift;
  const int col = lane & (lpr - 1);
  const int sub = lane >> lpr_shift;
  const int rps = 32 >> lpr_shift;
  const int b = (int)(bc / C);
  const int c = (int)(bc - (long)b * C);
  const Band bd = band_of(dims, yoff, c, L, lod[b], Ha, Wa);
  const float* h = H + bc * 9;
  const float h0 = __ldg(h + 0), h1 = __ldg(h + 1), h2 = __ldg(h + 2),
              h3 = __ldg(h + 3), h4 = __ldg(h + 4), h5 = __ldg(h + 5),
              h6 = __ldg(h + 6), h7 = __ldg(h + 7), h8 = __ldg(h + 8);
  const float px = __ldg(pt + b * 2 + 0), py = __ldg(pt + b * 2 + 1);
  // valid iff 0 <= u < wid - 1 and 0 <= v < hgt - 1
  const float umax = bd.wid - 1.f, vmax = bd.hgt - 1.f;

  for (int i0 = 0; i0 < W; i0 += lpr) {
    // offset (dx, dy) = (i - r, j - r), stored at i * W + j (x-major)
    const int i = i0 + col;
    const float x = px + (float)(i - radius);
    for (int j0 = 0; j0 < W; j0 += kRowBatch * rps) {
      bool ok[kRowBatch];
      float fx[kRowBatch], fy[kRowBatch];
      long i00[kRowBatch];
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        const int j = j0 + q * rps + sub;
        const float y = py + (float)(j - radius);
        const float hw = h6 * x + h7 * y + h8;
        const float sw = hw == 0.f ? 1.f : hw;
        const float u = (h0 * x + h1 * y + h2) / sw;
        const float v = (h3 * x + h4 * y + h5) / sw;
        // (NaN and +-inf fail the bounds: no isfinite test needed)
        ok[q] = (i < W) & (j < W) & (u >= 0.f) & (u < umax) & (v >= 0.f) &
                (v < vmax) & (hw != 0.f);
        const float x0 = floorf(u), y0 = floorf(v);
        fx[q] = u - x0;
        fy[q] = v - y0;
        const int x0i = clampi((int)x0, 0, Wa - 2);
        const int y0i = clampi((int)y0 + bd.yo, 0, Ha - 2);
        i00[q] = bd.cam_base + (long)y0i * Wa + x0i;
      }
      float t00[kRowBatch], t01[kRowBatch], t10[kRowBatch], t11[kRowBatch];
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        t00[q] = t01[q] = t10[q] = t11[q] = 0.f;
        if (ok[q]) {
          t00[q] = tap16(images, i00[q]);
          t01[q] = tap16(images, i00[q] + 1);
          t10[q] = tap16(images, i00[q] + Wa);
          t11[q] = tap16(images, i00[q] + Wa + 1);
        }
      }
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        const int j = j0 + q * rps + sub;
        if (i < W && j < W)
          win[i * W + j] = ok[q] ? t00[q] * (1.f - fx[q]) * (1.f - fy[q]) +
                                       t01[q] * fx[q] * (1.f - fy[q]) +
                                       t10[q] * (1.f - fx[q]) * fy[q] +
                                       t11[q] * fx[q] * fy[q]
                                 : kInvalid;
      }
    }
  }
  __syncwarp();
  for (int k = lane; k < W2; k += 32) row[k] = win[k];
}

}  // namespace

// C entries, bound with ctypes. Each returns cudaGetLastError() after its
// launch.
extern "C" int pais_sampler(const void* images, const int* dims,
                            const int* yoff, int C, int L, int Ha, int Wa,
                            const float* H, const float* pt, const int* lod,
                            const uint8_t* cam_mask, int B, int radius,
                            float* out, void* stream) {
  const long BC = (long)B * C;
  if (BC == 0) return 0;
  const int W = 2 * radius + 1;
  const int lpr_shift = W <= 8 ? 3 : (W <= 16 ? 4 : 5);
  // one window per warp; fewer warps a block where 8 windows would not
  // fit the shared memory one block can take
  const int wins = (int)min((long)kWarps, kMaxSmem / ((long)W * W * 4));
  if (wins == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)wins * W * W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sampler_kernel<<<(unsigned)((BC + wins - 1) / wins), wins * 32, smem,
                   (cudaStream_t)stream>>>(
      (const uint16_t*)images, dims, yoff, C, L, Ha, Wa, H, pt, lod,
      cam_mask, BC, radius, lpr_shift, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pais_sampler_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
